"""The cluster kernel of ``csrc/small_p.cu`` (the fused step, POGO and
Landing, and the two-stage POGO update and landing field for small p, one
matrix a thread block cluster), run on the CPU through
``tests/cuda_emu/small_p_harness.cpp``, against its plain versions
``ref.fused_group_step_ref``, ``ref.pogo_update_ref`` and
``ref.landing_field_ref`` and against the JAX package's
``ops.fused_group_step`` (its Pallas kernels in interpret mode, as
``tests/test_torch_fused_step.py`` runs them), ``ops.pogo_update`` and
``ops.landing_field``.

The harness calls the C launchers, so the tensor maps, the persistent
cluster grid (two emulated clusters walk the matrices, so a cluster's
mbarriers and published grams are reused) and the distributed shared
memory are checked too; ``tests/cuda_emu/cuda_runtime.h`` runs a cluster's
CTAs at once, each with its own shared memory. Tolerance: the fused tiled
kernels' atol 3e-5 / rtol 1e-4 for every output of the fused step, the
distance included (``tests/test_fused_step.py``), and the two-stage tiled
kernels' 2e-5 / 1e-4 for the update and the field (``tests/test_kernels.py``):
fp32 sums in another order.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import compile_harness

from repro.kernels import ops as jops
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=3e-5, rtol=1e-4)
UPDATE_TOL = dict(atol=2e-5, rtol=1e-4)
KINDS = {"none": 0, "trace": 1, "vadam": 2}
METHODS = {"pogo": 0, "landing": 1}  # the harness's METHOD; 2 the update, 3 the field
LAM = {"pogo": 0.5, "landing": 1.0}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return compile_harness(tmp_path_factory, "small_p_harness.cpp")


def _inputs(shape, seed, pv=None):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    nu = np.abs(rng.standard_normal(b))
    if pv is not None:
        rows = np.arange(p)[None, :, None] < np.asarray(pv)[:, None, None]
        x, g, mu = (np.where(rows, a, 0.0) for a in (x, g, mu))
    return (np.ascontiguousarray(a, np.float32) for a in (x, g, mu, nu))


def _call(harness, tmp_path, method, shape, base, nesterov, inplace, pv, c):
    b, p, n = shape
    res = subprocess.run(
        [str(harness), str(tmp_path), str(method), str(b), str(p), str(n), str(KINDS[base]),
         str(int(nesterov)), str(int(inplace)), str(int(pv is not None)), str(c)],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _got(tmp_path, name, shape):
    return np.fromfile(tmp_path / f"{name}.bin", np.float32).reshape(shape)


# c: the cluster size, 0 the launcher's own.
@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("shape,base,hyper,inplace,pv,c", [
    ((3, 10, 256), "trace", (0.9, False), False, None, 2),  # the paper's p
    ((2, 24, 512), "trace", (0.9, True), False, None, 4),  # one column a thread
    # ragged rows; five matrices on two clusters, so each cluster's slices,
    # mbarriers and published grams take a second and third matrix
    ((5, 7, 200), "vadam", (0.9, 0.999, 1e-8), True, [7, 5, 1, 0, 7], 0),
    ((3, 1, 64), "none", (), False, None, 0),  # p = 1: one gram block, 256 lanes
    # four 256-column boxes a CTA, the leap and land in two rounds, each
    # refilling its finished boxes with the next matrix's g and X
    ((3, 10, 2048), "vadam", (0.9, 0.999, 1e-8), False, None, 2),
    # the same at p = 16: two columns a thread, four rows of gram blocks
    ((3, 16, 2048), "trace", (0.9, False), False, None, 2),
], ids=["trace_c2", "nesterov_c4", "vadam_in_place_ragged", "none_p1", "boxes_rounds_c2",
        "boxes_rounds_p16_c2"])
def test_fused_step_cluster_emulated(harness, tmp_path, shape, base, hyper, inplace, pv, c,
                                     method):
    """X', mu', nu' and the distance of the fused step (POGO, and Landing's
    fixed step with the distance from W = X' X'^T), against the plain
    version and the JAX package; in place writes X' over X, mu' over mu,
    nu' over nu."""
    x, g, mu, nu = _inputs(shape, seed=sum(shape), pv=pv)
    count = torch.tensor(3, dtype=torch.int32)
    lam = LAM[method]
    scal = tfs.pack_scal(0.1, lam, base_kind=base, hyper=hyper, post_scale=1.0, count=count,
                         device="cpu")
    pv_arr = np.asarray(pv if pv is not None else [shape[1]] * shape[0], np.float32)
    for name, a in (("x", x), ("g", g), ("mu", mu), ("nu", nu), ("scal", scal.numpy()),
                    ("pv", pv_arr)):
        a.astype(np.float32).tofile(tmp_path / f"{name}.bin")
    _call(harness, tmp_path, METHODS[method], shape, base, base == "trace" and hyper[1], inplace,
          pv, c)
    t = torch.from_numpy
    want = tref.fused_group_step_ref(
        t(x), t(g), 0.1, method=method, lam=lam, base_kind=base, hyper=hyper,
        mu=t(mu) if base != "none" else None, nu=t(nu) if base == "vadam" else None,
        count=count, pv=None if pv is None else torch.tensor(pv, dtype=torch.int32))
    jwant = jops.fused_group_step(
        jnp.asarray(x), jnp.asarray(g), 0.1, method=method, lam=lam, base_kind=base,
        hyper=hyper, mu=jnp.asarray(mu) if base != "none" else None,
        nu=jnp.asarray(nu) if base == "vadam" else None, count=jnp.asarray(3, jnp.int32),
        pv=None if pv is None else jnp.asarray(pv, jnp.int32), use_pallas=True, interpret=True)
    for name, w, jw in zip(("x_out", "mu_out", "nu_out", "dist"), want[:4], jwant[:4]):
        assert (w is None) == (jw is None), name
        if w is not None:
            got = _got(tmp_path, name, tuple(w.shape))
            np.testing.assert_allclose(got, w.numpy(), err_msg=name, **TOL)
            np.testing.assert_allclose(got, np.asarray(jw), err_msg=f"{name} (JAX)", **TOL)


def test_pogo_update_cluster_emulated_in_place(harness, tmp_path):
    """The two-stage update written over X, five matrices on two clusters,
    against the plain version and the JAX package."""
    shape = (5, 8, 200)
    x, g, _, _ = _inputs(shape, seed=5)
    scal = np.array([0.1, 0.5, 1.0, 0, 0, 0, 0, 0], np.float32)
    for name, a in (("x", x), ("g", g), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    _call(harness, tmp_path, 2, shape, "none", False, True, None, 0)
    t = torch.from_numpy
    want = tref.pogo_update_ref(t(x), t(g), 0.1, 0.5)
    got = _got(tmp_path, "x_out", shape)
    np.testing.assert_allclose(got, want.numpy(), **UPDATE_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.pogo_update(jnp.asarray(x), jnp.asarray(g),
                                                                0.1, 0.5)), **UPDATE_TOL)


@pytest.mark.parametrize("shape,inplace,c", [
    # written over X, five matrices on two clusters, so that each cluster
    # publishes into both sets of grams (the field alternates them by the
    # matrix's parity) and reuses each
    ((5, 8, 200), True, 0),
    # ragged: p = 7 and a last CTA whose one box is cut short at n
    ((5, 7, 1000), False, 8),
    # four 256-column boxes a CTA in two rounds, each refilling its
    # finished boxes with the next matrix's X and g
    ((3, 10, 2048), False, 2),
], ids=["in_place", "ragged_c8", "boxes_rounds_c2"])
def test_landing_field_cluster_emulated(harness, tmp_path, shape, inplace, c):
    """Landing's field, against the plain version and the JAX package."""
    x, g, _, _ = _inputs(shape, seed=sum(shape) + 1)
    scal = np.array([0.0, 1.0, 1.0, 0, 0, 0, 0, 0], np.float32)
    for name, a in (("x", x), ("g", g), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    _call(harness, tmp_path, 3, shape, "none", False, inplace, None, c)
    t = torch.from_numpy
    want = tref.landing_field_ref(t(x), t(g), 1.0)
    got = _got(tmp_path, "x_out", shape)
    np.testing.assert_allclose(got, want.numpy(), **UPDATE_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.landing_field(jnp.asarray(x), jnp.asarray(g),
                                                                  1.0)), **UPDATE_TOL)


def _ctas_per_sm(p, n, c):
    return tops.SM_SMEM_BYTES // (tops.small_p_smem_bytes(p, n, c) + 1024)


@pytest.mark.parametrize("p,n,c,ctas", [(10, 256, 2, 2), (10, 10000, 8, 2), (24, 512, 2, 2),
                                        (28, 4096, 8, 1), (16, 10000, 8, 1), (4, 2048, 2, 2),
                                        (10, 4096, 4, 2)])
def test_cluster_size_and_smem_mirror_the_source(p, n, c, ctas):
    """``ops.small_p_cluster``, as ``small_p_cluster`` in the source: the
    least cluster whose CTA leaves its SM room for a second (the paper's
    (10, 10000) takes 8, not the 4 whose slices already fit), else the
    least whose slices fit a CTA."""
    assert tops.small_p_cluster(p, n) == c
    assert tops.small_p_smem_bytes(p, n, c) <= tops.SMEM_LIMIT_BYTES
    assert min(_ctas_per_sm(p, n, c), 2) == ctas
    for smaller in (2, 4, 8)[:(2, 4, 8).index(c)]:
        fits = tops.small_p_smem_bytes(p, n, smaller) <= tops.SMEM_LIMIT_BYTES
        assert not fits or _ctas_per_sm(p, n, smaller) < ctas


@pytest.mark.parametrize("p,n", [(28, 10000), (10, 9998), (33, 2048), (8, 200000)])
def test_no_cluster_past_its_reach(p, n):
    """No cluster where a cluster of 8 cannot hold the matrix, n % 4 != 0
    (a row stride TMA cannot take) or p > 32."""
    assert tops.small_p_cluster(p, n) == 0
