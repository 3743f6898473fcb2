"""The batched whole-matrix kernels (``csrc/batched_whole.cu``: the fused
step, POGO and Landing, and the two-stage POGO update over many matrices),
run on the CPU through ``tests/cuda_emu/batched_whole_harness.cpp``,
against the plain versions ``ref.fused_group_step_ref`` and
``ref.pogo_update_ref`` and the JAX package's ``ops.fused_group_step``
(its Pallas kernels in interpret mode) and ``ops.pogo_update``.

The harness calls the C launchers on one emulated SM, so that a CTA walks
several groups and its ring of stages wraps: the 1-D bulk copies and their
mbarriers (the stand-in copies a load at once and reads a store only when
its thread waits for it, so a stage refilled before its stores read it
fails here), a matrix a thread (256 a group) at every p <= n <= 4, the
tail group and a misaligned view (plain loads). Tolerance: the whole
kernels' (rows 1 and 5): atol 2e-5 / rtol 1e-4 for every output of the
fused step, the distance included, and 1e-6 for the update
(``tests/test_fused_step.py``, ``tests/test_kernels.py``).
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

TOL = dict(atol=2e-5, rtol=1e-4)
UPDATE_TOL = dict(atol=1e-6, rtol=1e-6)
KINDS = {"none": 0, "trace": 1, "vadam": 2}
MODES = {"pogo": 0, "landing": 1, "update": 2}
LAM = {"pogo": 0.5, "landing": 1.0}
VADAM = (0.9, 0.999, 1e-8)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return compile_harness(tmp_path_factory, "batched_whole_harness.cpp")


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
    return tuple(np.ascontiguousarray(a, np.float32) for a in (x, g, mu, nu))


def _call(harness, tmp_path, mode, shape, base="none", nesterov=False, pv=None, inplace=False,
          offset=0):
    b, p, n = shape
    res = subprocess.run(
        [str(harness), str(tmp_path), str(MODES[mode]), str(b), str(p), str(n),
         str(KINDS[base]), str(int(nesterov)), str(int(pv is not None)), str(int(inplace)),
         str(offset)],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _got(tmp_path, name, shape):
    return np.fromfile(tmp_path / f"{name}.bin", np.float32).reshape(shape)


def _ragged(b, p, seed):
    return [int(v) for v in np.random.default_rng(seed).integers(0, p + 1, b)]


# offset 1: every operand a view one float past a 16-byte boundary (plain loads)
@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("shape,base,hyper,inplace,ragged,offset", [
    ((64, 3, 3), "trace", (0.9, False), False, False, 0),  # one group, short: plain
    ((37, 3, 3), "vadam", VADAM, True, False, 0),
    # nine groups of 256 on two CTAs (the last 37 matrices plain): five
    # steps a CTA, so the three stages wrap
    ((2085, 3, 3), "trace", (0.5, True), False, False, 0),
    ((600, 3, 3), "none", (), False, True, 0),
    ((300, 3, 3), "vadam", VADAM, False, False, 1),
    ((515, 1, 1), "trace", (0.9, False), False, False, 0),  # a tail group of three
    ((600, 2, 3), "vadam", VADAM, False, False, 0),
    ((1031, 4, 4), "trace", (0.5, True), True, False, 0),  # the ring wraps at 4 x 4
    ((513, 2, 4), "none", (), False, True, 1),
    ((777, 1, 3), "vadam", VADAM, True, False, 0),
], ids=["3x3_one_group", "3x3_vadam_in_place", "3x3_ring_wraps", "3x3_ragged",
        "3x3_misaligned", "1x1_tail", "2x3_vadam", "4x4_ring_in_place", "2x4_ragged_misaligned",
        "1x3_vadam_in_place"])
def test_fused_step_batched_emulated(harness, tmp_path, shape, base, hyper, inplace, ragged,
                                     offset, method):
    """X', mu', nu' and the distance of the fused step (POGO, and Landing's
    fixed step with the distance from W = X' X'^T), against the plain
    version and the JAX package; in place writes X' over X, mu' over mu,
    nu' over nu."""
    b, p, n = shape
    pv = _ragged(b, p, sum(shape)) if ragged else None
    x, g, mu, nu = _inputs(shape, seed=sum(shape), pv=pv)
    count = torch.tensor(3, dtype=torch.int32)
    lam = LAM[method]
    scal = tfs.pack_scal(0.1, lam, base_kind=base, hyper=hyper, post_scale=0.8, count=count,
                         device="cpu")
    pv_arr = np.asarray(pv if pv is not None else [p] * b, np.float32)
    for name, a in (("x", x), ("g", g), ("mu", mu), ("nu", nu), ("scal", scal.numpy()),
                    ("pv", pv_arr)):
        a.astype(np.float32).tofile(tmp_path / f"{name}.bin")
    _call(harness, tmp_path, method, shape, base, base == "trace" and hyper[1], pv, inplace,
          offset)
    t = torch.from_numpy
    kw = dict(method=method, lam=lam, base_kind=base, hyper=hyper, post_scale=0.8)
    want = tref.fused_group_step_ref(
        t(x), t(g), 0.1, mu=t(mu) if base != "none" else None,
        nu=t(nu) if base == "vadam" else None, count=count,
        pv=None if pv is None else torch.tensor(pv, dtype=torch.int32), **kw)
    jwant = jops.fused_group_step(
        jnp.asarray(x), jnp.asarray(g), 0.1, mu=jnp.asarray(mu) if base != "none" else None,
        nu=jnp.asarray(nu) if base == "vadam" else None, count=jnp.asarray(3, jnp.int32),
        pv=None if pv is None else jnp.asarray(pv, jnp.int32), use_pallas=True, interpret=True,
        **kw)
    for name, w, jw in zip(("x_out", "mu_out", "nu_out", "dist"), want[:4], jwant[:4]):
        assert (w is None) == (jw is None), name
        if w is not None:
            got = _got(tmp_path, name, tuple(w.shape))
            np.testing.assert_allclose(got, w.numpy(), err_msg=name, **TOL)
            np.testing.assert_allclose(got, np.asarray(jw), err_msg=f"{name} (JAX)", **TOL)


@pytest.mark.parametrize("shape,inplace,offset", [
    ((2085, 3, 3), True, 0),  # the three stages wrap; the last 37 matrices plain
    ((1031, 4, 4), False, 0),
    ((515, 2, 3), False, 1),  # a misaligned view: plain loads
], ids=["3x3_ring_in_place", "4x4_ring", "2x3_misaligned"])
def test_pogo_update_batched_emulated(harness, tmp_path, shape, inplace, offset):
    """The two-stage update, against the plain version and the JAX package."""
    x, g, _, _ = _inputs(shape, seed=sum(shape) + 1)
    scal = np.array([0.1, 0.5, 1.0, 0, 0, 0, 0, 0], np.float32)
    for name, a in (("x", x), ("g", g), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    _call(harness, tmp_path, "update", shape, inplace=inplace, offset=offset)
    t = torch.from_numpy
    got = _got(tmp_path, "x_out", shape)
    np.testing.assert_allclose(got, tref.pogo_update_ref(t(x), t(g), 0.1, 0.5).numpy(),
                               **UPDATE_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.pogo_update(jnp.asarray(x), jnp.asarray(g),
                                                                0.1, 0.5)), **UPDATE_TOL)


@pytest.mark.parametrize("mode,shape", [
    ("pogo", (8, 5, 5)), ("landing", (8, 1, 5)), ("update", (8, 3, 2)), ("pogo", (8, 16, 256)),
])
def test_batched_launchers_refuse_shapes_outside_their_range(harness, tmp_path, mode, shape):
    """Past p <= n <= 4 the launchers return an error and launch nothing."""
    np.zeros(8, np.float32).tofile(tmp_path / "scal.bin")
    b, p, n = shape
    res = subprocess.run([str(harness), str(tmp_path), str(MODES[mode]), str(b), str(p),
                          str(n), "1", "0", "0", "0", "0"],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 3 and "launcher returned" in res.stderr, res.stderr


@pytest.mark.parametrize("p,n,kind", [
    (1, 1, "batched"), (1, 4, "batched"), (2, 2, "batched"), (2, 4, "batched"),
    (3, 3, "batched"), (3, 4, "batched"), (4, 4, "batched"),
    (4, 5, "whole"), (5, 5, "whole"), (1, 5, "whole"), (4, 8, "whole"), (8, 128, "whole"),
    (16, 256, "whole"), (64, 216, "whole"), (40, 120, "whole"), (8, 200, "whole"),
])
def test_planner_sends_small_matrices_to_the_batched_kernel(p, n, kind):
    """The fused step (both methods) and the POGO update take the batched
    kernel at p <= n <= ``BATCHED_MAX_N``, a thread a matrix; the whole
    kernels keep every larger matrix that fits a block (the many-matrices
    (16, 256) and the CNN filter (64, 216) among them), and the landing
    field keeps its whole kernel."""
    for got in (tops.plan(p, n), tops.plan(p, n, "landing"), tops.plan_pogo_update(p, n)):
        assert got == (kind, 0)
    assert tops.plan_landing_field(p, n) == ("whole", 0)
    assert (p <= n <= tops.BATCHED_MAX_N) == (kind == "batched")


def test_batched_wrappers_run_the_plain_version_on_cpu():
    """On a CPU tensor each wrapper runs its plain version and counts no
    launch."""
    from repro_torch.kernels import pogo_update as tpu

    x, g, mu, _ = (torch.from_numpy(a) for a in _inputs((5, 3, 3), seed=2))
    kw = dict(lam=0.5, base_kind="trace", hyper=(0.9, False), mu=mu)
    for wrapper, method in ((tfs.fused_step_batched, "pogo"),
                            (tfs.fused_step_batched_landing, "landing")):
        before = wrapper.launches
        got = wrapper(x, g, 0.1, **kw)
        want = tref.fused_group_step_ref(x, g, 0.1, method=method, **kw)
        for a, b in zip(got[:4], want[:4]):
            if b is not None:
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        assert wrapper.launches == before
    before = tpu.pogo_update_batched.launches
    torch.testing.assert_close(tpu.pogo_update_batched(x, g, 0.1, 0.5),
                               tref.pogo_update_ref(x, g, 0.1, 0.5), atol=0, rtol=0)
    assert tpu.pogo_update_batched.launches == before
