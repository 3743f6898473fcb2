"""The tensor-core TP kernels (``csrc/tp_step_tc.cu``: ``tp_gram_tc`` and
``tp_apply_tc``, rows 3tc and 4tc), run on the CPU, against the port's
plain versions and the JAX package.

``tests/cuda_emu/tp_tc_harness.cpp`` compiles the source with the host C++
compiler against ``tests/cuda_emu/cuda_runtime.h`` and ``hopper.cuh``
(scalar stand-ins of TMA, mbarriers and ``wgmma``; a TF32 product drops
each operand's low 13 bits, so a kernel that lost its lo pieces fails
here) and runs the C launchers: two persistent blocks walk the matrices,
the algebra runs one block a matrix. Each case runs ``tp_gram_tc`` on a
shard's columns, then ``tp_apply_tc`` on that payload (a one-shard
all-reduce), and holds both against ``ref.tp_partial_ref`` /
``ref.tp_apply_ref`` and against JAX's ``fused_group_step_tp_partial`` /
``_finish`` with its Pallas kernels (``tp_gram_whole``,
``tp_apply_whole``) in interpret mode, at the fused tiled tolerance, atol
3e-5 / rtol 1e-4. The route that sends a shard to these kernels
(``ops.plan_tp_route``) is checked here too.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import compile_harness

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tp_step as ttp

TOL = dict(atol=3e-5, rtol=1e-4)
KINDS = {"none": 0, "trace": 1, "vadam": 2}
VADAM = (0.9, 0.999, 1e-8)
LAM = {"pogo": 0.5, "landing": 1.0}
ETA = 0.1


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return compile_harness(tmp_path_factory, "tp_tc_harness.cpp")


def _call(harness, tmp_path, mode, shape, k, base_kind, hyper, method, has_scl, has_pv,
          inplace):
    b, p, n = shape
    nesterov = int(base_kind == "trace" and hyper[1])
    subprocess.run(
        [str(harness), str(tmp_path), str(mode), str(b), str(p), str(n), str(k),
         str(KINDS[base_kind]), str(nesterov), str(int(method == "landing")),
         str(int(has_scl)), str(int(has_pv)), str(int(inplace))],
        check=True, timeout=120,
    )


def _operands(shape, pv, seed):
    """Rows near orthonormal (QR plus 1e-2 noise), a gradient and a first
    moment; rows past ``pv`` zero, as the group stacks pad them."""
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


def _check(got, want, jax_want, name):
    np.testing.assert_allclose(got, want, err_msg=f"{name} vs the plain version", **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_want), err_msg=f"{name} vs JAX", **TOL)


def _run(harness, tmp_path, shape, base_kind, hyper, method, post_scale=1.0, pv=None,
         inplace=False, seed=0):
    b, p, n = shape
    x, g, mu, nu = _operands(shape, pv, seed)
    t = torch.from_numpy
    moments = base_kind != "none"
    scal = ttp.tp_scal(base_kind, hyper, post_scale, eta=ETA, lam=LAM[method]).numpy()
    for name, a in (("x", x), ("g", g), ("mu", mu), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    k = tref.tp_payload_width(p, base_kind)

    # tp_gram_tc on the shard's columns
    _call(harness, tmp_path, 0, shape, k, base_kind, hyper, method, False, False, inplace)
    want = tref.tp_partial_ref(t(x), t(g), base_kind=base_kind, hyper=hyper,
                               post_scale=post_scale, mu=t(mu) if moments else None)
    jax_want = jops.fused_group_step_tp_partial(
        jnp.asarray(x), jnp.asarray(g), base_kind=base_kind, hyper=hyper,
        post_scale=post_scale, mu=jnp.asarray(mu) if moments else None,
        use_pallas=True, interpret=True)
    for name, w, jw in zip(("payload", "gb", "mu_out"), want, jax_want):
        if w is None:
            continue
        got = np.fromfile(tmp_path / f"{name}.bin", np.float32).reshape(w.shape)
        _check(got, w.numpy(), jw, name)

    # tp_apply_tc on that payload, vadam's scalar from the payload's sum of squares
    pay, gb = want[0], want[1]
    count = 3
    scl = None
    if base_kind == "vadam":
        scl, _ = tref.tp_scale_ref(pay, p, hyper=hyper, post_scale=post_scale, nu=t(nu),
                                   count=torch.tensor(count))
        scl.numpy().tofile(tmp_path / "scl.bin")
    np.asarray(pv if pv is not None else [p] * b, np.float32).tofile(tmp_path / "pv.bin")
    gb.numpy().tofile(tmp_path / "gb.bin")
    pay.numpy().tofile(tmp_path / "payload.bin")
    _call(harness, tmp_path, 1, shape, k, base_kind, hyper, method, scl is not None,
          pv is not None, inplace)
    x2, dist = tref.tp_apply_ref(t(x), gb, pay, ETA, scl, method=method, lam=LAM[method],
                                 pv=None if pv is None else torch.tensor(pv))
    jx2, _, jdist, _ = jops.fused_group_step_tp_finish(
        jnp.asarray(x), jnp.asarray(gb.numpy()), jnp.asarray(pay.numpy()), ETA,
        method=method, lam=LAM[method], base_kind=base_kind, hyper=hyper,
        post_scale=post_scale, nu=jnp.asarray(nu) if base_kind == "vadam" else None,
        count=jnp.asarray(count, jnp.int32) if base_kind == "vadam" else None,
        pv=None if pv is None else jnp.asarray(pv, jnp.int32),
        use_pallas=True, interpret=True)
    got = np.fromfile(tmp_path / "x_out.bin", np.float32).reshape(shape)
    _check(got, x2.numpy(), jx2, "x_out")
    _check(np.fromfile(tmp_path / "dist.bin", np.float32), dist.numpy(), jdist, "dist")


@pytest.mark.parametrize("shape,base_kind,hyper,method,post_scale", [
    ((3, 64, 200), "trace", (0.9, False), "pogo", 1.0),    # SmolLM's p, ragged last chunk
    ((3, 64, 200), "vadam", VADAM, "landing", 0.7),
    ((2, 40, 132), "trace", (0.5, True), "landing", 1.5),  # nesterov, rows past p
    ((2, 33, 100), "none", (), "pogo", 1.3),               # a 36-column n-edge tile
])
def test_tp_tc_kernels_emulated(harness, tmp_path, shape, base_kind, hyper, method,
                                post_scale):
    _run(harness, tmp_path, shape, base_kind, hyper, method, post_scale=post_scale)


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tp_tc_kernels_emulated_in_place_masked(harness, tmp_path, method):
    """mu' over mu (``tp_gram_tc``), X' over X (``tp_apply_tc``), and two
    zero-padded rows masked out of the distance (``pv``)."""
    _run(harness, tmp_path, (2, 40, 132), "vadam", VADAM, method, pv=[40, 38],
         inplace=True, seed=1)


@pytest.mark.parametrize("p", [1, 15, 16, 24, 28, 29, 32, 48, 63, 64, 65, 96])
@pytest.mark.parametrize("n", [128, 240, 480, 484, 481, 962])
def test_tp_route(p, n):
    """The tensor cores for ``TP_TC_MIN_P <= p <= 64`` at n % 4 == 0, else
    rows 3 and 4 with ``plan_tp``'s tile."""
    for what, tiled_bytes in (("tp_gram", tops.tp_gram_smem_bytes),
                              ("tp_apply", tops.tp_apply_smem_bytes)):
        route = tops.plan_tp_route(what, p, n)
        if tops.TP_TC_MIN_P <= p <= 64 and n % 4 == 0:
            assert route == ("tc", 0)
        else:
            assert route == ("tiled", tops.plan_tp(what, p, tiled_bytes))


def test_tp_tc_smem_fits_one_block():
    """Each tensor-core TP kernel's block fits the 227 KB of one block; the
    algebra's seven tiles let two blocks share an SM."""
    for fn in (tops.tp_gram_tc_smem_bytes, tops.tp_apply_tc_smem_bytes,
               tops.tp_alg_smem_bytes):
        assert fn() <= tops.SMEM_LIMIT_BYTES
    assert 2 * (tops.tp_alg_smem_bytes() + 1024) <= tops.SM_SMEM_BYTES
