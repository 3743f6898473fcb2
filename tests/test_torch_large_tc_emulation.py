"""The large route's tensor-core kernels (``csrc/large_p.cu``'s ``large_tc_*``
entries: 3xTF32 ``wgmma`` grams and applies fed by TMA) on the CPU.

``large_p.cu`` runs here through the g++ emulator (``tests/_cuda_emu.py``,
``tests/cuda_emu/large_p_harness.cpp``), with ``tests/cuda_emu/hopper.cuh``
standing in for the TMA loads, the mbarriers and the ``wgmma`` products
(an fp32 operand read with its low 13 bits dropped, as the card reads it,
so a kernel that loses its lo pieces loses fp32 accuracy here too), driven
through the wrappers' own phases (``kernels/large_p.py``) with a
``large_p.Runner`` on CPU tensors. Each entry is held against its plain
version (``kernels/ref.py``) at the tolerance it has on the card (fused
3e-5 / 1e-4, two-stage 2e-5 / 1e-4, Newton-Schulz 1e-6), and against the
JAX package (its Pallas tiled kernels in interpret mode, as
``tests/test_torch_large_p.py`` runs them). p = 136 and 200 leave a ragged
last block (the stored grams are padded to 128 rows); 64 emulated SMs and
``min_slice`` 64 split n into slices summed by the reduce launch; n = 201
(n % 4 != 0, a row stride TMA cannot take) plans the CUDA-core large
route, which these entries refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import large_p_library

from repro.kernels import ops as jops
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import landing_field as tlf
from repro_torch.kernels import large_p as tlp
from repro_torch.kernels import newton_schulz as tns
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pogo_update as tpu
from repro_torch.kernels import ref as tref

FUSED_TOL = dict(atol=3e-5, rtol=1e-4)  # tests/test_fused_step.py:95
TWO_STAGE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_kernels.py:65-75
NS_TOL = dict(atol=1e-6, rtol=0.0)  # tests/test_kernels.py:54-61
BASES = [("none", ()), ("trace", (0.9, False)), ("trace", (0.5, True)),
         ("vadam", (0.9, 0.999, 1e-8))]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return large_p_library(tmp_path_factory)


def _operands(shape, seed, off_manifold=0.0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + off_manifold * rng.standard_normal(shape)
    arrs = (x, 0.2 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape),
            np.abs(rng.standard_normal(b)))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrs]


def _fused_kw(method, base_kind, hyper, mu, nu, pv=None):
    return dict(method=method, lam=1.0 if method == "landing" else 0.5, base_kind=base_kind,
                hyper=hyper, mu=mu if base_kind != "none" else None,
                nu=nu if base_kind == "vadam" else None,
                count=torch.tensor(3, dtype=torch.int32), pv=pv)


def _assert_fused(got, want):
    for name, a, w in zip(("x", "mu", "nu", "dist"), got[:4], want[:4]):
        if w is None:
            assert a is None, name
        else:
            np.testing.assert_allclose(a.numpy(), w.numpy(), err_msg=name, **FUSED_TOL)


@pytest.mark.parametrize("base_kind,hyper", BASES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_fused_step_tc_emulated(lib, method, base_kind, hyper):
    """``fused_step_large_tc`` (and its Landing branch) under every base at
    (1, 136, 136): every gram of X or M in n-slices (64 SMs, slices of 64
    columns), then their sums."""
    run = tlp.Runner(lib, None, 64, min_slice=64)
    x, g, mu, nu = _operands((1, 136, 136), 0, 0.01 if method == "landing" else 0.0)
    kw = _fused_kw(method, base_kind, hyper, mu, nu)
    got = tfs.fused_step_large_tc(x, g, 0.1, runner=run, **kw)
    # [the base stage,] phase 1's two grams, the apply, a self gram [, the
    # apply, E^2, the distance]: each gram with its sum
    assert run.launches == (base_kind != "none") + (11 if method == "pogo" else 7)
    _assert_fused(got, tref.fused_group_step_ref(x, g, 0.1, **kw))


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_fused_step_tc_emulated_in_place_ragged(lib, method):
    """X', mu' and nu' over X, mu and nu, zero-padded rows masked per
    matrix (pv), one matrix with none; one slice a gram."""
    shape = (3, 200, 256)
    x, g, mu, nu = _operands(shape, 1)
    pv = [200, 70, 0]
    rows = np.arange(200)[None, :, None] < np.asarray(pv)[:, None, None]
    x, g, mu = (torch.where(torch.from_numpy(rows), a, 0.0) for a in (x, g, mu))
    kw = _fused_kw(method, "vadam", (0.9, 0.999, 1e-8), mu, nu,
                   torch.tensor(pv, dtype=torch.int32))
    want = tref.fused_group_step_ref(x.clone(), g, 0.1, **{**kw, "mu": mu.clone(),
                                                           "nu": nu.clone()})
    run = tlp.Runner(lib, None, 132)
    got = tfs.fused_step_large_tc(x, g, 0.1, inplace=True, runner=run, **kw)
    assert run.launches == 1 + (7 if method == "pogo" else 4)
    assert got[0] is x and got[1] is mu and got[2] is nu
    _assert_fused(got, want)


@pytest.mark.parametrize("shape,sms,inplace", [((2, 200, 256), 64, True),
                                               ((1, 136, 296), 132, False)])
def test_two_stage_tc_emulated(lib, shape, sms, inplace):
    """``pogo_update_large_tc`` (X' over X when ``inplace``: M waits in a
    scratch) and ``landing_field_large_tc``."""
    run = tlp.Runner(lib, None, sms, min_slice=64 if sms == 64 else tlp.MIN_SLICE)
    x, g, _, _ = _operands(shape, 2, 0.01)
    want_u = tref.pogo_update_ref(x, g, 0.1, 0.5)
    want_f = tref.landing_field_ref(x, g, 1.0)
    without = tref.landing_field_ref(x, g, 0.0)  # lam's term must be visible
    assert not np.allclose(without.numpy(), want_f.numpy(), **TWO_STAGE_TOL)
    got_f = tlf.landing_field_large_tc(x, g, 1.0, runner=run)
    got_u = tpu.pogo_update_large_tc(x, g, 0.1, 0.5, inplace=inplace, runner=run)
    assert (got_u is x) == inplace
    for got, want in ((got_u, want_u), (got_f, want_f)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TWO_STAGE_TOL)


@pytest.mark.parametrize("shape,iters,sms,masked", [((3, 136, 200), 2, 64, True),
                                                    ((2, 200, 256), 3, 132, False)])
def test_newton_schulz_tc_emulated(lib, shape, iters, sms, masked):
    """``newton_schulz_large_tc`` in place over the watchdog's drift: every
    other matrix masked off (bit-unchanged, distance too), or an odd count
    of iterations (the first writes x itself, from a copy)."""
    b = shape[0]
    rng = np.random.default_rng(3)
    x = _operands(shape, 3)[0]
    x = 1.5 * x + torch.from_numpy(0.05 * rng.standard_normal(shape).astype(np.float32))
    mask = torch.arange(b) % 2 == 0 if masked else None
    dist = torch.from_numpy(rng.uniform(1.0, 2.0, b).astype(np.float32))
    x0, d0 = x.clone(), dist.clone()
    run = tlp.Runner(lib, None, sms, min_slice=64 if sms == 64 else tlp.MIN_SLICE)
    tns.newton_schulz_large_tc(x, iters, out=x, mask=mask, dist=dist, runner=run)
    slices = sms == 64  # n = 200 in slices of 64 columns there
    assert run.launches == iters * (3 if slices else 2) + (2 if slices else 1)
    on = mask if masked else torch.ones(b, dtype=torch.bool)
    want = tref.newton_schulz_ref(x0, iters)
    np.testing.assert_allclose(x[on].numpy(), want[on].numpy(), **NS_TOL)
    np.testing.assert_allclose(dist[on].numpy(), tref.manifold_distance_ref(want[on]).numpy(),
                               atol=1e-5, rtol=1e-3)
    assert torch.equal(x[~on], x0[~on]) and torch.equal(dist[~on], d0[~on])


def test_gram_tc_stores_e_and_its_lo_pieces(lib):
    """Phase 1's E_A = X X^T - I (a self gram) and B = X G^T (a cross gram),
    and E with its distance summed in the kernel (||E + I_p - I_pv||_F), against
    float64: fp32 accuracy, zero past p, each lo piece the
    remainder of its value past the tensor cores' 19 bits (to its own
    TF32 rounding, 2^-20 of the value); the sliced
    gram equals the unsliced one to fp32 rounding."""
    b, p, n = 1, 136, 200
    x, g, _, _ = _operands((b, p, n), 4)
    xd, gd = x.double(), g.double()
    a_want = xd @ xd.transpose(1, 2) - torch.eye(p, dtype=torch.float64)
    b_want = xd @ gd.transpose(1, 2)
    for sms in (132, 64):
        run = tlp.Runner(lib, None, sms, min_slice=64)
        ea, ea_lo, _ = tlp.gram_tc(run, x)
        bb, bb_lo, _ = tlp.gram_tc(run, x, g=g)
        e, e_lo, dist = tlp.gram_tc(run, x, dist=True, pv=torch.tensor([100], dtype=torch.int32))
        pv_eye = torch.diag((torch.arange(p) >= 100).double())  # I_p - I_pv
        np.testing.assert_allclose(dist.numpy(), (a_want + pv_eye).square().sum((1, 2)).sqrt(),
                                   rtol=1e-6)
        assert ea.shape == (b, 256, 256)
        for got, lo, want in ((ea, ea_lo, a_want), (bb, bb_lo, b_want), (e, e_lo, a_want)):
            assert float((got[:, :p, :p].double() - want).abs().max()) < 1e-6
            assert float(got[:, p:].abs().max()) == 0 and float(got[:, :, p:].abs().max()) == 0
            hi = (got.view(torch.int32) & ~0x1FFF).view(torch.float32)
            rest = (hi.double() + lo.double() - got.double()).abs()
            assert bool(torch.all(rest <= 2.0**-20 * got.double().abs()))
        # mirrored off the diagonal blocks, which compute both triangles
        np.testing.assert_allclose(e.numpy(), e.transpose(1, 2).numpy(), atol=1e-7, rtol=0)


def test_n_not_a_multiple_of_4_plans_the_cuda_cores(lib):
    """n % 4 != 0: every planner gives the CUDA-core large route, whose
    kernels take it, and the tensor-core entries refuse it."""
    shape = (1, 136, 201)
    for plan in (tops.plan, tops.plan_pogo_update, tops.plan_landing_field,
                 tops.plan_newton_schulz):
        assert plan(256, 2305) == ("large", 0)
        assert plan(256, 2304) == ("large_tc", 0)
    assert tops.plan(*shape[1:]) == ("large", 0)
    x, g, mu, _ = _operands(shape, 5)
    kw = _fused_kw("pogo", "trace", (0.9, False), mu, None)
    _assert_fused(tfs.fused_step_large(x, g, 0.1, runner=tlp.Runner(lib, None, 132), **kw),
                  tref.fused_group_step_ref(x, g, 0.1, **kw))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tfs.fused_step_large_tc(x, g, 0.1, runner=tlp.Runner(lib, None, 132), **kw)


@pytest.mark.parametrize("method,base_kind,hyper", [("pogo", "vadam", (0.92, 0.997, 1e-8)),
                                                    ("landing", "trace", (0.37, False))])
def test_fused_step_tc_matches_pallas_tiled(lib, method, base_kind, hyper, monkeypatch):
    """``fused_step_large_tc`` against JAX's Pallas tiled kernel in
    interpret mode (the VMEM budget shrunk as tests/test_torch_large_p.py
    does, so that it plans its 128-column tile)."""
    monkeypatch.setattr(jops, "VMEM_BUDGET_BYTES", 64 * 1024)
    x, g, mu, nu = _operands((1, 136, 200), 6, 0.01 if method == "landing" else 0.0)
    kw = _fused_kw(method, base_kind, hyper, mu, nu)
    common = dict(method=method, lam=kw["lam"], base_kind=base_kind, hyper=hyper,
                  post_scale=0.85)
    want = jops.fused_group_step(
        jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), 0.1, use_pallas=True, interpret=True,
        mu=jnp.asarray(mu.numpy()), nu=jnp.asarray(nu.numpy()) if base_kind == "vadam" else None,
        count=jnp.asarray(3, jnp.int32), **common)
    got = tfs.fused_step_large_tc(x, g, 0.1, runner=tlp.Runner(lib, None, 64, min_slice=64),
                                  **{**kw, "post_scale": 0.85})
    for name, a, w in zip(("x", "mu", "nu", "dist"), got[:4], want[:4]):
        if w is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **FUSED_TOL)


def test_two_stage_and_newton_schulz_tc_match_jax(lib):
    """``pogo_update_large_tc``, ``landing_field_large_tc`` and
    ``newton_schulz_large_tc`` (3 iterations) against the JAX package."""
    shape = (1, 136, 200)
    x, g, _, _ = _operands(shape, 7, 0.01)
    jx, jg = jnp.asarray(x.numpy()), jnp.asarray(g.numpy())
    run = tlp.Runner(lib, None, 132)
    np.testing.assert_allclose(tpu.pogo_update_large_tc(x, g, 0.1, 0.5, runner=run).numpy(),
                               np.asarray(jops.pogo_update(jx, jg, 0.1, 0.5)), **TWO_STAGE_TOL)
    np.testing.assert_allclose(tlf.landing_field_large_tc(x, g, 1.0, runner=run).numpy(),
                               np.asarray(jops.landing_field(jx, jg, 1.0)), **TWO_STAGE_TOL)
    drifted = 1.5 * x + torch.from_numpy(
        0.05 * np.random.default_rng(8).standard_normal(shape).astype(np.float32))
    np.testing.assert_allclose(
        tns.newton_schulz_large_tc(drifted, 3, runner=run).numpy(),
        np.asarray(jops.newton_schulz(jnp.asarray(drifted.numpy()), 3, interpret=True)),
        **NS_TOL)
