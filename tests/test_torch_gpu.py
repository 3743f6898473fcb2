"""CUDA kernel tests of the port: each kernel against its plain version on
the card. Marked ``gpu``; without a card they skip (decided in a fixture,
never at import). Run them on the card with
``PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports JAX, which the card's
machine need not have).

Tolerances are those the JAX tests hold the Pallas kernels to: for the
fused kernels (``tests/test_fused_step.py:67,95``) atol 2e-5 / rtol 1e-4
whole, atol 3e-5 / rtol 1e-4 tiled; for the two-stage kernels
(``tests/test_kernels.py:34-75``) atol 1e-6 whole and 2e-5 / rtol 1e-4
tiled, each case saying where it differs; for Newton-Schulz atol 1e-6
(``tests/test_kernels.py:54-61``). The Landing branches of the fused
kernels and the TP kernels take the fused tolerances. The flash-attention
kernels take ``tests/test_flash_kernel.py``'s: fp32 atol 2e-5 / rtol
1e-4; bf16 one output ulp (the tensor-core kernel and its plain version
both keep p to fp32 quality and round once at the end), held at 1/64
relative.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import optim as topt
from repro_torch.core import api as tapi
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import landing_field as tlf
from repro_torch.kernels import newton_schulz as tns
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pogo_update as tpu
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tp_step as ttp

pytestmark = pytest.mark.gpu

BASES = [
    ("none", ()),
    ("trace", (0.9, False)),
    ("trace", (0.5, True)),
    ("vadam", (0.9, 0.999, 1e-8)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    arrs = (np.swapaxes(q, -1, -2), 0.2 * rng.standard_normal(shape),
            0.1 * rng.standard_normal(shape), np.abs(rng.standard_normal(b)))
    return [torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
            for a in arrs]


def _kwargs(base_kind, hyper, mu, nu, device, pv=None):
    return dict(method="pogo", lam=0.5, base_kind=base_kind, hyper=hyper,
                post_scale=1.0, mu=mu if base_kind != "none" else None,
                nu=nu if base_kind == "vadam" else None,
                count=torch.tensor(3, dtype=torch.int32, device=device),
                pv=pv)


def _close(got, want, tol):
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("shape", [(64, 16, 256), (7, 10, 250), (3, 1, 33)])
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_whole_kernel_matches_plain(cuda, shape, base_kind, hyper):
    x, g, mu, nu = _operands(shape, cuda)
    kw = _kwargs(base_kind, hyper, mu, nu, cuda)
    before = tfs.fused_step_whole.launches
    got = tfs.fused_step_whole(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert tfs.fused_step_whole.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw),
           dict(atol=2e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", [(1031, 4, 4), (515, 2, 3), (1000, 3, 3), (37, 3, 3)])
@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_batched_kernel_matches_plain(cuda, shape, method, base_kind, hyper):
    """``csrc/batched_whole.cu``'s fused step (a thread a matrix; tail
    groups, and a short group at 37) against the plain version, the whole
    kernels' tolerance."""
    x, g, mu, nu = _operands(shape, cuda, seed=11)
    kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), method=method)
    wrapper = tfs.fused_step_batched if method == "pogo" else tfs.fused_step_batched_landing
    before = wrapper.launches
    got = tfs.fused_step_batched(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=2e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", [(4, 5, 5), (4, 1, 5), (8, 16, 256)])
def test_batched_kernels_refuse_shapes_outside_their_range(cuda, shape):
    """Past p <= n <= 4 the batched entries raise and count no launch."""
    x, g, mu, nu = _operands(shape, cuda, seed=3)
    kw = _kwargs("trace", (0.9, False), mu, nu, cuda)
    for wrapper, call in ((tfs.fused_step_batched, lambda: tfs.fused_step_batched(x, g, 0.1,
                                                                                  **kw)),
                          (tpu.pogo_update_batched,
                           lambda: tpu.pogo_update_batched(x, g, 0.1, 0.5))):
        before = wrapper.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
        assert wrapper.launches == before


@pytest.mark.parametrize("shape,tile_n", [((16, 64, 960), 32), ((16, 64, 960), 64),
                                          ((5, 10, 250), 32), ((2, 120, 300), 32),
                                          ((4, 128, 2048), 16)])
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_tiled_kernel_matches_plain(cuda, shape, tile_n, base_kind, hyper):
    x, g, mu, nu = _operands(shape, cuda, seed=1)
    kw = _kwargs(base_kind, hyper, mu, nu, cuda)
    before = tfs.fused_step_tiled.launches
    got = tfs.fused_step_tiled(x, g, 0.1, tile_n=tile_n, **kw)
    torch.cuda.synchronize()
    assert tfs.fused_step_tiled.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw),
           dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("wrapper", [tfs.fused_step_whole, tfs.fused_step_tiled,
                                     tfs.fused_step_batched])
def test_kernels_in_place_and_ragged(cuda, wrapper):
    shape = (4, 4, 4) if wrapper is tfs.fused_step_batched else (4, 8, 200)
    p = shape[1]
    x, g, mu, nu = _operands(shape, cuda, seed=2)
    pv = torch.tensor([p, p // 2 + 1, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(p, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = _kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = wrapper(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_planner_matches_the_kernels_smem(cuda):
    lib = tfs._lib()
    for p, n in [(16, 256), (64, 960), (5, 40), (120, 4096)]:
        assert lib.fused_whole_smem_bytes(p, n) == tops.whole_smem_bytes(p, n)
        assert lib.fused_tiled_smem_bytes(p, 32) == tops.tiled_smem_bytes(p, 32)
    assert lib.fused_tiled_smem_bytes(128, 16) == tops.tiled_smem_bytes(128, 16)


def test_kernel_rejects_bad_operands(cuda):
    x, g, mu, nu = _operands((2, 4, 16), cuda)
    kw = _kwargs("trace", (0.9, False), mu, nu, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfs.fused_step_whole(x.double(), g.double(), 0.1, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        tfs.fused_step_whole(xt, g, 0.1, **kw)
    with pytest.raises(ValueError, match="mu"):
        tfs.fused_step_tiled(x, g, 0.1, **dict(kw, mu=None))


@pytest.mark.parametrize("base", ["trace", "vadam"])
def test_constraint_step_on_card_matches_cpu(cuda, base):
    make = {"trace": lambda: topt.chain(topt.trace(0.9)),
            "vadam": lambda: topt.scale_by_vadam()}[base]
    rng = np.random.default_rng(3)
    params = {"q": np.swapaxes(np.linalg.qr(rng.standard_normal((6, 300, 16)))[0],
                               -1, -2).astype(np.float32),
              "k": np.linalg.qr(rng.standard_normal((2, 900, 32)))[0].astype(np.float32)}
    grads = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        opt = tapi.orthogonal("pogo", learning_rate=0.1, use_kernel=True,
                              base_optimizer=make())
        cs = tapi.ConstraintSet.from_tree(params, device=dev)
        gs = tapi.ConstraintSet.from_tree(grads, device=dev)
        st = opt.init(cs)
        step = tapi.constraint_step(opt)
        for _ in range(3):
            cs, st, health = step(cs, st, gs)
        assert bool(health.finite)
        out[dev] = (cs, st)
    for a, b in zip(out["cpu"][0].stacks, out["cuda"][0].stacks):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)
    for a, b in zip(out["cpu"][1].last_distance.per_group,
                    out["cuda"][1].last_distance.per_group):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)


# ------------------------------------------- Landing's fused branches


@pytest.mark.parametrize("shape,wrapper,tile_n,tol", [
    ((64, 16, 256), tfs.fused_step_whole_landing, 0, dict(atol=2e-5, rtol=1e-4)),
    ((7, 10, 250), tfs.fused_step_whole_landing, 0, dict(atol=2e-5, rtol=1e-4)),
    ((16, 64, 960), tfs.fused_step_tiled_landing, 32, dict(atol=3e-5, rtol=1e-4)),
    ((5, 10, 250), tfs.fused_step_tiled_landing, 64, dict(atol=3e-5, rtol=1e-4)),
    ((4, 128, 2048), tfs.fused_step_tiled_landing, 16, dict(atol=3e-5, rtol=1e-4)),
])
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_landing_kernels_match_plain(cuda, shape, wrapper, tile_n, tol, base_kind,
                                     hyper):
    x, g = _off_manifold_operands(shape, cuda, seed=4)
    _, _, mu, nu = _operands(shape, cuda, seed=5)
    kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), lam=1.0)
    kw.pop("method")
    before = wrapper.launches
    got = wrapper(x, g, 0.1, **({"tile_n": tile_n} if tile_n else {}), **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, method="landing", **kw), tol)


@pytest.mark.parametrize("wrapper", [tfs.fused_step_whole_landing,
                                     tfs.fused_step_tiled_landing,
                                     tfs.fused_step_batched_landing])
def test_landing_kernels_in_place_and_ragged(cuda, wrapper):
    shape = (4, 4, 4) if wrapper is tfs.fused_step_batched_landing else (4, 8, 200)
    p = shape[1]
    x, g = _off_manifold_operands(shape, cuda, seed=6)
    _, _, mu, nu = _operands(shape, cuda, seed=7)
    pv = torch.tensor([p, p // 2 + 1, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(p, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = dict(_kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv), lam=1.0)
    kw.pop("method")
    want = tref.fused_group_step_ref(x, g, 0.1, method="landing", **kw)
    got = wrapper(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("base", ["trace", "vadam"])
def test_fixed_step_landing_on_card_matches_cpu(cuda, base):
    """``orthogonal("landing", safe_step=False, use_kernel=True)``: three
    in-place steps on the card (one fused launch per group and step)
    against the same steps on the CPU."""
    make = {"trace": lambda: topt.chain(topt.trace(0.1)),
            "vadam": lambda: topt.chain(topt.scale_by_vadam())}[base]
    rng = np.random.default_rng(8)
    params = {"q": np.swapaxes(np.linalg.qr(rng.standard_normal((6, 300, 16)))[0],
                               -1, -2).astype(np.float32),
              "k": np.linalg.qr(rng.standard_normal((2, 900, 32)))[0].astype(np.float32)}
    grads = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        opt = tapi.orthogonal("landing", learning_rate=0.05, use_kernel=True,
                              safe_step=False, base_optimizer=make())
        cs = tapi.ConstraintSet.from_tree(params, device=dev)
        gs = tapi.ConstraintSet.from_tree(grads, device=dev)
        st = opt.init(cs)
        step = tapi.constraint_step(opt)
        tops.reset_launches()
        for _ in range(3):
            cs, st, health = step(cs, st, gs)
        assert bool(health.finite)
        if dev == "cuda":
            counts = tops.launches()
            assert counts["fused_step_whole_landing"] == 3  # q: (6, 16, 300)
            assert counts["fused_step_tiled_tc_landing"] == 3  # k: (2, 32, 900)
            assert counts["fused_step_tiled_landing"] == 0
        out[dev] = (cs, st)
    for a, b in zip(out["cpu"][0].stacks, out["cuda"][0].stacks):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)
    for a, b in zip(out["cpu"][1].last_distance.per_group,
                    out["cuda"][1].last_distance.per_group):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)


# ------------------------- the tensor-core fused step (p <= 64, planned 32-64)


def test_tf32_probe_reads_the_card(cuda):
    """One TF32 wgmma on the card: the register fragment of ``csrc/hopper.cuh``
    and the shared-memory operands give a @ b^T exactly on small integers;
    an operand's low 13 bits are dropped (truncated: the emulator's model,
    ``tests/cuda_emu/hopper.cuh``), not rounded."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-8, 9, (64, 8), generator=gen, device=cuda).float()
    b = torch.randint(-8, 9, (64, 8), generator=gen, device=cuda).float()
    for regs in (False, True):
        torch.testing.assert_close(tfs.tf32_probe(a, b, a_regs=regs), a @ b.T, atol=0, rtol=0)
    a = torch.zeros((64, 8), device=cuda)
    b = torch.zeros((64, 8), device=cuda)
    a[:, 0] = 1.0 + 0.75 * 2.0**-10  # 0.75 of a TF32 ulp past 1
    b[:, 0] = 1.0
    for regs in (False, True):
        assert float(tfs.tf32_probe(a, b, a_regs=regs)[0, 0]) == 1.0


TC_SHAPES = [(16, 64, 960), (3, 64, 300), (5, 10, 250), (3, 7, 33), (140, 64, 200),
             (2, 48, 2048)]


@pytest.mark.parametrize("shape", TC_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tc_kernel_matches_plain(cuda, shape, base_kind, hyper, method):
    """Both branches at SmolLM's p, ragged n through TMA (300) and plain
    loads (250, 33), small p in the padded tile, more matrices than SMs
    (140), a longer sweep (2048)."""
    if method == "pogo":
        x, g, mu, nu = _operands(shape, cuda, seed=9)
        kw = _kwargs(base_kind, hyper, mu, nu, cuda)
        wrapper = tfs.fused_step_tiled_tc
    else:
        x, g = _off_manifold_operands(shape, cuda, seed=10)
        _, _, mu, nu = _operands(shape, cuda, seed=11)
        kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), method="landing", lam=1.0)
        wrapper = tfs.fused_step_tiled_tc_landing
    before = wrapper.launches
    got = tfs.fused_step_tiled_tc(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("n", [200, 250])
def test_tc_kernels_in_place_and_ragged(cuda, method, n):
    shape = (4, 8, n)
    x, g, mu, nu = _operands(shape, cuda, seed=12)
    pv = torch.tensor([8, 5, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(8, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = dict(_kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv), method=method)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = tfs.fused_step_tiled_tc(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_tc_step_stays_on_the_manifold(cuda):
    """Ten POGO steps over VAdam on SmolLM's q/k stack (640 x (64, 960)) at
    lr 0.05: the true ``||X X^T - I||_F`` (float64) of the kernel's
    iterates and the distance it reports stay within the trainer's 1e-5,
    as the plain version's do."""
    x, _, mu, nu = _operands((640, 64, 960), cuda, seed=13)
    mu.zero_()
    nu.zero_()
    gen = torch.Generator(device=cuda).manual_seed(14)
    eye = torch.eye(64, dtype=torch.float64, device=cuda)
    for k in range(10):
        g = 0.01 * torch.randn(x.shape, generator=gen, device=cuda)
        count = torch.tensor(k, dtype=torch.int32, device=cuda)
        x, mu, nu, dist, _ = tfs.fused_step_tiled_tc(
            x, g, 0.05, lam=0.5, base_kind="vadam", hyper=(0.9, 0.999, 1e-8), mu=mu,
            nu=nu, count=count, inplace=True)
        true = torch.linalg.matrix_norm(x.double() @ x.double().transpose(-1, -2) - eye)
        assert float(true.max()) <= 1e-5 and float(dist.max()) <= 1e-5, (k, true.max(),
                                                                           dist.max())


def test_tc_planner_matches_the_kernels_smem(cuda):
    for p in range(1, 129):
        assert tfs.tc_lib().fused_tc_smem_bytes(p) == tops.tc_smem_bytes(p), p
    assert tops.plan(64, 960) == tops.plan(128, 2048) == ("tc", 0)
    for n in (33, 200, 2048):  # the wide kernel's park, as the wrappers allocate it
        assert tfs.tc_lib().fused_tc_park_floats(n) == tfs.park_floats(n)


def test_tc_kernel_rejects_large_p(cuda):
    """p = 65 runs, on the wide kernel; p = 129 is refused."""
    x, g, mu, nu = _operands((2, 65, 100), cuda)
    kw = _kwargs("none", (), mu, nu, cuda)
    before = tfs.fused_step_tiled_tc128.launches
    got = tfs.fused_step_tiled_tc(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert tfs.fused_step_tiled_tc128.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))
    x, g, mu, nu = _operands((2, 129, 200), cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfs.fused_step_tiled_tc(x, g, 0.1, **_kwargs("none", (), mu, nu, cuda))


# ------------------------------ the wide tensor-core kernel (64 < p <= 128)


TC_WIDE_SHAPES = [(4, 128, 2048), (3, 72, 250), (5, 100, 300), (140, 128, 200),
                  (2, 65, 70)]


@pytest.mark.parametrize("shape", TC_WIDE_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tc_wide_kernel_matches_plain(cuda, shape, base_kind, hyper, method):
    """Both branches of the wide kernel at internlm2-1.8b's p over a long
    sweep (2048), ragged n through plain loads (250, 70) and TMA (300),
    p = 72, 100 and 65 in the padded halves, more matrices than SMs (140:
    a block reuses its park)."""
    if method == "pogo":
        x, g, mu, nu = _operands(shape, cuda, seed=30)
        kw = _kwargs(base_kind, hyper, mu, nu, cuda)
        wrapper = tfs.fused_step_tiled_tc128
    else:
        x, g = _off_manifold_operands(shape, cuda, seed=31)
        _, _, mu, nu = _operands(shape, cuda, seed=32)
        kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), method="landing", lam=1.0)
        wrapper = tfs.fused_step_tiled_tc128_landing
    before = wrapper.launches
    got = tfs.fused_step_tiled_tc128(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("n", [200, 250])
def test_tc_wide_kernels_in_place_and_ragged(cuda, method, n):
    """X' over X while M's rows 0..63 wait in the park; ragged pv."""
    shape = (4, 100, n)
    x, g, mu, nu = _operands(shape, cuda, seed=33)
    pv = torch.tensor([100, 70, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(100, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = dict(_kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv), method=method)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = tfs.fused_step_tiled_tc(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_tc_wide_step_stays_on_the_manifold(cuda):
    """Ten POGO steps over VAdam at internlm2-1.8b's p (64 x (128, 2048)),
    lr 0.05: the true ``||X X^T - I||_F`` (float64) and the reported
    distance stay within the trainer's 1e-5."""
    x, _, mu, nu = _operands((64, 128, 2048), cuda, seed=34)
    mu.zero_()
    nu.zero_()
    gen = torch.Generator(device=cuda).manual_seed(35)
    eye = torch.eye(128, dtype=torch.float64, device=cuda)
    for k in range(10):
        g = 0.01 * torch.randn(x.shape, generator=gen, device=cuda)
        count = torch.tensor(k, dtype=torch.int32, device=cuda)
        x, mu, nu, dist, _ = tfs.fused_step_tiled_tc128(
            x, g, 0.05, lam=0.5, base_kind="vadam", hyper=(0.9, 0.999, 1e-8), mu=mu,
            nu=nu, count=count, inplace=True)
        true = torch.linalg.matrix_norm(x.double() @ x.double().transpose(-1, -2) - eye)
        assert float(true.max()) <= 1e-5 and float(dist.max()) <= 1e-5, (k, true.max(),
                                                                           dist.max())


@pytest.mark.parametrize("shape,inplace", [((576, 128, 2048), False), ((3, 72, 250), False),
                                           ((140, 100, 300), True), ((2, 65, 70), True)])
def test_two_stage_tc_wide_pogo_matches_plain(cuda, shape, inplace):
    """The wide kernel's POGO update at internlm2-1.8b's q/k stack, plain
    loads (250, 70), more matrices than SMs, in place (M's rows 0..63
    parked, 64.. in the output). X lies off the manifold: dropping lam's
    term fails."""
    x, g = _off_manifold_operands(shape, cuda, seed=36)
    want = tref.pogo_update_ref(x, g, 0.1, 0.5)
    assert not torch.allclose(tref.pogo_update_ref(x, g, 0.1, 0.0), want, atol=2e-5, rtol=1e-4)
    before = tpu.pogo_update_tiled_tc128.launches
    got = tpu.pogo_update_tiled_tc(x, g, 0.1, 0.5, inplace=inplace)
    torch.cuda.synchronize()
    assert tpu.pogo_update_tiled_tc128.launches == before + 1
    assert (got is x) == inplace
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------ TP kernels

TP_SHAPES = [(16, 64, 480), (64, 16, 128), (7, 10, 250), (3, 1, 33)]


@pytest.mark.parametrize("shape", TP_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_tp_gram_matches_plain(cuda, shape, base_kind, hyper):
    x, g, mu, _ = _operands(shape, cuda, seed=9)
    tile_n = tops.plan_tp("tp_gram", shape[1], tops.tp_gram_smem_bytes)
    before = ttp.tp_gram.launches
    got = ttp.tp_gram(x, g, base_kind=base_kind, hyper=hyper, post_scale=0.7,
                      mu=mu if base_kind != "none" else None, tile_n=tile_n)
    torch.cuda.synchronize()
    assert ttp.tp_gram.launches == before + 1
    want = tref.tp_partial_ref(x, g, base_kind=base_kind, hyper=hyper, post_scale=0.7,
                               mu=mu if base_kind != "none" else None)
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", TP_SHAPES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("vadam", [False, True])
def test_tp_apply_matches_plain(cuda, shape, method, vadam):
    x, g = _off_manifold_operands(shape, cuda, seed=10)
    b, p, _ = shape
    payload, gb, _ = tref.tp_partial_ref(x, g)
    scl = torch.rand(b, device=cuda) + 0.5 if vadam else None
    tile_n = tops.plan_tp("tp_apply", p, tops.tp_apply_smem_bytes)
    before = ttp.tp_apply.launches
    got = ttp.tp_apply(x, gb, payload, 0.1, scl, method=method, lam=0.7, tile_n=tile_n)
    torch.cuda.synchronize()
    assert ttp.tp_apply.launches == before + 1
    want = tref.tp_apply_ref(x, gb, payload, 0.1, scl, method=method, lam=0.7)
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tp_kernels_in_place_and_ragged(cuda, method):
    shape = (4, 8, 200)
    x, g = _off_manifold_operands(shape, cuda, seed=11)
    _, _, mu, nu = _operands(shape, cuda, seed=12)
    pv = torch.tensor([8, 5, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(8, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    want_p = tref.tp_partial_ref(x, g, base_kind="vadam", hyper=(0.9, 0.999, 1e-8),
                                 mu=mu)
    pay, gb, mu2 = ttp.tp_gram(x, g, base_kind="vadam", hyper=(0.9, 0.999, 1e-8),
                               mu=mu, inplace=True, tile_n=32)
    assert mu2 is mu
    _close((pay, gb, mu2), want_p, dict(atol=3e-5, rtol=1e-4))
    scl, _ = tref.tp_scale_ref(pay, 8, hyper=(0.9, 0.999, 1e-8), post_scale=1.0,
                               nu=nu, count=torch.tensor(3, device=cuda))
    want = tref.tp_apply_ref(x, gb, pay, 0.1, scl, method=method, lam=0.7, pv=pv)
    got = ttp.tp_apply(x, gb, pay, 0.1, scl.contiguous(), method=method, lam=0.7,
                       pv=pv, inplace=True, tile_n=32)
    torch.cuda.synchronize()
    assert got[0] is x
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_tp_planner_matches_the_kernels_smem(cuda):
    lib = ttp.lib()
    for p in (16, 64, 5, 96):
        for tile_n in (32, 64):
            assert lib.tp_gram_smem_bytes(p, tile_n) == tops.tp_gram_smem_bytes(p, tile_n)
            assert lib.tp_apply_smem_bytes(p, tile_n) == tops.tp_apply_smem_bytes(p, tile_n)


# Rows 3tc and 4tc (csrc/tp_step_tc.cu): p <= 64 at n % 4 == 0; a ragged
# n-edge chunk, rows past p, and SmolLM's rank block at width 2.
TP_TC_SHAPES = [(16, 64, 480), (7, 40, 132), (3, 33, 100), (5, 24, 240)]


@pytest.mark.parametrize("shape", TP_TC_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_tp_gram_tc_matches_plain(cuda, shape, base_kind, hyper):
    x, g, mu, _ = _operands(shape, cuda, seed=9)
    before = ttp.tp_gram_tc.launches
    got = ttp.tp_gram_tc(x, g, base_kind=base_kind, hyper=hyper, post_scale=0.7,
                         mu=mu if base_kind != "none" else None)
    torch.cuda.synchronize()
    assert ttp.tp_gram_tc.launches == before + 1
    want = tref.tp_partial_ref(x, g, base_kind=base_kind, hyper=hyper, post_scale=0.7,
                               mu=mu if base_kind != "none" else None)
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", TP_TC_SHAPES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("vadam", [False, True])
def test_tp_apply_tc_matches_plain(cuda, shape, method, vadam):
    x, g = _off_manifold_operands(shape, cuda, seed=10)
    payload, gb, _ = tref.tp_partial_ref(x, g)
    scl = torch.rand(shape[0], device=cuda) + 0.5 if vadam else None
    before = ttp.tp_apply_tc.launches
    got = ttp.tp_apply_tc(x, gb, payload, 0.1, scl, method=method, lam=0.7)
    torch.cuda.synchronize()
    assert ttp.tp_apply_tc.launches == before + 1
    want = tref.tp_apply_ref(x, gb, payload, 0.1, scl, method=method, lam=0.7)
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tp_tc_kernels_in_place_and_masked(cuda, method):
    """mu' over mu, X' over X, and rows past pv masked out of the distance."""
    shape = (4, 40, 200)
    x, g = _off_manifold_operands(shape, cuda, seed=11)
    _, _, mu, nu = _operands(shape, cuda, seed=12)
    pv = torch.tensor([40, 38, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(40, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    hyper = (0.9, 0.999, 1e-8)
    want_p = tref.tp_partial_ref(x, g, base_kind="vadam", hyper=hyper, mu=mu)
    pay, gb, mu2 = ttp.tp_gram_tc(x, g, base_kind="vadam", hyper=hyper, mu=mu, inplace=True)
    assert mu2 is mu
    _close((pay, gb, mu2), want_p, dict(atol=3e-5, rtol=1e-4))
    scl, _ = tref.tp_scale_ref(pay, 40, hyper=hyper, post_scale=1.0, nu=nu,
                               count=torch.tensor(3, device=cuda))
    want = tref.tp_apply_ref(x, gb, pay, 0.1, scl, method=method, lam=0.7, pv=pv)
    got = ttp.tp_apply_tc(x, gb, pay, 0.1, scl.contiguous(), method=method, lam=0.7,
                          pv=pv, inplace=True)
    torch.cuda.synchronize()
    assert got[0] is x
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_tp_tc_planner_matches_the_kernels_smem(cuda):
    lib = ttp.tc_lib()
    assert lib.tp_gram_tc_smem_bytes() == tops.tp_gram_tc_smem_bytes()
    assert lib.tp_apply_tc_smem_bytes() == tops.tp_apply_tc_smem_bytes()
    assert lib.tp_alg_smem_bytes() == tops.tp_alg_smem_bytes()


def test_tp_tc_kernels_refuse_what_they_do_not_take(cuda):
    """p > 64, a row stride TMA cannot take (n % 4 != 0), or an operand off
    a 16-byte boundary: a ValueError, no launch."""
    for shape in ((2, 65, 64), (2, 32, 62)):
        x, g = (torch.randn(shape, device=cuda) for _ in range(2))
        with pytest.raises(ValueError, match="tensor-core TP"):
            ttp.tp_gram_tc(x, g)
    flat = torch.randn(2 * 8 * 64 + 1, device=cuda)
    off_x = flat[1:].view(2, 8, 64)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        ttp.tp_gram_tc(off_x, torch.randn(2, 8, 64, device=cuda))


@pytest.mark.parametrize("shape,kernels", [
    ((8, 64, 960), ("tp_gram_tc", "tp_apply_tc")),
    ((8, 16, 256), ("tp_gram", "tp_apply")),  # p below TP_TC_MIN_P
    # 482 columns a shard (n % 4 != 0) for the partials; the finish runs on
    # the whole 964 columns
    ((8, 64, 964), ("tp_gram", "tp_apply_tc")),
])
def test_tp_schedule_takes_the_planned_route(cuda, shape, kernels):
    x, g, mu, nu = _operands(shape, cuda, seed=14)
    kw = dict(method="pogo", lam=0.5, base_kind="vadam", hyper=(0.9, 0.999, 1e-8),
              mu=mu, nu=nu, count=torch.tensor(3, dtype=torch.int32, device=cuda))
    tops.reset_launches()
    got = tops.fused_group_step_tp(x, g, 0.1, tp_shards=2, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in tops.launches().items() if v} == {kernels[0]: 2, kernels[1]: 1}
    want = tops.fused_group_step_tp(x.cpu(), g.cpu(), 0.1, tp_shards=2, **{
        k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()})
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a.cpu(), b, atol=3e-5, rtol=1e-4)


def test_tp_kernels_reject_bad_operands(cuda):
    x, g, mu, _ = _operands((2, 4, 16), cuda)
    with pytest.raises(ValueError, match="dtype"):
        ttp.tp_gram(x.double(), g.double())
    with pytest.raises(ValueError, match="mu"):
        ttp.tp_gram(x, g, base_kind="trace", hyper=(0.9, False))
    pay, gb, _ = ttp.tp_gram(x, g, tile_n=32)
    with pytest.raises(ValueError, match="payload"):
        ttp.tp_apply(x, gb, pay[:, :3], 0.1, method="pogo", lam=0.5)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        ttp.tp_apply(xt, gb, pay, 0.1, method="pogo", lam=0.5)


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("base_kind,hyper", [("trace", (0.9, False)),
                                             ("vadam", (0.9, 0.999, 1e-8))])
def test_tp_schedule_on_card_matches_cpu(cuda, method, base_kind, hyper):
    """The single-device TP schedule, four shards of SmolLM's q/k width, on
    the card against the same schedule's plain version on the CPU."""
    x, g, mu, nu = _operands((32, 64, 960), cuda, seed=13)
    kw = dict(method=method, lam=0.7, base_kind=base_kind, hyper=hyper,
              tp_shards=4, count=torch.tensor(3, dtype=torch.int32, device=cuda))
    got = tops.fused_group_step_tp(x, g, 0.1, mu=mu,
                                   nu=nu if base_kind == "vadam" else None, **kw)
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    want = tops.fused_group_step_tp(x.cpu(), g.cpu(), 0.1, mu=mu.cpu(),
                                    nu=nu.cpu() if base_kind == "vadam" else None, **cpu)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a.cpu(), b, atol=3e-5, rtol=1e-4)


# ------------------------------------------------------ two-stage kernels

TWO_STAGE = [(tpu.pogo_update_whole, 0), (tpu.pogo_update_tiled, 32),
             (tlf.landing_field, 0), (tlf.landing_field_tiled, 32),
             (tlf.landing_field_tiled, 64)]


POGO_UPDATES = (tpu.pogo_update_whole, tpu.pogo_update_tiled, tpu.pogo_update_tiled_tc,
                tpu.pogo_update_batched)


def _two_stage_call(wrapper, tile_n, x, g, **kw):
    extra = {"tile_n": tile_n} if tile_n else {}
    if wrapper in POGO_UPDATES:
        return wrapper(x, g, 0.1, 0.5, **extra, **kw)
    return wrapper(x, g, 1.0, **extra)


def _two_stage_plain(wrapper, x, g, lam=None):
    if wrapper in POGO_UPDATES:
        return tref.pogo_update_ref(x, g, 0.1, 0.5 if lam is None else lam)
    return tref.landing_field_ref(x, g, 1.0 if lam is None else lam)


def _off_manifold_operands(shape, device, seed):
    """A Stiefel draw plus 0.01 randn, so that lam's term (the land
    stage's, the field's lam (A X - X)) is far above the tolerances."""
    x, g, _, _ = _operands(shape, device, seed)
    noise = np.random.default_rng(seed + 100).standard_normal(shape)
    return x + torch.tensor(0.01 * noise, dtype=torch.float32, device=device), g


@pytest.mark.parametrize("shape", [(64, 16, 256), (7, 10, 250), (3, 1, 33),
                                   (4, 64, 300)])
@pytest.mark.parametrize("wrapper,tile_n", TWO_STAGE)
def test_two_stage_kernels_match_plain(cuda, shape, wrapper, tile_n):
    """atol 1e-6 whole, 2e-5 / rtol 1e-4 tiled, as ``tests/test_kernels.py``
    holds the Pallas kernels; the whole kernels get rtol 1e-5 here, since
    cuBLAS sums their products in another order. (64, 300) is the widest
    of these a whole-kernel block holds. X lies off the manifold: a kernel
    that dropped lam's term would fail."""
    x, g = _off_manifold_operands(shape, cuda, seed=4)
    before = wrapper.launches
    got = _two_stage_call(wrapper, tile_n, x, g)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4) if tile_n else dict(atol=1e-6, rtol=1e-5)
    want = _two_stage_plain(wrapper, x, g)
    assert not torch.allclose(_two_stage_plain(wrapper, x, g, lam=0.0), want, **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("shape", [(1031, 4, 4), (515, 2, 3), (3, 1, 4), (1000, 3, 3)])
@pytest.mark.parametrize("inplace", [False, True])
def test_batched_pogo_update_matches_plain(cuda, shape, inplace):
    """``csrc/batched_whole.cu``'s update, the whole kernel's tolerance; X
    off the manifold, so that a dropped lam term fails."""
    x, g = _off_manifold_operands(shape, cuda, seed=6)
    want = _two_stage_plain(tpu.pogo_update_batched, x, g)
    before = tpu.pogo_update_batched.launches
    got = _two_stage_call(tpu.pogo_update_batched, 0, x, g, inplace=inplace)
    torch.cuda.synchronize()
    assert tpu.pogo_update_batched.launches == before + 1
    assert (got is x) == inplace
    tol = dict(atol=1e-6, rtol=1e-5)
    assert not torch.allclose(_two_stage_plain(tpu.pogo_update_batched, x, g, lam=0.0), want,
                              **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("wrapper,tile_n", TWO_STAGE[:2])
def test_pogo_update_kernels_in_place(cuda, wrapper, tile_n):
    x, g = _off_manifold_operands((5, 24, 300), cuda, seed=5)
    want = tref.pogo_update_ref(x, g, 0.1, 0.5)
    got = _two_stage_call(wrapper, tile_n, x, g, inplace=True)
    torch.cuda.synchronize()
    assert got is x
    torch.testing.assert_close(x, want, atol=2e-5, rtol=1e-4)


def test_two_stage_planner_matches_the_kernels_smem(cuda):
    lib = tpu.lib()
    for p, n in [(16, 256), (64, 960), (5, 40), (120, 4096), (128, 2048)]:
        assert lib.two_stage_whole_smem_bytes(0, p, n) == tops.pogo_whole_smem_bytes(p, n)
        assert lib.two_stage_whole_smem_bytes(1, p, n) == tops.landing_whole_smem_bytes(p, n)
        for t in (16, 32, 64):
            assert lib.two_stage_tiled_smem_bytes(0, p, t) == tops.pogo_tiled_smem_bytes(p, t)
            assert lib.two_stage_tiled_smem_bytes(1, p, t) == \
                tops.landing_tiled_smem_bytes(p, t)
    # the tensor-core route: the fused step's block, whatever n
    assert tops.plan_pogo_update(64, 960) == tops.plan_landing_field(64, 960) == ("tc", 0)
    for p in (64, 128):
        assert tfs.tc_lib().fused_tc_smem_bytes(p) == tops.tc_smem_bytes(p)
    # p = 128: both take the wide kernel; POGO's CUDA-core kernel fits a
    # block there at 16 columns only, the field's at 64
    assert tops.plan_pogo_update(128, 2048) == tops.plan_landing_field(128, 2048) == ("tc", 0)
    assert lib.two_stage_tiled_smem_bytes(0, 128, 16) <= tops.SMEM_LIMIT_BYTES
    assert lib.two_stage_tiled_smem_bytes(1, 128, 64) <= tops.SMEM_LIMIT_BYTES


TWO_STAGE_TC = [tpu.pogo_update_tiled_tc, tlf.landing_field_tiled_tc]


@pytest.mark.parametrize("shape", [(640, 64, 960), (4, 64, 300), (7, 10, 250), (3, 7, 33),
                                   (140, 48, 200), (2, 32, 2048)])
@pytest.mark.parametrize("wrapper", TWO_STAGE_TC)
def test_two_stage_tc_kernels_match_plain(cuda, shape, wrapper):
    """The tensor-core two-stage entries at the tiled tolerance: SmolLM's
    q/k stack, a ragged chunk through TMA (300), plain loads (250, 33),
    small p in the padded tile, more matrices than SMs (140), a long
    sweep (2048). X lies off the manifold: dropping lam's term fails."""
    x, g = _off_manifold_operands(shape, cuda, seed=15)
    before = wrapper.launches
    got = _two_stage_call(wrapper, 0, x, g)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4)
    want = _two_stage_plain(wrapper, x, g)
    assert not torch.allclose(_two_stage_plain(wrapper, x, g, lam=0.0), want, **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("n", [300, 250], ids=["tma", "plain_loads"])
def test_two_stage_tc_pogo_in_place(cuda, n):
    """X' over X: M parked in X's place between the last two sweeps."""
    x, g = _off_manifold_operands((150, 24, n), cuda, seed=16)
    want = tref.pogo_update_ref(x, g, 0.1, 0.5)
    got = tpu.pogo_update_tiled_tc(x, g, 0.1, 0.5, inplace=True)
    torch.cuda.synchronize()
    assert got is x
    torch.testing.assert_close(x, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("wrapper", [tpu.pogo_update_tiled, tpu.pogo_update_tiled_tc])
def test_pogo_update_with_a_device_held_eta(cuda, wrapper):
    """A learning rate held on the card gives the same bits as the same
    value passed from the host."""
    x, g = _off_manifold_operands((16, 64, 960), cuda, seed=17)
    extra = {"tile_n": 32} if wrapper is tpu.pogo_update_tiled else {}
    host = wrapper(x, g, 0.1, 0.5, **extra)
    dev = wrapper(x, g, torch.tensor(0.1, device=cuda), 0.5, **extra)
    torch.cuda.synchronize()
    assert torch.equal(dev, host)
    torch.testing.assert_close(dev, tref.pogo_update_ref(x, g, 0.1, 0.5), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("wrapper,pogo", [(tpu.pogo_update_tiled, True),
                                          (tlf.landing_field_tiled, False)])
def test_two_stage_tiled_kernels_at_p128(cuda, wrapper, pogo):
    """internlm2-1.8b's p = 128 on the CUDA-core tiled kernels at their
    tile (16 for POGO, 64 for the field; both plan the wide tensor-core
    kernel there)."""
    x, g = _off_manifold_operands((3, 128, 2048), cuda, seed=18)
    tiled = tops.pogo_tiled_smem_bytes if pogo else tops.landing_tiled_smem_bytes
    tile_n = tops.two_stage_tile_n(128, tiled)
    assert tile_n == (16 if pogo else 64)
    assert (tops.plan_pogo_update if pogo else tops.plan_landing_field)(128, 2048) == \
        ("tc", 0)
    got = _two_stage_call(wrapper, tile_n, x, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _two_stage_plain(wrapper, x, g), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(576, 128, 2048), (3, 72, 250), (5, 100, 300),
                                   (140, 128, 200)])
def test_two_stage_tc_wide_field_matches_plain(cuda, shape):
    """``landing_field_tiled_tc128`` at the two-stage tiled tolerance:
    internlm2-1.8b's q/k stack, plain loads (250), a ragged chunk through
    TMA (300), more matrices than SMs (140); ``landing_field_tiled_tc``
    hands it p > 64. X lies off the manifold: dropping lam's term fails."""
    x, g = _off_manifold_operands(shape, cuda, seed=19)
    before = tlf.landing_field_tiled_tc128.launches
    got = tlf.landing_field_tiled_tc(x, g, 1.0)
    torch.cuda.synchronize()
    assert tlf.landing_field_tiled_tc128.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4)
    want = tref.landing_field_ref(x, g, 1.0)
    assert not torch.allclose(tref.landing_field_ref(x, g, 0.0), want, **tol)
    torch.testing.assert_close(got, want, **tol)


def test_two_stage_kernels_reject_bad_operands(cuda):
    x, g, _, _ = _operands((2, 4, 16), cuda)
    with pytest.raises(ValueError, match="dtype"):
        tpu.pogo_update_whole(x.double(), g.double(), 0.1, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tlf.landing_field(x.transpose(1, 2).contiguous().transpose(1, 2), g, 1.0)
    with pytest.raises(ValueError, match="alias"):
        tpu.launch("pogo_update_whole", x, g, 0.1, 0.5, g)


@pytest.mark.parametrize("method,base,kw,gscale,steps", [
    ("pogo", lambda: topt.chain(topt.scale_by_adam()), dict(learning_rate=1e-3),
     0.3, 3),
    ("landing", lambda: topt.chain(topt.trace(0.1)), dict(learning_rate=0.25),
     0.03, 3),
    ("landing", lambda: topt.scale_by_adam(), dict(learning_rate=1e-3, eps=0.05),
     0.3, 3),
    ("landing", lambda: topt.chain(topt.trace(0.1)), dict(learning_rate=0.25),
     0.3, 1),
])
def test_two_stage_step_on_card_matches_cpu(cuda, method, base, kw, gscale, steps):
    """In-place ``constraint_step``s on the card (the whole kernels and the
    tensor-core two-stage entries, once a step: p = 16 and p = 64 groups)
    against the plain route on the CPU. The last case's safe step binds:
    one step only, since from the eps-sphere the next step's "already
    violating" test compares two numbers equal to rounding, and the two
    devices may take different branches; the next test follows binding
    steps further."""
    rng = np.random.default_rng(6)
    params = {"q": np.swapaxes(np.linalg.qr(rng.standard_normal((6, 300, 16)))[0],
                               -1, -2).astype(np.float32),
              "k": np.linalg.qr(rng.standard_normal((2, 960, 64)))[0].astype(np.float32)}
    grads = {k: (gscale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        opt = tapi.orthogonal(method, use_kernel=True, base_optimizer=base(), **kw)
        cs = tapi.ConstraintSet.from_tree(params, device=dev)
        gs = tapi.ConstraintSet.from_tree(grads, device=dev)
        st = opt.init(cs)
        step = tapi.constraint_step(opt)
        tops.reset_launches()
        for _ in range(steps):
            cs, st, health = step(cs, st, gs)
        assert bool(health.finite)
        out[dev] = (cs, st)
    tc = tpu.pogo_update_tiled_tc if method == "pogo" else tlf.landing_field_tiled_tc
    assert tc.launches == steps
    for a, b in zip(out["cpu"][0].stacks, out["cuda"][0].stacks):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)
    for a, b in zip(out["cpu"][1].last_distance.per_group,
                    out["cuda"][1].last_distance.per_group):
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=1e-4)


def _safe_step_ties():
    """``benchmarks_torch/safe_step_ties.py``: Landing runs that record a0
    and eta per step, and where two runs part."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks_torch" / \
        "safe_step_ties.py"
    spec = importlib.util.spec_from_file_location("safe_step_ties", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case,offset", [("landing_trace", 0.003),
                                         ("landing_adam_lr0.1", 0.0005)])
def test_landing_on_card_parts_from_cpu_only_after_ties(cuda, case, offset):
    """Three Landing steps whose safe step binds, on the card and on the
    CPU. A binding step leaves X on the eps-sphere, where the next step's
    a0 = ||X X^T - I||^2 - eps^2 is zero to rounding, and its sign picks
    the safe step's branch or root. Each matrix must agree at atol 3e-5 /
    rtol 1e-4 after every step, up to a step at which both devices saw a0
    at rounding and chose other etas. X starts ``offset`` randn off the
    manifold (inside the eps-ball), so step 0, where no tie can be, also
    holds the field's lam term."""
    ties = _safe_step_ties()
    eps = ties.CASES[case][1].get("eps", 0.5)
    cpu = ties.run(case, "cpu", "float32", 3, offset)
    card = ties.run(case, "cuda", "float32", 3, offset)
    untied = {k: v for k, v in ties.partings(cpu, card, eps).items() if v and not v[1]}
    assert not untied, f"(group, matrix): (step, tie) parted without a tie: {untied}"


# ----------------------------------------------------------- Newton-Schulz


def _drifted(shape, device, seed=0):
    """1.5 x a Stiefel draw + 0.05 randn: the watchdog's drift."""
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = 1.5 * np.swapaxes(q, -1, -2) + 0.05 * rng.standard_normal(shape)
    return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)


def _ns_wrapper(p, n):
    """The planned Newton-Schulz wrapper for (p, n)."""
    kind, tile_n = tops.plan_newton_schulz(p, n)
    if kind == "tiled":
        return functools.partial(tns.newton_schulz_tiled, tile_n=tile_n)
    return getattr(tns, f"newton_schulz_{kind}")


# The planned kernels (the tensor-core one at (64, 960) and (48, 1500), a
# cluster of 2 and of 4 CTAs, and at (48, 2001), n % 4 != 0: scalar loads;
# the p <= 128 tensor-core one at p = 128 (row 9w), the tiled one at (10,
# 9998); the cluster kernel of small_p.cu at (16, 4096)), and the
# tensor-core kernel called directly at clusters of 1 and 8 CTAs.
NS_CASES = [((64, 64, 960), None), ((256, 16, 256), None), ((7, 10, 250), None),
            ((3, 1, 33), None), ((3, 48, 1500), None), ((3, 48, 2001), None),
            ((3, 128, 2048), None), ((5, 10, 9998), None), ((5, 16, 4096), None),
            ((5, 40, 600), tns.newton_schulz_tc), ((2, 64, 4600), tns.newton_schulz_tc)]


@pytest.mark.parametrize("shape,wrapper", NS_CASES)
def test_newton_schulz_kernels_match_plain(cuda, shape, wrapper):
    """Unmasked, out of place, against ``ref.newton_schulz_ref``: atol 1e-6
    (``tests/test_kernels.py:54-61``); the emitted distance is the
    projection's."""
    x = _drifted(shape, cuda)
    wrapper = wrapper or _ns_wrapper(*shape[1:])
    dist = torch.empty(shape[0], device=cuda)
    got = wrapper(x, 12, dist=dist)
    torch.cuda.synchronize()
    want = tref.newton_schulz_ref(x, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(dist, tref.manifold_distance_ref(want), atol=2e-6, rtol=1e-3)
    assert float(dist.max()) < 1e-2


@pytest.mark.parametrize("shape", [(64, 64, 960), (256, 16, 256), (7, 10, 250),
                                   (9, 48, 1500), (9, 10, 10000)])
def test_newton_schulz_repair_in_place_with_mask(cuda, shape):
    """The watchdog's repair: every other matrix past the threshold,
    written over the stack; the others keep their bits and distances."""
    x = _drifted(shape, cuda, seed=1)
    b = shape[0]
    dist = torch.where(torch.arange(b, device=cuda) % 2 == 0, 2.0, 0.01).float()
    x0, d0 = x.clone(), dist.clone()
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert torch.equal(rep, d0 > 0.1)
    want = tref.newton_schulz_ref(x0, 12)
    torch.testing.assert_close(x[rep], want[rep], atol=1e-6, rtol=0)
    assert torch.equal(x[~rep], x0[~rep]) and torch.equal(dist[~rep], d0[~rep])
    assert float(dist[rep].max()) < 1e-2


def test_newton_schulz_repair_with_no_matrix_past_the_threshold(cuda):
    """The watchdog's launch on every step: no matrix trips, so every
    cluster exits at once and nothing changes, bit for bit."""
    x = _drifted((640, 64, 960), cuda, seed=2)
    dist = torch.full((640,), 1e-6, device=cuda)
    x0, d0 = x.clone(), dist.clone()
    before = tns.newton_schulz_tc.launches
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert tns.newton_schulz_tc.launches == before + 1
    assert not bool(rep.any()) and torch.equal(x, x0) and torch.equal(dist, d0)


def test_newton_schulz_planner_matches_the_kernels_smem(cuda):
    lib = tns.lib()
    for p, n in ((16, 256), (10, 250), (64, 960)):
        assert lib.ns_whole_smem_bytes(p, n) == tops.ns_whole_smem_bytes(p, n)
        for t in (32, 64):
            assert lib.ns_tiled_smem_bytes(p, t) == tops.ns_tiled_smem_bytes(p, t)
    tc = tns.tc_lib()
    for n in (1, 64, 576, 577, 960, 2304, 4608, 4609):
        assert tc.ns_tc_cluster(n) == tops.ns_tc_cluster(n)
        assert tc.ns_tc_smem_bytes(n) == tops.ns_tc_smem_bytes(n) <= tops.SMEM_LIMIT_BYTES


def test_newton_schulz_tc128_planner_matches_the_kernels_smem(cuda):
    """``ops.ns_tc128_cluster`` / ``ns_tc128_smem_bytes`` mirror the C
    launcher's, and the card keeps at least one cluster resident at each."""
    tc = tns.tc_lib()
    for n in (1, 60, 64, 256, 300, 960, 1024, 1025, 1500, 2048, 2049):
        assert tc.ns_tc128_cluster(n) == tops.ns_tc128_cluster(n)
        assert tc.ns_tc128_smem_bytes(n) == tops.ns_tc128_smem_bytes(n) <= tops.SMEM_LIMIT_BYTES
        if tops.ns_tc128_cluster(n):
            assert tc.ns_tc128_max_clusters(n) >= 1


# newton_schulz_tc128 (64 < p <= 128): internlm2-1.8b's (128, 2048) on 16
# CTAs a matrix, ragged p on 8 (n = 1000), n % 4 != 0 (scalar loads, 16),
# clusters of 8 and 4 with a ragged last chunk, and of 2 where one CTA
# holds no chunk (n = 60, p <= 64: the kernel takes any p up to 128).
NS_TC128_CASES = [(3, 128, 2048), (4, 72, 1000), (3, 100, 1501), (5, 96, 520),
                  (3, 128, 300), (3, 40, 60)]


@pytest.mark.parametrize("shape", NS_TC128_CASES)
def test_newton_schulz_tc128_matches_plain(cuda, shape):
    """Unmasked out of place, then masked in place (every other matrix:
    the others and their distances keep their bits), against
    ``ref.newton_schulz_ref`` at atol 1e-6."""
    x = _drifted(shape, cuda, seed=3)
    b = shape[0]
    dist = torch.empty(b, device=cuda)
    got = tns.newton_schulz_tc128(x, 12, dist=dist)
    torch.cuda.synchronize()
    want = tref.newton_schulz_ref(x, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(dist, tref.manifold_distance_ref(want), atol=2e-6, rtol=1e-3)
    mask = torch.arange(b, device=cuda) % 2 == 0
    dist = torch.full((b,), 7.0, device=cuda)
    y = x.clone()
    tns.newton_schulz_tc128(y, 12, out=y, mask=mask, dist=dist)
    torch.cuda.synchronize()
    torch.testing.assert_close(y[mask], want[mask], atol=1e-6, rtol=0)
    assert torch.equal(y[~mask], x[~mask]) and bool((dist[~mask] == 7.0).all())
    assert float(dist[mask].max()) < 1e-2


def test_newton_schulz_tc128_idle_repair_writes_nothing(cuda):
    """The watchdog's launch on a step with no drift at internlm2-1.8b's
    q/k: the planned kernel launches once, every cluster skips every
    matrix, nothing changes, bit for bit."""
    x = _drifted((576, 128, 2048), cuda, seed=4)
    dist = torch.full((576,), 1e-6, device=cuda)
    x0, d0 = x.clone(), dist.clone()
    assert tops.plan_newton_schulz(128, 2048) == ("tc128", 0)
    before = tns.newton_schulz_tc128.launches
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert tns.newton_schulz_tc128.launches == before + 1
    assert not bool(rep.any()) and torch.equal(x, x0) and torch.equal(dist, d0)


def test_newton_schulz_stream_planner_matches_the_kernels_smem(cuda):
    """``ops.ns_stream_smem_bytes`` mirrors the C entry, and the persistent
    grid is one CTA an SM."""
    tc = tns.tc_lib()
    assert tc.ns_stream_smem_bytes() == tops.ns_stream_smem_bytes() <= tops.SMEM_LIMIT_BYTES
    assert tc.ns_stream_max_clusters() == torch.cuda.get_device_properties(0).multi_processor_count


# newton_schulz_stream (row 9s): small n that still streams and wraps the
# ring (11 chunks), a ragged p and n, as many chunks as stages, n just past
# row 9w's 2048, and starcoder2-15b's (128, 6144).
NS_STREAM_CASES = [(3, 128, 704), (4, 100, 644), (3, 72, 1000), (3, 128, 132),
                   (3, 65, 2112), (5, 128, 6144)]


@pytest.mark.parametrize("shape", NS_STREAM_CASES)
def test_newton_schulz_stream_matches_plain(cuda, shape):
    """Unmasked out of place, then masked in place (every other matrix:
    the others and their distances keep their bits), against
    ``ref.newton_schulz_ref`` at atol 1e-6, 12 iterations."""
    x = _drifted(shape, cuda, seed=5)
    b = shape[0]
    dist = torch.empty(b, device=cuda)
    got = tns.newton_schulz_stream(x, 12, dist=dist)
    torch.cuda.synchronize()
    want = tref.newton_schulz_ref(x, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(dist, tref.manifold_distance_ref(want), atol=2e-6, rtol=1e-3)
    mask = torch.arange(b, device=cuda) % 2 == 0
    dist = torch.full((b,), 7.0, device=cuda)
    y = x.clone()
    tns.newton_schulz_stream(y, 12, out=y, mask=mask, dist=dist)
    torch.cuda.synchronize()
    torch.testing.assert_close(y[mask], want[mask], atol=1e-6, rtol=0)
    assert torch.equal(y[~mask], x[~mask]) and bool((dist[~mask] == 7.0).all())
    assert float(dist[mask].max()) < 1e-2


def test_newton_schulz_stream_refuses_what_it_cannot_take(cuda):
    """n % 4 != 0 (a row stride TMA cannot take) and fewer chunks than
    the ring's stages raise; nothing falls back."""
    for shape in ((2, 128, 4098), (2, 128, 128)):
        x = _drifted(shape, cuda)
        with pytest.raises(RuntimeError, match="newton_schulz_stream"):
            tns.newton_schulz_stream(x, 12)


def test_newton_schulz_stream_route(cuda):
    """The route the planner picks at starcoder2-15b's q/k, (128, 6144),
    through the watchdog's repair: every other matrix past the threshold,
    then none (the idle repair writes nothing), one launch each."""
    kind = tops.plan_newton_schulz(128, 6144)[0]
    wrapper = tns.newton_schulz_stream if kind == "stream" else tns.newton_schulz_tiled
    x = _drifted((6, 128, 6144), cuda, seed=6)
    dist = torch.where(torch.arange(6, device=cuda) % 2 == 0, 2.0, 0.01).float()
    x0, d0 = x.clone(), dist.clone()
    before = wrapper.launches
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and torch.equal(rep, d0 > 0.1)
    torch.testing.assert_close(x[rep], tref.newton_schulz_ref(x0[rep], 12), atol=1e-6, rtol=0)
    assert torch.equal(x[~rep], x0[~rep]) and torch.equal(dist[~rep], d0[~rep])
    x0, d0 = x.clone(), torch.full((6,), 1e-6, device=cuda)
    dist = d0.clone()
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert not bool(rep.any()) and torch.equal(x, x0) and torch.equal(dist, d0)


def test_newton_schulz_cluster_planner_matches_the_kernels_smem(cuda):
    """``ops.ns_cluster`` / ``ns_cluster_smem_bytes`` mirror the C entries
    of ``csrc/small_p.cu``."""
    lib = tfs.cluster_lib()
    for p, n in ((10, 10000), (1, 64), (7, 300), (24, 10000), (31, 2048), (28, 10000),
                 (16, 4096), (10, 9998), (33, 2048), (31, 60000)):
        assert lib.ns_cluster(p, n) == tops.ns_cluster(p, n)
        for c in (2, 4, 8):
            assert lib.ns_cluster_smem_bytes(p, n, c) == tops.ns_cluster_smem_bytes(p, n, c)


# newton_schulz_cluster (p < 32, row 9cl): the paper's unitary-PC (10,
# 10000) on its own cluster size and on each other, ragged p and n (a last
# CTA's box cut short), p = 1, p = 24 (rows rolled), p = 31 (one CTA an
# SM), and a cluster of 8 whose last CTAs hold no box.
NS_CLUSTER_CASES = [((9, 10, 10000), 0), ((9, 10, 10000), 8), ((9, 10, 10000), 2),
                    ((7, 7, 300), 4), ((5, 1, 64), 0), ((6, 24, 4096), 0), ((5, 31, 2048), 0),
                    ((5, 10, 40), 8)]


@pytest.mark.parametrize("shape,c", NS_CLUSTER_CASES)
def test_newton_schulz_cluster_matches_plain(cuda, shape, c):
    """Unmasked out of place, then masked in place (every other matrix:
    the others and their distances keep their bits), 12 iterations, against
    ``ref.newton_schulz_ref`` at atol 1e-6."""
    x = _drifted(shape, cuda, seed=5)
    b = shape[0]
    dist = torch.empty(b, device=cuda)
    got = tns.newton_schulz_cluster(x, 12, dist=dist, cluster=c or None)
    torch.cuda.synchronize()
    want = tref.newton_schulz_ref(x, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(dist, tref.manifold_distance_ref(want), atol=2e-6, rtol=1e-3)
    mask = torch.arange(b, device=cuda) % 2 == 0
    dist = torch.full((b,), 7.0, device=cuda)
    y = x.clone()
    tns.newton_schulz_cluster(y, 12, out=y, mask=mask, dist=dist, cluster=c or None)
    torch.cuda.synchronize()
    torch.testing.assert_close(y[mask], want[mask], atol=1e-6, rtol=0)
    assert torch.equal(y[~mask], x[~mask]) and bool((dist[~mask] == 7.0).all())
    assert float(dist[mask].max()) < 1e-2


def test_newton_schulz_cluster_repair_at_the_paper_sizes(cuda):
    """The watchdog's repair at the paper's unitary-PC 1048 x (10, 10000):
    the planned cluster kernel launches once, repairs every other matrix in
    place, and the idle repair (no matrix past the threshold) changes
    nothing, bit for bit."""
    x = _drifted((1048, 10, 10000), cuda, seed=6)
    dist = torch.where(torch.arange(1048, device=cuda) % 2 == 0, 2.0, 1e-6).float()
    x0, d0 = x.clone(), dist.clone()
    assert tops.plan_newton_schulz(10, 10000) == ("cluster", 0)
    before = tns.newton_schulz_cluster.launches
    thresh = torch.tensor(0.1, device=cuda)
    rep = tops.newton_schulz_repair(x, dist, thresh, iters=12)
    torch.cuda.synchronize()
    assert tns.newton_schulz_cluster.launches == before + 1
    assert torch.equal(rep, d0 > 0.1)
    torch.testing.assert_close(x[rep], tref.newton_schulz_ref(x0[rep], 12), atol=1e-6, rtol=0)
    assert torch.equal(x[~rep], x0[~rep]) and torch.equal(dist[~rep], d0[~rep])
    x1, d1 = x.clone(), torch.full((1048,), 1e-6, device=cuda)
    rep = tops.newton_schulz_repair(x, d1, thresh, iters=12)
    torch.cuda.synchronize()
    assert not bool(rep.any()) and torch.equal(x, x1) and bool((d1 == 1e-6).all())


# ------------------------------------------------------------- large p

# The large route (csrc/large_p.cu, p > 128), on the tensor cores where n %
# 4 == 0 (``*_large_tc``) and on the CUDA cores where not (``*_large``):
# the paper's CNN filters' (256, 2304) stack; p and n off the tiles (136,
# 250: n % 4 != 0, scalar loads); a ragged last chunk and n-slices (200,
# 900).
LARGE_SHAPES = [(3, 256, 2304), (2, 136, 250), (2, 200, 900)]
ROUTES = ["large", "large_tc"]


def _large(module, stem, route, landing=False):
    """The large route's wrapper ``<stem>_large[_tc][_landing]`` of ``module``."""
    return getattr(module, f"{stem}_{route}" + ("_landing" if landing else ""))


@pytest.mark.parametrize("shape", LARGE_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_large_fused_step_matches_plain(cuda, shape, base_kind, hyper, method):
    """``fused_step_large(_tc)`` (and the Landing branches) at the fused
    tiled tolerance, atol 3e-5 / rtol 1e-4; ``ops.fused_group_step`` plans
    the tensor cores' at n % 4 == 0, the CUDA cores' otherwise."""
    x, g, mu, nu = _operands(shape, cuda, seed=30)
    if method == "landing":
        x = x + 0.01 * torch.randn(shape, device=cuda)
    kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), method=method,
              lam=1.0 if method == "landing" else 0.5)
    route = tops.large_kind(shape[-1])
    wrapper = _large(tfs, "fused_step", route, method == "landing")
    before = wrapper.launches
    got = tops.fused_group_step(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert tops.plan(*shape[1:], method) == (route, 0)
    assert wrapper.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_large_fused_step_in_place_and_ragged(cuda, method, route):
    """X' over X (Landing's through a scratch), mu' over mu (through a
    scratch: phase 1 still reads mu), nu' over nu; zero-padded rows masked
    per matrix (pv)."""
    shape = (4, 160, 300)
    x, g, mu, nu = _operands(shape, cuda, seed=31)
    pv = torch.tensor([160, 100, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(160, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = dict(_kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv), method=method)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = _large(tfs, "fused_step", route)(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", LARGE_SHAPES)
@pytest.mark.parametrize("pogo", [True, False], ids=["pogo_update", "landing_field"])
def test_large_two_stage_matches_plain(cuda, shape, pogo):
    """``pogo_update_large(_tc)`` and ``landing_field_large(_tc)`` at the
    two-stage tiled tolerance, atol 2e-5 / rtol 1e-4, through ``ops``'
    planners; X off the manifold, so that dropping lam's term would fail."""
    x, g = _off_manifold_operands(shape, cuda, seed=32)
    route = tops.large_kind(shape[-1])
    wrapper = _large(tpu, "pogo_update", route) if pogo else _large(tlf, "landing_field", route)
    planned = (tops.plan_pogo_update if pogo else tops.plan_landing_field)(*shape[1:])
    before = wrapper.launches
    if pogo:
        got = tops.pogo_update(x, g, 0.1, 0.5)
        want, without = (tref.pogo_update_ref(x, g, 0.1, lam) for lam in (0.5, 0.0))
    else:
        got = tops.landing_field(x, g, 1.0)
        want, without = (tref.landing_field_ref(x, g, lam) for lam in (1.0, 0.0))
    torch.cuda.synchronize()
    assert planned == (route, 0)
    assert wrapper.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4)
    assert not torch.allclose(without, want, **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("route", ROUTES)
def test_large_pogo_update_in_place_with_a_device_held_eta(cuda, route):
    update = _large(tpu, "pogo_update", route)
    x, g = _off_manifold_operands((3, 256, 2304), cuda, seed=33)
    want = update(x, g, 0.1, 0.5)
    got = update(x, g, torch.tensor(0.1, device=cuda), 0.5, inplace=True)
    torch.cuda.synchronize()
    assert got is x and torch.equal(x, want)
    torch.testing.assert_close(want, tref.pogo_update_ref(
        *_off_manifold_operands((3, 256, 2304), cuda, seed=33), 0.1, 0.5),
        atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 256, 2304), (3, 200, 250), (5, 136, 300)])
def test_large_newton_schulz_repair_in_place_with_mask(cuda, shape):
    """``newton_schulz_large(_tc)`` as the watchdog runs it: every other
    matrix past the threshold, written over the stack (12 iterations, an
    even count: the last lands in x itself), atol 1e-6; the others keep
    their bits and distances. The emitted distance within 1e-5 of the plain
    version's: both are fp32 grams of a matrix at fp32 feasibility, which
    round apart by about their own size (an exact Stiefel draw rounded to
    fp32 reads 2.2e-6 at (256, 2304); an H100 read the kernel's and the
    plain distance 3.1e-6 apart there). Then out of place and unmasked,
    with an odd count (x copied aside first)."""
    x = _drifted(shape, cuda, seed=34)
    b, p, n = shape
    dist = torch.where(torch.arange(b, device=cuda) % 2 == 0, 2.0, 0.01).float()
    x0, d0 = x.clone(), dist.clone()
    route = tops.large_kind(n)
    kernel = _large(tns, "newton_schulz", route)
    before = kernel.launches
    assert tops.plan_newton_schulz(p, n) == (route, 0)
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1, device=cuda), iters=12)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(rep, d0 > 0.1)
    want = tref.newton_schulz_ref(x0, 12)
    torch.testing.assert_close(x[rep], want[rep], atol=1e-6, rtol=0)
    torch.testing.assert_close(dist[rep], tref.manifold_distance_ref(want[rep]), atol=1e-5,
                               rtol=0)
    assert torch.equal(x[~rep], x0[~rep]) and torch.equal(dist[~rep], d0[~rep])
    assert float(dist[rep].max()) < 1e-2
    y = x0.clone()
    got = kernel(y, 11, out=y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tref.newton_schulz_ref(x0, 11), atol=1e-6, rtol=0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", [(3, 256, 2304), (2, 200, 900)])
def test_large_kernels_repeat_bit_for_bit(cuda, shape, route):
    """The n-slices' partials are summed in a fixed order: two launches of
    each entry give the same bits."""
    x, g, mu, nu = _operands(shape, cuda, seed=35)
    kw = _kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda)
    fused = _large(tfs, "fused_step", route)
    runs = [(lambda: fused(x, g, 0.1, **kw)[:4]),
            (lambda: fused(x, g, 0.1, **{**kw, "method": "landing"})[:4]),
            (lambda: (_large(tpu, "pogo_update", route)(x, g, 0.1, 0.5),)),
            (lambda: (_large(tlf, "landing_field", route)(x, g, 1.0),)),
            (lambda: (_large(tns, "newton_schulz", route)(1.5 * x, 12),))]
    for run in runs:
        first = [t.clone() for t in run()]
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# The cluster kernels (csrc/small_p.cu), one matrix a thread block cluster:
# the paper's unitary-PC (10, 10000) (a cluster of 8, two CTAs an SM), a
# cluster of 2 at (10, 256) and at p = 1, clusters of 8 at (24, 2048) and at
# (28, 4096) (one CTA an SM, past the route's end), and a cluster of 4 at
# (16, 2048) with more matrices than resident clusters.
CLUSTER_SHAPES = [(40, 10, 10000), (7, 10, 256), (5, 24, 2048), (3, 1, 64), (3, 28, 4096),
                  (300, 16, 2048)]


@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_cluster_fused_step_matches_plain(cuda, shape, base_kind, hyper):
    x, g, mu, nu = _operands(shape, cuda, seed=41)
    kw = _kwargs(base_kind, hyper, mu, nu, cuda)
    before = tfs.fused_step_cluster.launches
    got = tfs.fused_step_cluster(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert tfs.fused_step_cluster.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cluster_pogo_update_matches_plain(cuda, shape):
    """The two-stage tiled tolerance; X off the manifold, so that a kernel
    that dropped lam's term would fail."""
    x, g = _off_manifold_operands(shape, cuda, seed=42)
    before = tpu.pogo_update_cluster.launches
    got = tpu.pogo_update_cluster(x, g, 0.1, 0.5)
    torch.cuda.synchronize()
    assert tpu.pogo_update_cluster.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4)
    want = tref.pogo_update_ref(x, g, 0.1, 0.5)
    assert not torch.allclose(tref.pogo_update_ref(x, g, 0.1, 0.0), want, **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_cluster_fused_landing_matches_plain(cuda, shape, base_kind, hyper):
    """Fused Landing's entry; X off the manifold, so that lam (A X - X)
    shows."""
    x, g = _off_manifold_operands(shape, cuda, seed=48)
    _, _, mu, nu = _operands(shape, cuda, seed=49)
    kw = dict(_kwargs(base_kind, hyper, mu, nu, cuda), method="landing", lam=1.0)
    before = tfs.fused_step_cluster_landing.launches
    got = tfs.fused_step_cluster(x, g, 0.1, **kw)
    torch.cuda.synchronize()
    assert tfs.fused_step_cluster_landing.launches == before + 1
    _close(got, tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))


@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cluster_landing_field_matches_plain(cuda, shape):
    """The two-stage tiled tolerance; X off the manifold, so that a kernel
    that dropped lam's term would fail."""
    x, g = _off_manifold_operands(shape, cuda, seed=50)
    before = tlf.landing_field_cluster.launches
    got = tlf.landing_field_cluster(x, g, 1.0)
    torch.cuda.synchronize()
    assert tlf.landing_field_cluster.launches == before + 1
    tol = dict(atol=2e-5, rtol=1e-4)
    want = tref.landing_field_ref(x, g, 1.0)
    assert not torch.allclose(tref.landing_field_ref(x, g, 0.0), want, **tol)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("c", [2, 4, 8])
def test_cluster_kernels_at_every_cluster_size(cuda, c):
    """A forced cluster of 2, 4 or 8 CTAs gives the plain version's result."""
    x, g, mu, nu = _operands((33, 10, 2048), cuda, seed=43)
    kw = _kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda)
    _close(tfs.fused_step_cluster(x, g, 0.1, cluster=c, **kw),
           tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))
    torch.testing.assert_close(tpu.pogo_update_cluster(x, g, 0.1, 0.5, cluster=c),
                               tref.pogo_update_ref(x, g, 0.1, 0.5), atol=2e-5, rtol=1e-4)
    kw.update(method="landing", lam=1.0)
    _close(tfs.fused_step_cluster(x, g, 0.1, cluster=c, **kw),
           tref.fused_group_step_ref(x, g, 0.1, **kw), dict(atol=3e-5, rtol=1e-4))
    torch.testing.assert_close(tlf.landing_field_cluster(x, g, 1.0, cluster=c),
                               tref.landing_field_ref(x, g, 1.0), atol=2e-5, rtol=1e-4)


def test_cluster_kernels_in_place_and_ragged(cuda):
    shape = (5, 8, 2000)
    x, g, mu, nu = _operands(shape, cuda, seed=44)
    pv = torch.tensor([8, 5, 1, 0, 8], dtype=torch.int32, device=cuda)
    rows = torch.arange(8, device=cuda)[None, :, None] < pv[:, None, None]
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = _kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = tfs.fused_step_cluster(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))
    y, g2 = _off_manifold_operands((9, 10, 10000), cuda, seed=45)
    want = tref.pogo_update_ref(y, g2, 0.1, 0.5)
    assert tpu.pogo_update_cluster(y, g2, 0.1, 0.5, inplace=True) is y
    torch.testing.assert_close(y, want, atol=2e-5, rtol=1e-4)
    x, g, mu, nu = _operands(shape, cuda, seed=51)
    x, g, mu = (torch.where(rows, a, 0.0) for a in (x, g, mu))
    kw = dict(_kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda, pv=pv), method="landing",
              lam=1.0)
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    got = tfs.fused_step_cluster(x, g, 0.1, inplace=True, **kw)
    torch.cuda.synchronize()
    assert got[0] is x and got[1] is mu and got[2] is nu
    _close(got, want, dict(atol=3e-5, rtol=1e-4))


def test_cluster_kernels_repeat_bit_for_bit(cuda):
    """Every CTA sums the cluster's partial grams in rank order: two launches
    give the same bits."""
    x, g, mu, nu = _operands((200, 10, 10000), cuda, seed=46)
    kw = _kwargs("vadam", (0.9, 0.999, 1e-8), mu, nu, cuda)
    lkw = dict(kw, method="landing", lam=1.0)
    for run in (lambda: tfs.fused_step_cluster(x, g, 0.1, **kw)[:4],
                lambda: tfs.fused_step_cluster(x, g, 0.1, **lkw)[:4],
                lambda: (tpu.pogo_update_cluster(x, g, 0.1, 0.5),),
                lambda: (tlf.landing_field_cluster(x, g, 1.0),)):
        first = [t.clone() for t in run()]
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_cluster_planner_matches_the_source(cuda):
    lib = tfs.cluster_lib()
    for p in (1, 4, 10, 16, 24, 28, 32, 33):
        for n in (64, 256, 2048, 4096, 9998, 10000, 30000):
            assert lib.small_p_cluster(p, n) == tops.small_p_cluster(p, n), (p, n)
            for c in (2, 4, 8):
                assert lib.small_p_smem_bytes(p, n, c) == tops.small_p_smem_bytes(p, n, c)


def test_cluster_kernels_refuse_what_they_do_not_take(cuda):
    """n % 4 != 0 (a row stride TMA cannot take), p > 32: every entry
    raises; nothing falls back."""
    x, g, mu, nu = _operands((2, 10, 250), cuda, seed=47)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfs.fused_step_cluster(x, g, 0.1, lam=0.5)
    with pytest.raises(RuntimeError, match="cudaError"):
        tpu.pogo_update_cluster(x, g, 0.1, 0.5)
    with pytest.raises(RuntimeError, match="cudaError"):
        tlf.landing_field_cluster(x, g, 1.0)
    x, g, _, _ = _operands((2, 33, 256), cuda, seed=47)
    with pytest.raises(RuntimeError, match="cudaError"):
        tpu.pogo_update_cluster(x, g, 0.1, 0.5)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfs.fused_step_cluster(x, g, 0.1, method="landing", lam=1.0)
    with pytest.raises(RuntimeError, match="cudaError"):
        tlf.landing_field_cluster(x, g, 1.0)


def test_large_tc_route_refuses_n_not_a_multiple_of_4(cuda):
    """The tensor cores' entries raise where TMA cannot take the row stride
    (the planner sends such n to the CUDA cores); nothing falls back."""
    x, g, mu, nu = _operands((2, 136, 250), cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        tfs.fused_step_large_tc(x, g, 0.1, lam=0.5)
    with pytest.raises(RuntimeError, match="cudaError"):
        tns.newton_schulz_large_tc(x, 12)
    lib = tfs.large_p.lib()
    for p in (129, 136, 256, 1024):
        assert lib.large_tc_padded(p) == tfs.large_p.tc_padded(p)
        for moments in (0, 1):
            assert lib.large_tc_gram_blocks(p, moments) == tfs.large_p.tc_gram_blocks(p, moments)


def test_large_route_rejects_bad_operands(cuda):
    x, g, mu, nu = _operands((2, 136, 200), cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfs.fused_step_large(x.double(), g.double(), 0.1, lam=0.5)
    with pytest.raises(ValueError, match="contiguous"):
        tpu.pogo_update_large(x.transpose(1, 2).contiguous().transpose(1, 2), g, 0.1, 0.5)
    with pytest.raises(ValueError, match="out=x"):
        tns.newton_schulz_large(x, 12, mask=torch.ones(2, dtype=torch.bool, device=cuda))
    lib = tfs.large_p.lib()
    for p in (129, 136, 256, 1024):
        assert lib.large_padded(p) == tfs.large_p.padded(p)
        for moments in (0, 1):
            assert lib.large_gram_tiles(p, moments) == tfs.large_p.gram_tiles(p, moments)


# ----------------------------------------------------------------- trainer


def _trainer(device, use_kernel):
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models import ortho
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype="float32")
    params = ortho.project_init(tfm.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    params = tree.tree_map(lambda t: t.to(device), params)
    tc = TrainConfig(warmup_steps=2, decay_steps=10, learning_rate=1e-2,
                     pogo_learning_rate=0.3, pogo_use_kernel=use_kernel,
                     ortho_watchdog=tapi.WatchdogConfig())
    step, opt = make_train_step(cfg, tc)
    data = DataIterator(DataConfig(cfg.vocab_size, 32, 4, seed=1), device=device)
    return step, params, opt.init(params), data


def test_two_trainer_steps_on_card_match_cpu(cuda):
    """Two steps of ``make_train_step`` at the smoke config in fp32 compute,
    POGO's fused kernel and the watchdog on: the card (kernels, cuBLAS)
    against the CPU (plain versions) from the same weights and data, loss
    and every parameter within atol 1e-4 / rtol 1e-3 (fp32 sums in
    another order over two AdamW and POGO steps)."""
    from repro_torch import tree

    runs = []
    for device, use_kernel in ((cuda, True), (torch.device("cpu"), True)):
        step, params, state, data = _trainer(device, use_kernel)
        tops.reset_launches()
        losses = []
        for _ in range(2):
            params, state, metrics = step(params, state, next(data))
            losses.append(float(metrics["loss"]))
            assert float(metrics["health_finite"]) == 1.0
            assert float(metrics["ortho_distance"]) < 1e-3
        runs.append((losses, params, tops.launches()))
    (l_card, p_card, launches), (l_cpu, p_cpu, _) = runs
    assert launches["fused_step_whole"] == 2  # (40, 120) fits one block
    np.testing.assert_allclose(l_card, l_cpu, atol=1e-4, rtol=1e-3)
    for a, b in zip(tree.leaves(p_card), tree.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------ flash attention

FLASH_CASES = [  # (B, S, H, KV, hd), dtype, causal, window
    # fp32 at hd % 4 == 0: the 3xTF32 kernel
    ((1, 128, 2, 2, 64), torch.float32, True, None),
    ((2, 256, 4, 2, 32), torch.float32, False, None),
    ((1, 200, 2, 1, 32), torch.float32, False, None),
    ((1, 2000, 3, 1, 40), torch.float32, True, None),
    ((1, 700, 6, 2, 64), torch.float32, True, 256),
    ((1, 300, 2, 2, 128), torch.float32, True, 1),
    # ... at chip_smoke.py's fp32 shapes: the prefill's, internlm2-1.8b's
    # heads, S = 2000 causal, non-causal and windowed
    ((4, 2048, 15, 5, 64), torch.float32, True, None),
    ((1, 2048, 16, 8, 128), torch.float32, True, None),
    ((2, 2000, 15, 5, 64), torch.float32, True, None),
    ((2, 2000, 15, 5, 64), torch.float32, False, None),
    ((2, 2000, 15, 5, 64), torch.float32, True, 256),
    ((1, 333, 4, 2, 24), torch.float32, False, 100),
    # fp32 at hd % 4 != 0: the CUDA-core kernel
    ((1, 300, 2, 1, 62), torch.float32, True, None),
    ((1, 130, 2, 2, 5), torch.float32, False, None),
    ((2, 333, 15, 5, 64), torch.bfloat16, True, None),
    ((1, 64, 2, 1, 24), torch.bfloat16, False, 8),
    # the tensor-core kernel at the prefill's shape and more
    ((4, 2048, 15, 5, 64), torch.bfloat16, True, None),   # SmolLM-360M's prefill
    ((1, 2048, 16, 8, 128), torch.bfloat16, True, None),  # internlm2-1.8b's heads
    ((1, 2000, 15, 5, 64), torch.bfloat16, True, 256),    # S not a multiple of 128, window
    ((1, 333, 4, 2, 40), torch.bfloat16, True, None),     # hd 40 in one zero-filled box
    ((1, 300, 2, 1, 24), torch.bfloat16, True, 100),      # hd 24, window across tiles
    ((2, 300, 2, 2, 96), torch.bfloat16, False, None),    # hd 96: two boxes, one half empty
    ((1, 130, 2, 1, 5), torch.bfloat16, True, None),      # hd 5: rows padded to 8 in a copy
]


@pytest.mark.parametrize("shape,dtype,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, shape, dtype, causal, window):
    b, s, h, kvh, hd = shape
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=gen, device=cuda).to(dtype)
    kernel = tfa.KERNELS[tfa.plan(dtype, hd)]
    tops.reset_launches()
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: c for n, c in tops.launches().items() if c} == {kernel.__name__: 1}
    want = tfa.run_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=1 / 64)


def test_flash_kernel_true_length_and_bad_operands(cuda):
    """More keys than queries, non-causal, at no multiple of the tile:
    every key takes its weight and none past Sk does, in both kernels."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 50, 2, 16), generator=gen, device=cuda)
    k = torch.randn((1, 90, 2, 16), generator=gen, device=cuda)
    got = tfa.flash_attention_fwd(q, k, k, causal=False)
    want = tfa.run_plain(q, k, k, causal=False, window=None)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    qb, kb = q.bfloat16(), k.bfloat16()
    got = tfa.flash_attention_fwd(qb, kb, kb, causal=False)
    want = tfa.run_plain(qb, kb, kb, causal=False, window=None)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=1 / 64)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q.half(), q.half())
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q.transpose(1, 2), k, k)
    wide = torch.zeros((1, 8, 1, 160), device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(wide, wide, wide)
    assert tfa.lib().flash_attention_smem_bytes(64) == 4 * (2 * 64 * 68 + 64 * 64 + 64 * 68)
    # Q and two stages of K and V, 16 KB a 64-column box, five barriers,
    # room to align: one box of hd up to 64, two up to 128
    for hd, boxes in ((64, 1), (128, 2)):
        want_bytes = 5 * boxes * 128 * 64 * 2 + 5 * 8 + 1024
        assert tfa.tc_lib().flash_attention_tc_smem_bytes(hd) == want_bytes
    # 3xTF32: Q's 32-column boxes of 128 rows (and Q_lo's to hd 64), two
    # stages of five tiles (64 keys up to hd 64, 32 past it), seven
    # barriers, room to align
    for hd, boxes, keys, q_tiles in ((64, 2, 64, 2), (128, 4, 32, 1), (24, 1, 64, 2)):
        want_bytes = (q_tiles * boxes * 128 * 128 + 2 * 5 * boxes * keys * 128 + 7 * 8
                      + 1024)
        assert tfa.tf32_lib().flash_attention_tf32_smem_bytes(hd) == want_bytes
    with pytest.raises(ValueError):  # rows TMA cannot address
        tfa.flash_attention_tf32(q[..., :14], k[..., :14], k[..., :14], causal=True,
                                 window=None)


def _smoke_model():
    """The fp32 smoke model, weights on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype="float32")
    return cfg, tfm.init_params(torch.Generator().manual_seed(0), cfg)


def test_prefill_on_card_matches_cpu(cuda):
    """Every layer's attention through the kernel on the card (the 3xTF32
    one: the smoke model's heads are 40 wide); the CPU runs the plain
    version. fp32, atol 5e-4 / rtol 1e-3: the card and the CPU
    sum every product of the four layers in other orders (cuBLAS against
    the CPU's BLAS), as ``tests/test_torch_model.py``'s gradients (rtol
    1e-3); the card read 1.8e-4 at most."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    cfg, params = _smoke_model()
    dev_params = tree.tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    got = tfm.prefill(dev_params, cfg, toks.to(cuda))
    assert ops.launches()["flash_attention_tf32"] == cfg.num_layers
    want = tfm.prefill(params, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, atol=5e-4, rtol=1e-3)


def test_engine_on_card_matches_oracle(cuda):
    """A burst through the paged engine on the card against the dense
    oracle on the card, tie rule (serve/parity.py)."""
    from repro_torch import tree
    from repro_torch.serve import Request, ServeEngine, generate_reference, parity

    cfg, params = _smoke_model()
    params = tree.tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, 100, int(rng.integers(3, 13))).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 9))) for i in range(12)]
    eng = ServeEngine(params, cfg, n_slots=4, n_blocks=65, block_size=4, prefill_chunk=5)
    rec = parity.record_logits(eng)
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == 12
    for r in reqs:
        ref_logits = []
        ref = generate_reference(params, cfg, r.prompt, r.max_new_tokens, logits=ref_logits)
        res = parity.compare_tokens(r.out_tokens, ref, ref_logits, rec[r.uid],
                                    limit=parity.LOGIT_LIMITS[cfg.compute_dtype])
        assert res["ok"], f"request {r.uid}: {res}"
