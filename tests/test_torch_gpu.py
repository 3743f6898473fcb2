"""CUDA kernel tests of the port: each kernel against its plain version on
the card. Marked ``gpu``; without a card they skip (decided in a fixture,
never at import). Run them on the card with
``PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports JAX, which the card's
machine need not have).

Tolerances are those the JAX tests hold the Pallas kernels to
(``tests/test_fused_step.py:67,95``): atol 2e-5 / rtol 1e-4 whole,
atol 3e-5 / rtol 1e-4 tiled.
"""

import numpy as np
import pytest
import torch

from repro_torch import optim as topt
from repro_torch.core import api as tapi
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


@pytest.mark.parametrize("shape,tile_n", [((16, 64, 960), 32), ((16, 64, 960), 64),
                                          ((5, 10, 250), 32), ((2, 120, 300), 32)])
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


@pytest.mark.parametrize("wrapper", [tfs.fused_step_whole, tfs.fused_step_tiled])
def test_kernels_in_place_and_ragged(cuda, wrapper):
    shape = (4, 8, 200)
    x, g, mu, nu = _operands(shape, cuda, seed=2)
    pv = torch.tensor([8, 5, 1, 0], dtype=torch.int32, device=cuda)
    rows = torch.arange(8, device=cuda)[None, :, None] < pv[:, None, None]
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
