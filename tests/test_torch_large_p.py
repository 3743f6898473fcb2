"""Parity of the port's large-p route (p > 128) with the JAX package, on
the CPU.

Where one matrix's (p, p) grams outgrow a block, the port's planners give
``("large_tc", 0)`` (n % 4 == 0) or ``("large", 0)``: the gram-then-apply
launches of ``csrc/large_p.cu`` (``kernels/large_p.py``), on the tensor
cores or the CUDA cores, for the fused step (POGO and Landing), the POGO
update, the landing field and Newton-Schulz. On the CPU every entry point
runs the kernels' plain version; the CUDA-core kernels run here through
the g++-emulated build of ``large_p.cu`` (``tests/_cuda_emu.py``, a
``large_p.Runner`` over it; ``tests/test_torch_kernel_emulation.py`` runs
them with n split into slices, masks and in place;
``tests/test_torch_large_tc_emulation.py`` the tensor-core ones), and on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). The same numpy inputs go
through both packages at p > 128 and small n (the emulated kernels take
the first matrix of each stack):

* ``ops.fused_group_step`` and, at the first shape (``KERNEL_CASES``),
  the kernel ``fused_step_large`` against JAX's Pallas tiled kernel in interpret
  mode (the VMEM budget shrunk as ``tests/test_fused_step.py`` does, so
  that the planner falls back to its best-effort 128-column tile, the plan
  it makes at the paper's sizes), every base and both methods, atol 3e-5 /
  rtol 1e-4 (``tests/test_fused_step.py:95``);
* ``ops.pogo_update`` and ``ops.landing_field``, and the kernels
  ``pogo_update_large`` and ``landing_field_large``, against JAX's, atol
  2e-5 / rtol 1e-4 (the two-stage tiled tolerance,
  ``tests/test_kernels.py:65-75``);
* ``ops.newton_schulz`` and the kernel ``newton_schulz_large`` (3 and 2
  iterations, an odd and an even count of its ping-pong) against JAX's,
  atol 1e-6 (``tests/test_kernels.py:54-61``);
* the slice as a whole: ``orthogonal(..., use_kernel=True)`` and
  ``constraint_step`` on the paper's CNN filters (``CNN_FILTERS``, n cut
  to keep the CPU run short) against JAX's step, atol 2e-5 / rtol 1e-4;
* the planners' routes at the paper's sizes, and at p <= 128, where
  nothing moved.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import large_p_library

from repro import optim as jopt
from repro.configs import pogo_paper
from repro.core import api as japi
from repro.kernels import ops as jops
from repro_torch import optim as topt
from repro_torch import tree
from repro_torch.core import api as tapi
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import landing_field as tlf
from repro_torch.kernels import large_p as tlp
from repro_torch.kernels import newton_schulz as tns
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pogo_update as tpu

FUSED_TOL = dict(atol=3e-5, rtol=1e-4)
TWO_STAGE_TOL = dict(atol=2e-5, rtol=1e-4)
STEP_TOL = dict(atol=2e-5, rtol=1e-4)
SHAPES = [(2, 136, 200), (2, 192, 320)]
# Hyperparameters of this file alone: JAX's dispatch caches by its static
# arguments, so a plan traced elsewhere under another VMEM budget is never
# reused here.
BASES = [("none", ()), ("trace", (0.37, False)), ("trace", (0.53, True)),
         ("vadam", (0.92, 0.997, 1e-8))]
LARGE = ("large", 0)
CLUSTER = ("cluster", 0)
LARGE_TC = ("large_tc", 0)
# The fused kernel's cases against JAX, at the first shape and on its first
# matrix: every base and both methods, each method twice (an emulated call
# takes seconds; the emulation tests hold every base and method against
# the plain version).
KERNEL_CASES = {("pogo", "none"), ("pogo", "vadam"), ("landing", "trace")}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """A runner of the large route's kernels through their emulated build."""
    lib = large_p_library(tmp_path_factory)
    return lambda: tlp.Runner(lib, None, 132)


def _operands(shape, seed, off_manifold=0.0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + off_manifold * rng.standard_normal(shape)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (
        x, 0.2 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape),
        np.abs(rng.standard_normal(b))))


# (p, n): fused POGO, fused Landing, POGO update, landing field, Newton-Schulz
PLANS = [
    # the field's and Newton-Schulz's CUDA-core tiled kernels still fit a
    # block at 136 and 160, where the large route was faster on the card
    (136, 2048, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC),
    (160, 2048, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC),
    (256, 2304, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC),  # the CNN filters
    (1024, 1024, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC),  # O-ViT
    (129, 2048, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC),
    (136, 200, LARGE_TC, LARGE_TC, LARGE_TC, LARGE_TC, ("whole", 0)),  # NS fits whole
    # n % 4 != 0, a row stride TMA cannot take: the CUDA cores' large route
    (256, 2305, LARGE, LARGE, LARGE, LARGE, LARGE),
    (200, 901, LARGE, LARGE, LARGE, LARGE, LARGE),
    (1024, 1022, LARGE, LARGE, LARGE, LARGE, LARGE),
    # p <= 128: Newton-Schulz past p = 64 on its cluster kernel where n <= 2048
    (128, 2048, ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0), ("tc128", 0)),
    (128, 1152, ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0), ("tc128", 0)),
    (64, 960, ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0)),
    (64, 576, ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0), ("whole", 0)),
    (64, 216, ("whole", 0), ("whole", 0), ("whole", 0), ("whole", 0), ("whole", 0)),
    (16, 256, ("whole", 0), ("whole", 0), ("whole", 0), ("whole", 0), ("whole", 0)),
    # the cluster kernel (csrc/small_p.cu) where a cluster holds the matrix
    # and n % 4 == 0, all four entries up to p = 24 (ops.CLUSTER_MAX_P), and
    # Newton-Schulz's to p = 31 (ops.NS_TC_MIN_P), where a cluster holds Y
    # alone (ops.ns_cluster)
    (10, 10000, CLUSTER, CLUSTER, CLUSTER, CLUSTER, CLUSTER),
    (28, 2048, ("tiled", 64), ("tc", 0), ("tiled", 64), ("tc", 0), CLUSTER),
    (10, 9998, ("tiled", 64), ("tiled", 64), ("tiled", 64), ("tiled", 64), ("tiled", 64)),
    (32, 4096, ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0), ("tc", 0)),
    (24, 10000, ("tiled", 64), ("tiled", 64), ("tiled", 64), ("tiled", 64), CLUSTER),
]


@pytest.mark.parametrize("p,n,fused,landing,update,field,ns", PLANS)
def test_planner_routes(p, n, fused, landing, update, field, ns):
    assert tops.plan(p, n) == fused
    assert tops.plan(p, n, "landing") == landing
    assert tops.plan_pogo_update(p, n) == update
    assert tops.plan_landing_field(p, n) == field
    assert tops.plan_newton_schulz(p, n) == ns


def test_the_tp_planner_names_its_roadmap_entry():
    with pytest.raises(ValueError, match=r"sharded schedules \(large p\)"):
        tops.plan_tp("tp_gram", 256, tops.tp_gram_smem_bytes)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base_kind,hyper", BASES)
@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_fused_step_matches_pallas_tiled(shape, base_kind, hyper, method, monkeypatch,
                                        emulated):
    monkeypatch.setattr(jops, "VMEM_BUDGET_BYTES", 64 * 1024)
    b, p, n = shape
    assert jops.plan_candidates(p, n, b, f"fused_{method}+{base_kind}") == [
        {"kind": "tiled", "block_b": 0, "tile_n": 128}]
    assert tops.plan(p, n, method) == LARGE_TC
    x, g, mu, nu = _operands(shape, 0, 0.01 if method == "landing" else 0.0)
    has_mu, has_nu = base_kind != "none", base_kind == "vadam"
    common = dict(method=method, lam=1.0 if method == "landing" else 0.5,
                  base_kind=base_kind, hyper=hyper, post_scale=0.85)
    want = jops.fused_group_step(
        jnp.asarray(x), jnp.asarray(g), 0.1, use_pallas=True, interpret=True,
        mu=jnp.asarray(mu) if has_mu else None, nu=jnp.asarray(nu) if has_nu else None,
        count=jnp.asarray(3, jnp.int32), **common)
    routes = [("plain", tops.fused_group_step, slice(None))]
    if shape == SHAPES[0] and (method, base_kind) in KERNEL_CASES:  # its first matrix
        routes.append(("kernel", functools.partial(tfs.fused_step_large, runner=emulated()),
                       slice(0, 1)))
    for route, step, rows in routes:
        def t(a):
            return torch.from_numpy(a[rows])

        got = step(t(x), t(g), 0.1, mu=t(mu) if has_mu else None,
                   nu=t(nu) if has_nu else None, count=torch.tensor(3, dtype=torch.int32),
                   **common)
        for name, a, w in zip(("x", "mu", "nu", "dist", "finite"), got, want):
            if w is None:
                assert a is None, (route, name)
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(w)[rows],
                                       err_msg=f"{route} {name}", **FUSED_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_two_stage_and_newton_schulz_match_jax(shape, emulated):
    """The plain route (12 Newton-Schulz iterations) and, on the first
    matrix, the kernels against JAX (Newton-Schulz: 3 and 2 iterations,
    an odd and an even count of its ping-pong)."""
    ns_iters = 3 if shape == SHAPES[0] else 2
    b, p, n = shape
    assert tops.plan_pogo_update(p, n) == LARGE_TC
    x, g, _, _ = _operands(shape, 1, 0.01)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    want_u = np.asarray(jops.pogo_update(jx, jg, 0.1, 0.5))
    want_f = np.asarray(jops.landing_field(jx, jg, 1.0))
    for got_u, got_f, rows in (  # the plain route; the kernels on the first matrix
            (tops.pogo_update(tx, tg, 0.1, 0.5), tops.landing_field(tx, tg, 1.0), slice(None)),
            (tpu.pogo_update_large(tx[:1], tg[:1], 0.1, 0.5, runner=emulated()),
             tlf.landing_field_large(tx[:1], tg[:1], 1.0, runner=emulated()), slice(0, 1))):
        np.testing.assert_allclose(got_u.numpy(), want_u[rows], **TWO_STAGE_TOL)
        np.testing.assert_allclose(got_f.numpy(), want_f[rows], **TWO_STAGE_TOL)
    drifted = 1.5 * x + 0.05 * np.random.default_rng(2).standard_normal(shape).astype(
        np.float32)
    td, jd = torch.from_numpy(drifted), jnp.asarray(drifted)
    np.testing.assert_allclose(tops.newton_schulz(td).numpy(),
                               np.asarray(jops.newton_schulz(jd, interpret=True)), atol=1e-6)
    np.testing.assert_allclose(
        tns.newton_schulz_large(td[:1], ns_iters, runner=emulated()).numpy(),
        np.asarray(jops.newton_schulz(jd, ns_iters, interpret=True))[:1], atol=1e-6)


# The paper's CNN filters (src/repro/configs/pogo_paper.py:8), n cut to at
# most 320 columns: the (256, 2304) filters keep their p (the large route
# on the card), the others theirs (whole, tensor-core and wide there).
CNN_LEAVES = {f"conv{i}": (1, p, min(n, 320))
              for i, (p, n) in enumerate(pogo_paper.CNN_FILTERS)}
SLICE = {  # method, kwargs, lr, JAX base, port base (chip_smoke.make_opt's paths)
    "fused": ("pogo", {}, 0.1, lambda: jopt.chain(jopt.trace(0.9)),
              lambda: topt.chain(topt.trace(0.9))),
    "pogo_adam": ("pogo", {}, 1e-3, lambda: jopt.chain(jopt.scale_by_adam()),
                  lambda: topt.chain(topt.scale_by_adam())),
    "landing": ("landing", {}, 0.25, lambda: jopt.chain(jopt.trace(0.1)),
                lambda: topt.chain(topt.trace(0.1))),
    "landing_fused": ("landing", {"safe_step": False}, 0.25,
                      lambda: jopt.chain(jopt.trace(0.1)),
                      lambda: topt.chain(topt.trace(0.1))),
}


@pytest.mark.parametrize("path", sorted(SLICE))
def test_cnn_filters_constraint_step_matches_jax(path):
    """Two ``constraint_step``s on the CNN filter set in both packages,
    the feasibility watchdog on, the same gradients: stacks, distances and
    base moments agree."""
    method, kw, lr, make_j, make_t = SLICE[path]
    rng = np.random.default_rng(5)
    params = {}
    for name, (b, p, n) in CNN_LEAVES.items():
        q, _ = np.linalg.qr(rng.standard_normal((n, p)))
        params[name] = np.ascontiguousarray(q.T, np.float32)
    opt_j = japi.orthogonal(method, learning_rate=lr, use_kernel=True,
                            base_optimizer=make_j(), watchdog=japi.WatchdogConfig(), **kw)
    opt_t = tapi.orthogonal(method, learning_rate=lr, use_kernel=True,
                            base_optimizer=make_t(), watchdog=tapi.WatchdogConfig(), **kw)
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    cs_t = tapi.ConstraintSet.from_tree(params, device="cpu")
    assert [tuple(s.shape) for s in cs_t.stacks] == [tuple(s.shape) for s in cs_j.stacks]
    st_j, st_t = opt_j.init(cs_j), opt_t.init(cs_t)
    step_j, step_t = japi.constraint_step(opt_j), tapi.constraint_step(opt_t)
    for _ in range(2):
        grads = {k: (5e-4 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        cs_j, st_j, h_j = step_j(
            cs_j, st_j, japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, grads)))
        cs_t, st_t, h_t = step_t(cs_t, st_t, tapi.ConstraintSet.from_tree(grads, device="cpu"))
        for a, w in zip(cs_t.stacks, cs_j.stacks):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **STEP_TOL)
        for a, w in zip(st_t.last_distance.per_group, st_j.last_distance.per_group):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **STEP_TOL)
        want = jax.tree.leaves(st_j.base_state)
        got = tree.leaves(st_t.base_state)
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **STEP_TOL)
        assert bool(h_t.finite) and bool(h_j.finite)
