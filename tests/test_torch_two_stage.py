"""Parity of the port's two-stage group step with the JAX package, on the
CPU.

The same numpy inputs go through both packages:

* the plain versions of the four two-stage kernels (``ops.pogo_update``,
  ``ops.landing_field`` on CPU tensors) against JAX's ``ops.pogo_update``
  and ``ops.landing_field`` (Pallas in interpret mode, as
  ``tests/test_kernels.py`` runs them: atol 1e-6), and against JAX's
  ``pogo_update_tiled``/``landing_field_tiled`` called directly (atol
  2e-5 / rtol 1e-4, the tiled tolerance of ``tests/test_kernels.py``);
* ``solve_quartic`` (each port root within 1e-3 relative of a JAX root:
  complex64 Ferrari, where the two packages differ by a few ulp in every
  intermediate) and ``_safe_eta`` (eta within rtol 1e-4: the step is the
  root of a quartic whose fp32 coefficients differ in the last bits);
* the base optimizers ``scale_by_adam``/``adam``/``adamw``/``sgd`` over
  four steps (atol 1e-6 / rtol 1e-5: elementwise fp32);
* the whole slice: ``orthogonal("pogo", base=scale_by_adam())``, the
  paper's Landing and ``use_kernel=False``, three steps on a small tree
  with a tall leaf through ``opt.update`` and ``constraint_step``, from a
  JAX state loaded at step 0 or after two steps
  (``convert.state_from_jax``): params, moments and distances within atol
  2e-5 / rtol 1e-4, the whole-kernel tolerance of
  ``tests/test_fused_step.py`` (fp32 sums in another order, three steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import api as japi
from repro.core import quartic as jquartic
from repro.kernels import landing_field as jlf
from repro.kernels import ops as jops
from repro.kernels import pogo_update as jpu
from repro.kernels import ref as jref
from repro_torch import optim as topt
from repro_torch import tree
from repro_torch.convert import state_from_jax
from repro_torch.core import api as tapi
from repro_torch.core import quartic as tquartic
from repro_torch.kernels import landing_field as tlf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pogo_update as tpu
from repro_torch.kernels import ref as tref

KERNEL_TOL = dict(atol=1e-6, rtol=1e-6)
TILED_TOL = dict(atol=2e-5, rtol=1e-4)
STEP_TOL = dict(atol=2e-5, rtol=1e-4)
BASE_TOL = dict(atol=1e-6, rtol=1e-5)

SHAPES = [(1, 3, 3), (4, 16, 32), (1, 5, 40), (2, 10, 250), (3, 16, 256)]


def _xg(shape, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2)
    g = scale * rng.standard_normal(shape)
    return np.ascontiguousarray(x, np.float32), g.astype(np.float32)


# ------------------------------------------------------- kernels' plain versions


@pytest.mark.parametrize("shape", SHAPES)
def test_pogo_update_plain_matches_jax_kernel(shape):
    x, g = _xg(shape)
    want = np.asarray(jops.pogo_update(jnp.asarray(x), jnp.asarray(g), 0.1, 0.5))
    got = tops.pogo_update(torch.from_numpy(x), torch.from_numpy(g), 0.1, 0.5)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    oracle = np.asarray(jref.pogo_update_ref(jnp.asarray(x), jnp.asarray(g), 0.1, 0.5))
    np.testing.assert_allclose(
        tref.pogo_update_ref(torch.from_numpy(x), torch.from_numpy(g), 0.1, 0.5).numpy(),
        oracle, **KERNEL_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_landing_field_plain_matches_jax_kernel(shape):
    x, g = _xg(shape, seed=1)
    x = x + 0.01 * np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jops.landing_field(jnp.asarray(x), jnp.asarray(g), 1.0))
    got = tops.landing_field(torch.from_numpy(x), torch.from_numpy(g), 1.0)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("shape,tile_n", [((2, 8, 512), 128), ((1, 16, 256), 128),
                                          ((3, 5, 768), 256)])
def test_plain_versions_match_jax_tiled_kernels(shape, tile_n):
    x, g = _xg(shape, seed=3)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    want = np.asarray(jpu.pogo_update_tiled(jx, jg, 0.1, 0.5, tile_n=tile_n,
                                            interpret=True))
    np.testing.assert_allclose(tops.pogo_update(tx, tg, 0.1, 0.5).numpy(), want,
                               **TILED_TOL)
    want = np.asarray(jlf.landing_field_tiled(jx, jg, 1.0, tile_n=tile_n,
                                              interpret=True))
    np.testing.assert_allclose(tops.landing_field(tx, tg, 1.0).numpy(), want,
                               **TILED_TOL)


@pytest.mark.parametrize("shape", [(2, 128, 160), (1, 128, 256)])
def test_plain_versions_match_jax_at_p128(shape):
    """internlm2-1.8b's p = 128, where the port's planner gives POGO the
    16-column tile: JAX's ``ops.pogo_update`` / ``ops.landing_field`` (the
    Pallas kernels in interpret mode) against the port's entry points on
    the CPU, at the whole-kernel tolerance (atol 1e-6; the differences
    read ~2e-7)."""
    x, g = _xg(shape, seed=7)
    x = x + 0.01 * np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    np.testing.assert_allclose(tops.pogo_update(tx, tg, 0.1, 0.5).numpy(),
                               np.asarray(jops.pogo_update(jx, jg, 0.1, 0.5)), **KERNEL_TOL)
    np.testing.assert_allclose(tops.landing_field(tx, tg, 1.0).numpy(),
                               np.asarray(jops.landing_field(jx, jg, 1.0)), **KERNEL_TOL)


def test_manifold_distance_ref_matches_jax():
    x, g = _xg((3, 6, 40), seed=4)
    y = x + 0.05 * g
    want = np.asarray(jref.manifold_distance_ref(jnp.asarray(y)))
    got = tref.manifold_distance_ref(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("wrapper", [tpu.pogo_update_whole, tpu.pogo_update_tiled,
                                     tpu.pogo_update_cluster, tpu.pogo_update_tiled_tc,
                                     tpu.pogo_update_tiled_tc128])
def test_pogo_update_wrappers_write_in_place_on_cpu(wrapper):
    x, g = (torch.from_numpy(a) for a in _xg((2, 6, 50), seed=5))
    want = tref.pogo_update_ref(x, g, 0.1, 0.5)
    before = wrapper.launches
    out = wrapper(x, g, 0.1, 0.5, inplace=True)
    assert out is x and wrapper.launches == before  # the CPU runs no kernel
    torch.testing.assert_close(x, want, atol=0, rtol=0)


def test_landing_field_wrappers_run_the_plain_version_on_cpu():
    x, g = (torch.from_numpy(a) for a in _xg((2, 6, 50), seed=6))
    want = tref.landing_field_ref(x, g, 1.0)
    for wrapper in (tlf.landing_field, tlf.landing_field_tiled, tlf.landing_field_cluster,
                    tlf.landing_field_tiled_tc):
        before = wrapper.launches
        torch.testing.assert_close(wrapper(x, g, 1.0), want, atol=0, rtol=0)
        assert wrapper.launches == before


@pytest.mark.parametrize("p,n,pogo,landing", [
    (16, 256, ("whole", 0), ("whole", 0)),
    (64, 960, ("tc", 0), ("tc", 0)),
    (120, 4096, ("tc", 0), ("tc", 0)),
    (128, 2048, ("tc", 0), ("tc", 0)),
    (24, 4096, ("cluster", 0), ("cluster", 0)),
    (28, 2048, ("tiled", 64), ("tc", 0)),
    (10, 9998, ("tiled", 64), ("tiled", 64)),
    (24, 10000, ("tiled", 64), ("tiled", 64)),
    (32, 2048, ("tc", 0), ("tc", 0)),
    (32, 8192, ("tc", 0), ("tc", 0)),
])
def test_two_stage_planners(p, n, pogo, landing):
    """Whole when a matrix fits one block; else the cluster kernel up to
    p = 24 where a thread block cluster holds the matrix and n % 4 == 0
    (not (10, 9998), nor (24, 10000), whose slices outgrow a cluster of 8);
    else the tensor-core entries from p = 29 (POGO) or 25 (the field) to
    128 (the wide kernel above 64, for internlm2-1.8b's (128, 2048)); else
    the tile that lets the most blocks share an SM, the widest of those."""
    assert tops.plan_pogo_update(p, n) == pogo
    assert tops.plan_landing_field(p, n) == landing
    for kind, whole, tiled in ((pogo, tops.pogo_whole_smem_bytes,
                                tops.pogo_tiled_smem_bytes),
                               (landing, tops.landing_whole_smem_bytes,
                                tops.landing_tiled_smem_bytes)):
        if kind[0] == "whole":
            assert whole(p, n) <= tops.SMEM_LIMIT_BYTES
        elif kind[0] == "cluster":
            assert whole(p, n) > tops.SMEM_LIMIT_BYTES
            assert p <= tops.CLUSTER_MAX_P and tops.small_p_cluster(p, n)
        elif kind[0] == "tc":
            assert whole(p, n) > tops.SMEM_LIMIT_BYTES
            assert tops.tc_smem_bytes(p) <= tops.SMEM_LIMIT_BYTES
        else:
            assert whole(p, n) > tops.SMEM_LIMIT_BYTES
            assert tiled(p, kind[1]) <= tops.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("pogo", [True, False], ids=["pogo_update", "landing_field"])
def test_two_stage_planners_keep_their_plans_outside_the_tc_range(pogo):
    """Every (p, n) that planned whole or a 64- or 32-column tile before
    the tensor-core route and the 16-column tile keeps that plan outside
    the tensor-core range up to p = 128; the 16-column tile appears only
    where the old planner raised, and so may the tensor-core route, for
    POGO's wide kernel (p = 128, where the old planner's 32-column tile did
    not fit); past p = 128 every plan but whole is the large route, which
    beat the field's CUDA-core tiled kernel on the card at 136 and 160
    (the readings in ``ops.py``): on the tensor cores where n % 4 == 0,
    on the CUDA cores elsewhere (``ops.large_kind``). The cluster kernel
    (``csrc/small_p.cu``) takes over a tiled plan, and only that,
    where a cluster holds the matrix, p <= ``CLUSTER_MAX_P`` and n % 4 ==
    0; the batched kernel (``csrc/batched_whole.cu``) takes over POGO's
    whole plan, and only that, at p <= n <= ``BATCHED_MAX_N``."""
    whole = tops.pogo_whole_smem_bytes if pogo else tops.landing_whole_smem_bytes
    tiled = tops.pogo_tiled_smem_bytes if pogo else tops.landing_tiled_smem_bytes
    plan = tops.plan_pogo_update if pogo else tops.plan_landing_field
    low = tops.TC_MIN_P if pogo else tops.LANDING_FIELD_TC_MIN_P
    high = tops.TC_MAX_P
    moved = clustered = batched = 0
    for p in range(1, 161):
        for n in (4, 16, 100, 256, 960, 2048, 4096, 8192):
            try:
                old = tops._plan("old", p, n, whole, tiled)
            except ValueError:
                old = None
            try:
                new = plan(p, n)
            except ValueError:
                new = None
            if new == ("batched", 0):
                assert pogo and old == ("whole", 0), (p, n, old)
                assert p <= n <= tops.BATCHED_MAX_N
                batched += 1
            elif new == ("cluster", 0):
                assert old is not None and old[0] == "tiled", (p, n, old)
                assert p <= tops.CLUSTER_MAX_P and n % 4 == 0
                assert tops.small_p_cluster(p, n) > 0
                clustered += 1
            elif new == ("tc", 0):
                assert low <= p <= high and (old is not None or (pogo and p > 64))
                moved += 1
            elif p > high:
                assert new == old if old == ("whole", 0) else new == (tops.large_kind(n), 0), \
                    (p, n)
            elif old is None:
                assert new in (None, ("tiled", 16)), (p, n, new)
                assert new is None or tiled(p, 32) > tops.SMEM_LIMIT_BYTES
            else:
                assert new == old, (p, n, old, new)
    assert moved > 0
    assert clustered > 0
    assert (batched > 0) == pogo
    assert plan(128, 2048) == ("tc", 0)
    # the CUDA-core kernel's tile there, which the card times beside it
    assert tops.two_stage_tile_n(128, tiled) == (16 if pogo else 64)
    assert tiled(128, 16 if pogo else 64) <= tops.SMEM_LIMIT_BYTES


def test_landing_field_keeps_its_cuda_core_tile_at_p128():
    """internlm2-1.8b's (128, 2048) plans the field's wide tensor-core entry,
    as it plans POGO's update and the fused step; the CUDA-core kernel,
    which the card times beside it, keeps its 64-column tile there; p past
    128 takes the large route (on the tensor cores at n % 4 == 0), which
    beat the CUDA-core kernel on the card at 136 and 160 (the readings in
    ``ops.py``)."""
    assert tops.plan_landing_field(128, 2048) == tops.plan_pogo_update(128, 2048) == \
        tops.plan(128, 2048) == ("tc", 0)
    assert tops.TC_MAX_P == 128
    assert tops.two_stage_tile_n(128, tops.landing_tiled_smem_bytes) == 64
    assert tops.plan_landing_field(130, 2048) == ("large_tc", 0)
    assert tops.plan_landing_field(130, 2049) == ("large", 0)


def test_two_stage_planners_raise_for_large_p():
    """Where they raised before, the planners now give the large route
    (``csrc/large_p.cu``): its tensor-core kernels at n % 4 == 0, its
    CUDA-core ones elsewhere."""
    assert tops.plan_pogo_update(256, 4096) == ("large_tc", 0)
    assert tops.plan_landing_field(300, 4096) == ("large_tc", 0)
    assert tops.plan_pogo_update(256, 4097) == ("large", 0)
    assert tops.plan_landing_field(300, 4098) == ("large", 0)


# ----------------------------------------------------------- quartic, safe step


def test_solve_quartic_matches_jax():
    rng = np.random.default_rng(7)
    coef = rng.standard_normal((5, 64)).astype(np.float32)
    coef[0] = np.abs(coef[0]) + 0.1
    coef[3, :4] = 0.0  # a few biquadratic cases
    want = np.asarray(jquartic.solve_quartic(*(jnp.asarray(c) for c in coef)))
    got = tquartic.solve_quartic(*(torch.from_numpy(c) for c in coef)).numpy()
    assert got.shape == want.shape == (64, 4)
    for gr, wr in zip(got, want):
        for root in gr:
            err = np.min(np.abs(wr - root)) / (1 + np.abs(root))
            assert err < 1e-3, (root, wr)


def test_solve_cubic_matches_jax():
    rng = np.random.default_rng(8)
    coef = rng.standard_normal((4, 32)).astype(np.float32)
    want = np.asarray(jquartic.solve_cubic(*(jnp.asarray(c) for c in coef)))
    got = tquartic.solve_cubic(*(torch.from_numpy(c) for c in coef)).numpy()
    for gr, wr in zip(got, want):
        for root in gr:
            assert np.min(np.abs(wr - root)) / (1 + np.abs(root)) < 1e-3


@pytest.mark.parametrize("eps,scale", [(0.5, 0.2), (0.05, 1.0), (0.02, 3.0)])
def test_safe_eta_matches_jax(eps, scale):
    """Binding and non-binding steps, and matrices already outside the
    eps-ball (the 0.02 case starts from a 1e-2 perturbation)."""
    x, d = _xg((16, 6, 40), seed=9, scale=scale)
    x = x + 0.01 * np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(japi._safe_eta(jnp.asarray(x), jnp.asarray(d), 0.25, eps))
    got = tapi._safe_eta(torch.from_numpy(x), torch.from_numpy(d), 0.25, eps).numpy()
    assert want.shape == got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)
    if scale >= 1.0:
        assert np.any(got < 0.25)  # the safe step binds somewhere


# ------------------------------------------------------------- base optimizers


BASES = {
    "scale_by_adam": (lambda: jopt.scale_by_adam(), lambda: topt.scale_by_adam()),
    "adam": (lambda: jopt.adam(0.3, b1=0.8), lambda: topt.adam(0.3, b1=0.8)),
    "adamw": (lambda: jopt.adamw(0.3, weight_decay=0.1),
              lambda: topt.adamw(0.3, weight_decay=0.1)),
    "sgd": (lambda: jopt.sgd(0.5), lambda: topt.sgd(0.5)),
    "sgd_momentum": (lambda: jopt.sgd(0.5, momentum=0.9, nesterov=True),
                     lambda: topt.sgd(0.5, momentum=0.9, nesterov=True)),
    "schedule": (lambda: jopt.sgd(lambda c: 0.1 / (1.0 + c)),
                 lambda: topt.sgd(lambda c: 0.1 / (1.0 + c))),
}


@pytest.mark.parametrize("name", sorted(BASES))
def test_base_optimizers_match_jax(name):
    make_j, make_t = BASES[name]
    bj, bt = make_j(), make_t()
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((3, 4, 6)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sj, st = bj.init(pj), bt.init(pt)
    for step in range(4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        uj, sj = bj.update(jax.tree.map(jnp.asarray, grads), sj, pj)
        ut, st = bt.update({k: torch.from_numpy(v) for k, v in grads.items()}, st, pt)
        for k in params:
            np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]),
                                       err_msg=f"{name}/{step}/{k}", **BASE_TOL)
        lj, lt = jax.tree.leaves(sj), tree.leaves(st)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **BASE_TOL)


@pytest.mark.parametrize("make", [
    lambda: topt.scale_by_adam(), lambda: topt.adamw(0.1),
    lambda: topt.chain(topt.trace(0.7, nesterov=True)), lambda: topt.scale_by_vadam(),
])
def test_update_inplace_equals_update(make):
    """Same bits; the in-place form overwrites the old moments and hands
    the same tensors back."""
    t = make()
    rng = np.random.default_rng(12)
    p = {"w": torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))}
    s_a, s_b = t.init(p), t.init(p)
    for _ in range(3):
        g = {"w": torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))}
        old_a = [x.clone() for x in tree.leaves(s_a)]
        u_a, s_a2 = t.update(g, s_a, p)
        for x, y in zip(tree.leaves(s_a), old_a):  # update never writes its input
            torch.testing.assert_close(x, y, atol=0, rtol=0)
        s_a = s_a2
        moments_b = [x for x in tree.leaves(s_b) if x.dim() > 0]
        u_b, s_b = t.update_inplace(g, s_b, p)
        assert all(x is y for x, y in zip(moments_b,
                                          [x for x in tree.leaves(s_b) if x.dim() > 0]))
        torch.testing.assert_close(u_b["w"], u_a["w"], atol=0, rtol=0)
        for x, y in zip(tree.leaves(s_a), tree.leaves(s_b)):
            torch.testing.assert_close(y, x, atol=0, rtol=0)


# -------------------------------------------------------------- the whole slice


# Two wide leaves of one shape (one group of 5), a tall leaf (transposed
# into its own group) and a second wide shape.
TREE = {"a": (3, 4, 24), "b": (30, 6), "c": (2, 4, 24), "d": (5, 40)}
LR = 0.1


def _near_stiefel(shape, rng):
    *lead, p, n = shape
    tall = p > n
    if tall:
        p, n = n, p
    q, _ = np.linalg.qr(rng.standard_normal((*lead, n, p)))
    x = np.swapaxes(q, -1, -2) + 1e-3 * rng.standard_normal((*lead, p, n))
    if tall:
        x = np.swapaxes(x, -1, -2)
    return x.astype(np.float32)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: _near_stiefel(s, rng) for k, s in TREE.items()}


def _grads(step, scale=0.3):
    rng = np.random.default_rng(100 + step)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in TREE.items()}


# (method, method kwargs, learning rate, JAX base, port base, grad scale)
SLICE = {
    "pogo_adam": ("pogo", {}, 0.01, lambda: jopt.scale_by_adam(),
                  lambda: topt.scale_by_adam(), 0.3),
    "pogo_adam_chain": ("pogo", {}, 0.01, lambda: jopt.chain(jopt.scale_by_adam()),
                        lambda: topt.chain(topt.scale_by_adam()), 0.3),
    "pogo_adamw_schedule": ("pogo", {}, lambda c: 0.02 / (1.0 + c),
                            lambda: jopt.adamw(1.0, weight_decay=0.1),
                            lambda: topt.adamw(1.0, weight_decay=0.1), 0.3),
    "landing_paper": ("landing", {}, 0.25, lambda: jopt.chain(jopt.trace(0.1)),
                      lambda: topt.chain(topt.trace(0.1)), 0.3),
    "landing_adam": ("landing", {"lam": 0.5}, 0.01, lambda: jopt.scale_by_adam(),
                     lambda: topt.scale_by_adam(), 0.3),
    "landing_fixed_step": ("landing", {"safe_step": False}, 0.05,
                           lambda: jopt.scale_by_adam(),
                           lambda: topt.scale_by_adam(), 0.3),
    "pogo_none": ("pogo", {}, LR, lambda: None, lambda: None, 0.3),
}


def _jax_arrays(cs, state):
    return {
        "stacks": [np.asarray(s) for s in cs.stacks],
        "count": np.asarray(state.count),
        "last_distance": [np.asarray(d) for d in state.last_distance.per_group],
        "base_state": [np.asarray(a) for a in jax.tree.leaves(state.base_state)],
    }


def _assert_same(cs_j, st_j, cs_t, st_t, label):
    want = _jax_arrays(cs_j, st_j)
    for a, b in zip(want["stacks"], cs_t.stacks):
        np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/x", **STEP_TOL)
    for a, b in zip(want["last_distance"], st_t.last_distance.per_group):
        np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/dist", **STEP_TOL)
    got = tree.leaves(st_t.base_state)
    assert len(got) == len(want["base_state"])
    for a, b in zip(want["base_state"], got):
        np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/base", **STEP_TOL)
    assert int(st_t.count) == int(st_j.count)


def _opts(case, use_kernel):
    method, kw, lr, make_j, make_t, gscale = SLICE[case]
    opt_j = japi.orthogonal(method, learning_rate=lr, use_kernel=use_kernel,
                            base_optimizer=make_j(), **kw)
    opt_t = tapi.orthogonal(method, learning_rate=lr, use_kernel=use_kernel,
                            base_optimizer=make_t(), **kw)
    return opt_j, opt_t, make_t, gscale


@pytest.mark.parametrize("convert_at", [0, 2])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", sorted(SLICE))
def test_constraint_step_matches_jax(case, use_kernel, convert_at):
    """Three ``constraint_step``s in both packages; the port starts from
    the JAX state at step ``convert_at`` (after two steps: the state the
    port loads has Adam's or the trace's moments and counts in it)."""
    opt_j, opt_t, make_t, gscale = _opts(case, use_kernel)
    params = _params()
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    st_j = opt_j.init(cs_j)
    step_j, step_t = japi.constraint_step(opt_j), tapi.constraint_step(opt_t)
    cs_t = st_t = None
    for step in range(3):
        if step == convert_at:
            cs_t, st_t = state_from_jax(params, _jax_arrays(cs_j, st_j),
                                        make_t(), device="cpu")
        grads = _grads(step, gscale)
        cs_j, st_j, h_j = step_j(
            cs_j, st_j, japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, grads)))
        if cs_t is None:
            continue
        stacks_before = list(cs_t.stacks)
        moments_before = [a for a in tree.leaves(st_t.base_state) if a.dim() > 0]
        cs_t2, st_t, h_t = step_t(cs_t, st_t,
                                  tapi.ConstraintSet.from_tree(grads, device="cpu"))
        assert cs_t2 is cs_t  # in place: same set, same stack tensors
        assert all(a is b for a, b in zip(stacks_before, cs_t.stacks))
        assert all(a is b for a, b in zip(
            moments_before, [a for a in tree.leaves(st_t.base_state) if a.dim() > 0]))
        _assert_same(cs_j, st_j, cs_t, st_t, f"{case}/{use_kernel}/{step}")
        assert bool(h_t.finite) and bool(h_j.finite)
        np.testing.assert_allclose(float(h_t.residual), float(h_j.residual), **STEP_TOL)


@pytest.mark.parametrize("case", ["pogo_adam", "landing_paper", "landing_adam"])
def test_tree_update_matches_jax(case):
    """The out-of-place ``update`` on a plain tree (gather, tall transpose,
    scatter) gives the same updates and per-leaf distances as JAX."""
    opt_j, opt_t, _, gscale = _opts(case, True)
    params = _params(1)
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st_j, st_t = opt_j.init(pj), opt_t.init(pt)
    for step in range(3):
        grads = _grads(step, gscale)
        uj, st_j = opt_j.update(jax.tree.map(jnp.asarray, grads), st_j, pj)
        ut, st_t = opt_t.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                st_t, pt)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = {k: pt[k] + ut[k] for k in pt}
        for k in params:
            assert tuple(ut[k].shape) == TREE[k]
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       err_msg=f"{case}/{k}", **STEP_TOL)
        dj, dt = japi.leaf_distances(st_j), tapi.leaf_distances(st_t)
        for k in params:
            np.testing.assert_allclose(float(dt[k]), float(dj[k]), **STEP_TOL)


@pytest.mark.parametrize("case", ["pogo_adam", "landing_paper", "pogo_none"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_stage_in_place_equals_out_of_place(case, use_kernel):
    _, opt, _, gscale = _opts(case, use_kernel)
    params, grads = _params(2), _grads(0, gscale)
    cs_a = tapi.ConstraintSet.from_tree(params, device="cpu")
    cs_b = tapi.ConstraintSet.from_tree(params, device="cpu")
    gs = tapi.ConstraintSet.from_tree(grads, device="cpu")
    st_a, st_b = opt.init(cs_a), opt.init(cs_b)
    for _ in range(2):
        upd, st_a = opt.update(gs, st_a, cs_a)
        cs_a = cs_a.apply(upd)
        cs_b, st_b, _ = tapi.constraint_step(opt)(cs_b, st_b, gs)
    for a, b in zip(cs_a.stacks, cs_b.stacks):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    for a, b in zip(st_a.last_distance.per_group, st_b.last_distance.per_group):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    for x, y in zip(tree.leaves(st_a.base_state), tree.leaves(st_b.base_state)):
        torch.testing.assert_close(y, x, atol=0, rtol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_binding_safe_step_matches_jax(use_kernel):
    """One Landing step whose exact safe step binds (eps 0.02, large
    gradients): eta, hence X', matches JAX and every matrix lands on the
    eps-sphere. One step only: from the sphere, the next step's
    "already violating" test (``a0 > 0``) compares two numbers equal to
    rounding, so the packages may legitimately take different branches."""
    kw = dict(learning_rate=0.25, use_kernel=use_kernel, eps=0.02)
    opt_j = japi.orthogonal("landing", base_optimizer=jopt.chain(jopt.trace(0.1)), **kw)
    opt_t = tapi.orthogonal("landing", base_optimizer=topt.chain(topt.trace(0.1)), **kw)
    params, grads = _params(4), _grads(0, 3.0)
    pj = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    pt = tapi.ConstraintSet.from_tree(params, device="cpu")
    uj, sj = opt_j.update(japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, grads)),
                          opt_j.init(pj), pj)
    ut, st = opt_t.update(tapi.ConstraintSet.from_tree(grads, device="cpu"),
                          opt_t.init(pt), pt)
    for a, b in zip(uj.stacks, ut.stacks):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **STEP_TOL)
    for a, b in zip(sj.last_distance.per_group, st.last_distance.per_group):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **STEP_TOL)
        np.testing.assert_allclose(b.numpy(), 0.02, rtol=1e-4)


def test_paper_landing_keeps_inside_its_eps_ball():
    """The safe step holds every matrix within eps of the manifold, even
    under gradients large enough to leave it in one fixed step."""
    opt = tapi.orthogonal("landing", learning_rate=0.25, use_kernel=True,
                          base_optimizer=topt.chain(topt.trace(0.1)), eps=0.05)
    cs = tapi.ConstraintSet.from_tree(_params(3), device="cpu")
    st = opt.init(cs)
    step = tapi.constraint_step(opt)
    for i in range(5):
        cs, st, health = step(cs, st, tapi.ConstraintSet.from_tree(_grads(i, 5.0),
                                                                   device="cpu"))
        assert bool(health.finite)
        assert float(tapi.max_distance(st)) <= 0.05 + 1e-6


@pytest.mark.parametrize("base,fused", [
    (None, True), ("trace", True), ("sgd", True), ("adam", False),
])
def test_fixed_step_landing_routes(base, fused, monkeypatch):
    """Fixed-step Landing (``safe_step=False``) with ``use_kernel=True``
    takes the fused group step over a base the kernel replays (none,
    ``trace``; ``sgd`` is ``scale(-lr)`` without momentum) and the
    two-stage step over an opaque one (Adam). The fused route's numerics
    are held against JAX in ``tests/test_torch_landing_fused.py``."""
    from repro_torch.kernels import ops as tops

    bases = {None: None, "trace": topt.chain(topt.trace(0.1)),
             "sgd": topt.sgd(0.5), "adam": topt.scale_by_adam()}
    calls = []
    real = tops.fused_group_step
    monkeypatch.setattr(tops, "fused_group_step",
                        lambda *a, **k: calls.append(k["method"]) or real(*a, **k))
    opt = tapi.orthogonal("landing", learning_rate=0.05, use_kernel=True,
                          safe_step=False, base_optimizer=bases[base])
    params = _params()
    cs = tapi.ConstraintSet.from_tree(params, device="cpu")
    st = opt.init(cs)
    cs, st, health = tapi.constraint_step(opt)(
        cs, st, tapi.ConstraintSet.from_tree(_grads(0, 1.0), device="cpu"))
    assert bool(health.finite)
    assert calls == (["landing"] * len(cs.stacks) if fused else [])


def test_complex_groups_are_refused():
    opt = tapi.orthogonal("landing", learning_rate=0.1)
    x = {"w": torch.eye(3, 5, dtype=torch.complex64)}
    with pytest.raises(NotImplementedError, match="remaining methods"):
        opt.update(x, opt.init(x), x)


@pytest.mark.parametrize("lr,feasible", [(0.1, False), (1e-3, True)])
def test_pogo_adam_step_size_at_smollm_width(lr, feasible):
    """POGO over Adam at SmolLM's (64, 960): Adam's output has unit scale
    per entry, so ``||G||_F ~ sqrt(p n) ~ 250`` and lr 0.1 leaves the
    paper's stable regime (``eta ||G|| < 1``): both packages blow up
    within three steps. At lr 1e-3, the rate ``chip_smoke.py`` drives it
    at, both stay within 1e-5 of the manifold."""
    rng = np.random.default_rng(13)
    q, _ = np.linalg.qr(rng.standard_normal((1, 960, 64)))
    x0 = np.ascontiguousarray(np.swapaxes(q, -1, -2), np.float32)
    grads = [(5e-4 * rng.standard_normal((1, 64, 960))).astype(np.float32)
             for _ in range(3)]
    opt_j = japi.orthogonal("pogo", learning_rate=lr,
                            base_optimizer=jopt.chain(jopt.scale_by_adam()))
    opt_t = tapi.orthogonal("pogo", learning_rate=lr, use_kernel=True,
                            base_optimizer=topt.chain(topt.scale_by_adam()))
    cs_j = japi.ConstraintSet.from_tree({"w": jnp.array(x0)})
    cs_t = tapi.ConstraintSet.from_tree({"w": x0}, device="cpu")
    st_j, st_t = opt_j.init(cs_j), opt_t.init(cs_t)
    step_j, step_t = japi.constraint_step(opt_j), tapi.constraint_step(opt_t)
    with np.errstate(all="ignore"):
        for g in grads:
            cs_j, st_j, _ = step_j(cs_j, st_j, japi.ConstraintSet.from_tree(
                {"w": jnp.asarray(g)}))
            cs_t, st_t, _ = step_t(cs_t, st_t, tapi.ConstraintSet.from_tree(
                {"w": g}, device="cpu"))
    for dist in (float(japi.max_distance(st_j)), float(tapi.max_distance(st_t))):
        assert (dist <= 1e-5) == feasible, dist
