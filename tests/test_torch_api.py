"""Parity of the port's orthoptimizer with the JAX package, on the CPU.

``orthogonal("pogo", use_kernel=True, base_optimizer=...)`` +
``constraint_step`` run three steps in both packages on a small tree of
wide and tall leaves, from the same state (``convert.state_from_jax``) and
the same numpy gradients. Stacks, mu, nu and distances are compared with
atol 2e-5 / rtol 1e-4, the whole-kernel tolerance of
``tests/test_fused_step.py`` (fp32 sums in another order, three steps).
Also: the in-place step against the out-of-place one, the planner's
choices and limits, and the refusals of what this slice does not port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import smollm_360m as jsmollm
from repro.core import api as japi
from repro.models import ortho as jortho
from repro.models import transformer as jtransformer
from repro.optim import fused as jfused
from repro_torch import optim as topt
from repro_torch import tree
from repro_torch.configs import smollm_360m as tsmollm
from repro_torch.convert import state_from_jax
from repro_torch.core import api as tapi
from repro_torch.kernels import ops as tops
from repro_torch.models import ortho as tortho

TOL = dict(atol=2e-5, rtol=1e-4)
LR = 0.1

# Two wide leaves of one shape (one group of 5), a tall leaf (transposed
# into its own group) and a second wide shape.
SHAPES = {"a": (3, 4, 24), "b": (30, 6), "c": (2, 4, 24), "d": (5, 40)}


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
    return {k: _near_stiefel(s, rng) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


BASES = {
    "trace": (lambda: jopt.chain(jopt.trace(0.9)), lambda: topt.chain(topt.trace(0.9))),
    "nesterov": (lambda: jopt.trace(0.8, nesterov=True),
                 lambda: topt.trace(0.8, nesterov=True)),
    "vadam": (lambda: jopt.chain(jopt.scale_by_vadam(0.9, 0.999, 1e-8), jopt.scale(2.0)),
              lambda: topt.chain(topt.scale_by_vadam(0.9, 0.999, 1e-8), topt.scale(2.0))),
    "none": (lambda: None, lambda: None),
}


def _jax_arrays(cs, state, base):
    fb = jfused.resolve_fused_base(base)
    mu, nu, bcount = fb.get_slots(state.base_state)
    return {
        "stacks": [np.asarray(s) for s in cs.stacks],
        "count": np.asarray(state.count),
        "last_distance": [np.asarray(d) for d in state.last_distance.per_group],
        "mu": None if mu is None else [np.asarray(s) for s in mu.stacks],
        "nu": None if nu is None else [np.asarray(s) for s in nu.stacks],
        "base_count": None if bcount is None else np.asarray(bcount),
        "base_state": [np.asarray(a) for a in jax.tree.leaves(state.base_state)],
    }


def _port_slots(state, base):
    mu, nu, bcount = topt.resolve_fused_base(base).get_slots(state.base_state)
    return mu, nu, bcount


def _assert_same_state(cs_j, st_j, base_j, cs_t, st_t, base_t, label):
    want = _jax_arrays(cs_j, st_j, base_j)
    for a, b in zip(want["stacks"], cs_t.stacks):
        np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/x", **TOL)
    for a, b in zip(want["last_distance"], st_t.last_distance.per_group):
        np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/dist", **TOL)
    mu, nu, bcount = _port_slots(st_t, base_t)
    if want["mu"] is not None:
        for a, b in zip(want["mu"], mu.stacks):
            np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/mu", **TOL)
    if want["nu"] is not None:
        for a, b in zip(want["nu"], nu.stacks):
            np.testing.assert_allclose(b.numpy(), a, err_msg=f"{label}/nu", **TOL)
    if want["base_count"] is not None:
        assert int(bcount) == int(want["base_count"])
    assert int(st_t.count) == int(st_j.count)


@pytest.mark.parametrize("convert_at", [0, 2])
@pytest.mark.parametrize("base", sorted(BASES))
def test_constraint_step_matches_jax(base, convert_at):
    make_j, make_t = BASES[base]
    base_j, base_t = make_j(), make_t()
    params = _params()
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    opt_j = japi.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                            base_optimizer=base_j)
    opt_t = tapi.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                            base_optimizer=base_t)
    st_j = opt_j.init(cs_j)
    step_j = japi.constraint_step(opt_j)
    step_t = tapi.constraint_step(opt_t)
    cs_t = st_t = None
    for step in range(3):
        if step == convert_at:
            cs_t, st_t = state_from_jax(params, _jax_arrays(cs_j, st_j, base_j),
                                        base_t, device="cpu")
        grads = _grads(step)
        cs_j, st_j, h_j = step_j(
            cs_j, st_j,
            japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, grads)),
        )
        if cs_t is None:
            continue
        stacks_before = [s for s in cs_t.stacks]
        cs_t2, st_t, h_t = step_t(
            cs_t, st_t, tapi.ConstraintSet.from_tree(grads, device="cpu")
        )
        assert cs_t2 is cs_t  # in place: same set, same stack tensors
        assert all(a is b for a, b in zip(stacks_before, cs_t.stacks))
        _assert_same_state(cs_j, st_j, base_j, cs_t, st_t, base_t, f"{base}/{step}")
        assert bool(h_t.finite) and bool(h_j.finite)
        np.testing.assert_allclose(float(h_t.residual), float(h_j.residual), **TOL)
    np.testing.assert_allclose(float(tapi.max_distance(st_t)),
                               float(japi.max_distance(st_j)), **TOL)


@pytest.mark.parametrize("base", ["trace", "vadam"])
def test_tree_update_matches_jax(base):
    """The out-of-place ``update`` on a plain tree (gather, tall transpose,
    scatter) gives the same updates and per-leaf distances as JAX."""
    make_j, make_t = BASES[base]
    base_j, base_t = make_j(), make_t()
    params = _params(1)
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt_j = japi.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                            base_optimizer=base_j)
    opt_t = tapi.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                            base_optimizer=base_t)
    st_j, st_t = opt_j.init(pj), opt_t.init(pt)
    for step in range(2):
        grads = _grads(step)
        uj, st_j = opt_j.update(jax.tree.map(jnp.asarray, grads), st_j, pj)
        ut, st_t = opt_t.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                st_t, pt)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = {k: pt[k] + ut[k] for k in pt}
        for k in params:
            assert tuple(ut[k].shape) == SHAPES[k]
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       err_msg=f"{base}/{k}", **TOL)
        dj, dt = japi.leaf_distances(st_j), tapi.leaf_distances(st_t)
        for k in params:
            np.testing.assert_allclose(float(dt[k]), float(dj[k]), **TOL)


@pytest.mark.parametrize("base", ["trace", "vadam", "none"])
def test_inplace_step_equals_out_of_place(base):
    _, make_t = BASES[base]
    base_t = make_t()
    opt = tapi.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                          base_optimizer=base_t)
    params, grads = _params(2), _grads(0)
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
    sa, sb = _port_slots(st_a, base_t), _port_slots(st_b, base_t)
    for x, y in zip(tree.leaves(sa), tree.leaves(sb)):
        torch.testing.assert_close(y, x, atol=0, rtol=0)


def test_constraint_set_round_trips_and_matches_jax_plan():
    params = _params(3)
    cs_t = tapi.ConstraintSet.from_tree(params, device="cpu")
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    assert [(g.p, g.n, g.batch) for g in cs_t.plan.groups] == \
        [(g.p, g.n, g.batch) for g in cs_j.plan.groups]
    for a, b in zip(cs_j.stacks, cs_t.stacks):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = cs_t.to_tree()
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_per_leaf_grouping_matches_jax_plan():
    params = _params(4)
    leaves_t, td = tree.flatten({k: torch.from_numpy(v) for k, v in params.items()})
    plan_t = tapi.plan_groups(leaves_t, td, "per_leaf")
    leaves_j, tdj = jax.tree.flatten(jax.tree.map(jnp.asarray, params))
    plan_j = japi.plan_groups(leaves_j, tdj, "per_leaf")
    assert [(g.p, g.n, g.batch) for g in plan_t.groups] == \
        [(g.p, g.n, g.batch) for g in plan_j.groups]


def test_smollm_leaf_shapes_match_the_jax_model():
    cfg_j = jsmollm.config()
    sds = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg_j),
                         jax.random.PRNGKey(0))
    want = {path.rsplit("/", 1)[-1]: tuple(shape)
            for path, shape in jortho.orthogonal_leaf_info(sds, cfg_j)}
    got = tortho.orthogonal_leaf_shapes(tsmollm.config())
    assert got == want
    leaves, td = tree.flatten({k: torch.empty(s, device="meta") for k, s in got.items()})
    plan = tapi.plan_groups(leaves, td, "auto")
    assert [(g.batch, g.p, g.n) for g in plan.groups] == [(640, 64, 960)]


@pytest.mark.parametrize("p,n,kind,blocks", [(16, 256, ("whole", 0), None),
                                             (64, 960, ("tc", 0), 1),
                                             (16, 4096, ("cluster", 0), 3),
                                             (10, 9998, ("tiled", 64), 3),
                                             (24, 10000, ("tiled", 64), 3),
                                             (100, 4096, ("tc", 0), 1),
                                             (120, 4096, ("tc", 0), 1),
                                             (128, 2048, ("tc", 0), 1)])
def test_planner_picks_the_kernel(p, n, kind, blocks):
    """Whole when a matrix fits a block; else for p <= 24 the cluster
    kernel where a thread block cluster holds the matrix and n % 4 == 0
    (blocks: its CTAs an SM; (10, 9998) is n % 4 != 0, (24, 10000)
    outgrows a cluster of 8); else the tensor-core kernel for 29 <= p <=
    128 (SmolLM's (64, 960), and the wide kernel for internlm2-1.8b's (128,
    2048); one persistent block a SM); else the CUDA-core tiled kernel with
    the tile that lets the most blocks share an SM, the widest of those."""
    assert tops.plan(p, n) == kind
    if kind[0] == "whole":
        assert tops.whole_smem_bytes(p, n) <= tops.SMEM_LIMIT_BYTES
    elif kind[0] == "cluster":
        c = tops.small_p_cluster(p, n)
        assert p <= tops.CLUSTER_MAX_P and c
        assert tops.SM_SMEM_BYTES // (tops.small_p_smem_bytes(p, n, c) + 1024) == blocks
    elif kind[0] == "tc":
        assert tops.TC_MIN_P <= p <= tops.TC_MAX_P
        assert tops.whole_smem_bytes(p, n) > tops.SMEM_LIMIT_BYTES
        assert tops.tc_smem_bytes(p) <= tops.SMEM_LIMIT_BYTES
        assert tops.SM_SMEM_BYTES // (tops.tc_smem_bytes(p) + 1024) == blocks
    else:
        assert tops.tiled_smem_bytes(p, kind[1]) <= tops.SMEM_LIMIT_BYTES
        assert tops.tiled_blocks_per_sm(p, kind[1]) == blocks


@pytest.mark.parametrize("p,n,kind", [
    (64, 960, "tc"), (1, 100000, "cluster"), (64, 400, "tc"), (65, 960, "tc"),
    (96, 960, "tc"), (64, 300, "whole"), (8, 200, "whole"), (48, 2048, "tc"),
    (32, 2048, "tc"), (31, 2048, "tc"), (24, 2048, "cluster"), (128, 2048, "tc"),
    (28, 2048, "tiled"), (1, 100001, "tiled"),
])
def test_planner_rule_for_the_tensor_core_kernel(p, n, kind):
    """The rule on (p, n): a shape that does not fit one block whole goes
    to the tensor-core kernels exactly when 29 <= p <= 128 (the wide one
    above 64); below that to the cluster kernel up to p = 24 where n % 4
    == 0 and a cluster holds the matrix, else to the CUDA-core tiled
    kernel."""
    assert tops.plan(p, n)[0] == kind


@pytest.mark.parametrize("p,method,kind", [
    (28, "pogo", "tiled"), (29, "pogo", "tc"), (24, "landing", "cluster"),
    (25, "landing", "tc"), (28, "landing", "tc"), (128, "landing", "tc"),
])
def test_planner_lower_end_by_method(p, method, kind):
    """The crossovers read on an H100 at 2048 x (p, 2048): fused POGO takes
    the tensor cores from p = 29, fused Landing from p = 25."""
    assert tops.plan(p, 2048, method)[0] == kind


@pytest.mark.parametrize("p", [65, 72, 96, 100, 127, 128])
def test_wide_tensor_core_block_fits_one_sm(p):
    """The wide kernel's block (64 < p <= 128), whatever p: a ring of six
    128-row x 32-column fp32 boxes (96 KB), 128 KB of (p, p) operands, the
    reduction scratch, 13 mbarriers and 1 KB of alignment, 230,568 bytes,
    within one block's 232,448; the p <= 64 kernel's block is 197,800."""
    assert tops.tc_smem_bytes(p) == 6 * 16384 + 131072 + 64 + 8 * 13 + 1024 == 230568
    assert tops.tc_smem_bytes(p) <= tops.SMEM_LIMIT_BYTES
    assert tops.tc_smem_bytes(p - 64) == 197800
    assert tops.SM_SMEM_BYTES // (tops.tc_smem_bytes(p) + 1024) == 1


def test_planner_raises_for_large_p():
    """p = 256 takes the large route (``csrc/large_p.cu``: the tensor cores'
    kernels at n % 4 == 0, the CUDA cores' otherwise); only the TP schedule
    still refuses it, naming its ROADMAP entry."""
    assert tops.plan(256, 4096) == ("large_tc", 0)
    assert tops.plan(256, 4097) == ("large", 0)
    with pytest.raises(ValueError, match=r"p=256 .*232448.*sharded schedules \(large p\)"):
        tops.plan_tp("tp_apply", 256, tops.tp_apply_smem_bytes)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.ConstraintSet.from_tree(_params())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_jax(_params(), {}, None)


@pytest.mark.parametrize("kwargs,match", [
    (dict(method="landing", use_kernel=True, safe_step=False, tp_compress=True),
     "sharded schedules \\(tp_compress\\)"),
    (dict(method="rgd", use_kernel=True), "remaining methods"),
    (dict(method="landing_pc", use_kernel=False), "remaining methods"),
    (dict(method="rsdm", use_kernel=True), "remaining methods"),
    (dict(method="pogo", use_kernel=True, tp_compress=True), "sharded schedules"),
    (dict(method="pogo", use_kernel=True, grouping="padded"), "ragged megagroups"),
    (dict(method="pogo", use_kernel=True, tp_compress=True,
          watchdog=tapi.WatchdogConfig()), "sharded schedules"),
    (dict(method="slpg", use_kernel=True), "quartic"),
    (dict(method="landing", use_kernel=True, safe_step=False, grouping="padded",
          base_optimizer=topt.chain(topt.trace(0.1))),
     "ragged megagroups"),
])
def test_unported_combinations_raise(kwargs, match):
    method = kwargs.pop("method")
    with pytest.raises(NotImplementedError, match=match):
        tapi.orthogonal(method, **kwargs)


def test_watchdog_must_be_a_config():
    with pytest.raises(TypeError, match="WatchdogConfig"):
        tapi.orthogonal("pogo", use_kernel=True, watchdog=object())


def test_unflatten_keeps_no_leaf_alive():
    """A step's temporaries die with their last reference: ``tree.unflatten``
    builds no reference cycle, so no garbage collection is needed to free a
    stack (the card's peak memory counts only live tensors)."""
    import gc
    import weakref

    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    _, td = tree.flatten({"a": [torch.zeros(1), (torch.zeros(1),)], "b": None})
    gc.disable()
    try:
        out = tree.unflatten(td, [leaf, torch.ones(1)])
        assert out["a"][0] is leaf
        del out, leaf
        assert ref() is None
    finally:
        gc.enable()
