"""Parity of the port's fused Landing step (the fixed step,
``safe_step=False``) with the JAX package, on the CPU.

The same numpy inputs go through the port's plain version of the Landing
branches of ``csrc/fused_step.cu`` (``ops.fused_group_step(method=
"landing")`` on a CPU tensor), JAX ``ref.fused_group_step_ref`` and JAX
``ops.fused_group_step(use_pallas=True, interpret=True)``: the whole
kernel, and the tiled one forced by shrinking ``ops.VMEM_BUDGET_BYTES`` as
``tests/test_fused_step.py`` does. X is a Stiefel draw plus 0.01 randn,
so Landing's normal term ``lam (A X - X)`` is visible. Tolerances are
those the JAX tests hold the Pallas kernels to: atol 2e-5 / rtol 1e-4
whole, atol 3e-5 / rtol 1e-4 tiled (fp32 sums in another order).

Then the driver: ``orthogonal("landing", safe_step=False,
use_kernel=True)`` + ``constraint_step`` for three steps in both packages
from the same state and gradients, held to the tolerances of JAX's own
fused-against-unfused driver test (``tests/test_fused_step.py:273-300``:
atol 3e-6 / rtol 1e-5 on params and base state, atol 1e-5 / rtol 1e-3 on
the distance), and the feasibility watchdog's repair of a 1.5x drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import api as japi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import fused as jfused
from repro_torch import optim as topt
from repro_torch.core import api as tapi
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops

SHAPES = [(3, 5, 40), (2, 10, 250), (4, 16, 256)]
WHOLE_BASES = [
    ("none", ()),
    ("trace", (0.37, False)),
    ("trace", (0.56, True)),  # nesterov
    ("vadam", (0.92, 0.999, 1e-8)),
]
TILED_BASES = [
    ("none", ()),
    ("trace", (0.39, False)),
    ("trace", (0.58, True)),
    ("vadam", (0.93, 0.997, 1e-8)),
]
WHOLE_TOL = dict(atol=2e-5, rtol=1e-4)
TILED_TOL = dict(atol=3e-5, rtol=1e-4)
NAMES = ("x", "mu", "nu", "dist", "finite")
LAM = 0.8


def _operands(shape, seed=0, pv=None):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    if pv is not None:
        rows = np.arange(p)[None, :, None] < np.asarray(pv)[:, None, None]
        x, g, mu = (np.where(rows, a, 0.0) for a in (x, g, mu))
    nu = np.abs(rng.standard_normal(b))
    return tuple(a.astype(np.float32) for a in (x, g, mu, nu))


def _both(shape, base_kind, hyper, post_scale=1.0, pv=None, seed=0):
    """(jax kwargs, torch kwargs, x, g) for one Landing case."""
    x, g, mu, nu = _operands(shape, seed, pv)
    has_mu = base_kind != "none"
    has_nu = base_kind == "vadam"
    common = dict(method="landing", lam=LAM, base_kind=base_kind, hyper=hyper,
                  post_scale=post_scale)
    jkw = dict(common, mu=jnp.asarray(mu) if has_mu else None,
               nu=jnp.asarray(nu) if has_nu else None,
               count=jnp.asarray(3, jnp.int32) if has_nu else None,
               pv=None if pv is None else jnp.asarray(pv, jnp.int32))
    tkw = dict(common, mu=torch.from_numpy(mu) if has_mu else None,
               nu=torch.from_numpy(nu) if has_nu else None,
               count=torch.tensor(3, dtype=torch.int32) if has_nu else None,
               pv=None if pv is None else torch.tensor(pv, dtype=torch.int32))
    return jkw, tkw, x, g


def _compare(want, got, tol, label):
    for a, b, name in zip(want, got, NAMES):
        if a is None:
            assert b is None, f"{label}/{name}"
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=f"{label}/{name}", **tol)


def _port(x, g, tkw):
    return tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_landing_plain_matches_jax_oracle(shape, base_kind, hyper):
    jkw, tkw, x, g = _both(shape, base_kind, hyper, post_scale=0.7)
    want = jref.fused_group_step_ref(jnp.asarray(x), jnp.asarray(g), 0.1, **jkw)
    _compare(want, _port(x, g, tkw), WHOLE_TOL, f"oracle/{shape}/{base_kind}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_landing_plain_matches_pallas_whole(shape, base_kind, hyper):
    jkw, tkw, x, g = _both(shape, base_kind, hyper)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=True, interpret=True, **jkw)
    _compare(want, _port(x, g, tkw), WHOLE_TOL, f"whole/{shape}/{base_kind}")


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("base_kind,hyper", TILED_BASES)
def test_landing_plain_matches_pallas_tiled(shape, base_kind, hyper, monkeypatch):
    """JAX's planner takes its tiled Landing kernels (``_t1_kernel`` +
    ``_t2_landing_kernel``) under a budget too small for the whole one."""
    monkeypatch.setattr(jops, "VMEM_BUDGET_BYTES", 64 * 1024)
    jkw, tkw, x, g = _both(shape, base_kind, hyper, post_scale=1.3)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=True, interpret=True, **jkw)
    _compare(want, _port(x, g, tkw), TILED_TOL, f"tiled/{shape}/{base_kind}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_landing_ragged_pv_matches_jax(use_pallas):
    """Zero-padded rows masked per matrix (``pv``): the distance's identity
    covers each matrix's own rows only."""
    pv = [8, 5, 1, 0]
    jkw, tkw, x, g = _both((4, 8, 200), "vadam", (0.9, 0.999, 1e-8), pv=pv)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=use_pallas, interpret=True, **jkw)
    _compare(want, _port(x, g, tkw), WHOLE_TOL, f"ragged/{use_pallas}")


@pytest.mark.parametrize("wrapper", [tfs.fused_step_whole_landing,
                                     tfs.fused_step_tiled_landing,
                                     tfs.fused_step_cluster_landing,
                                     tfs.fused_step_tiled_tc_landing,
                                     tfs.fused_step_tiled_tc128_landing])
def test_landing_wrappers_run_the_plain_version_on_cpu(wrapper):
    _, tkw, x, g = _both((2, 10, 250), "trace", (0.9, False))
    tkw.pop("method")
    before = wrapper.launches
    got = wrapper(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    want = _port(x, g, dict(tkw, method="landing"))
    _compare(want, got, dict(atol=0, rtol=0), wrapper.__name__)
    assert wrapper.launches == before  # the plain version launches nothing


@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_landing_inplace_matches_out_of_place(base_kind, hyper):
    _, tkw, x, g = _both((3, 10, 250), base_kind, hyper)
    want = _port(x, g, {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in tkw.items()})
    xt = torch.from_numpy(x.copy())
    got = tops.fused_group_step(xt, torch.from_numpy(g), 0.1, inplace=True, **tkw)
    assert got[0] is xt
    if base_kind != "none":
        assert got[1] is tkw["mu"]
    _compare(want, got, dict(atol=0, rtol=0), f"inplace/{base_kind}")


# ------------------------------------------------------------------ driver

# Two wide leaves of one shape (one group of 5), a tall leaf (transposed
# into its own group) and a second wide shape.
TREE = {"a": (3, 4, 24), "b": (30, 6), "c": (2, 4, 24), "d": (5, 40)}
DRIVER_BASES = {
    "none": (lambda: None, lambda: None),
    "trace": (lambda: jopt.chain(jopt.trace(0.3)), lambda: topt.chain(topt.trace(0.3))),
    "nesterov": (lambda: jopt.trace(0.5, nesterov=True),
                 lambda: topt.trace(0.5, nesterov=True)),
    "vadam": (lambda: jopt.chain(jopt.scale_by_vadam()),
              lambda: topt.chain(topt.scale_by_vadam())),
    "trace+scale": (lambda: jopt.chain(jopt.trace(0.3), jopt.scale(0.7)),
                    lambda: topt.chain(topt.trace(0.3), topt.scale(0.7))),
}
X_TOL = dict(atol=3e-6, rtol=1e-5)  # tests/test_fused_step.py:286-296
DIST_TOL = dict(atol=1e-5, rtol=1e-3)


def _near_stiefel(shape, rng, noise=1e-3):
    *lead, p, n = shape
    tall = p > n
    if tall:
        p, n = n, p
    q, _ = np.linalg.qr(rng.standard_normal((*lead, n, p)))
    x = np.swapaxes(q, -1, -2) + noise * rng.standard_normal((*lead, p, n))
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


def _slots_j(state, base):
    mu, nu, _ = jfused.resolve_fused_base(base).get_slots(state.base_state)
    return mu, nu


@pytest.mark.parametrize("base", sorted(DRIVER_BASES))
def test_fixed_step_landing_constraint_step_matches_jax(base):
    """Three in-place steps, one fused launch per group and step, against
    JAX's fused driver; stacks, moments and distances after each."""
    make_j, make_t = DRIVER_BASES[base]
    base_j, base_t = make_j(), make_t()
    params = _params()
    opt_j = japi.orthogonal("landing", learning_rate=0.1, use_kernel=True,
                            safe_step=False, base_optimizer=base_j)
    opt_t = tapi.orthogonal("landing", learning_rate=0.1, use_kernel=True,
                            safe_step=False, base_optimizer=base_t)
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    cs_t = tapi.ConstraintSet.from_tree(params, device="cpu")
    st_j, st_t = opt_j.init(cs_j), opt_t.init(cs_t)
    step_j, step_t = japi.constraint_step(opt_j), tapi.constraint_step(opt_t)
    for step in range(3):
        grads = _grads(step)
        cs_j, st_j, h_j = step_j(cs_j, st_j, japi.ConstraintSet.from_tree(
            jax.tree.map(jnp.asarray, grads)))
        cs_t, st_t, h_t = step_t(cs_t, st_t,
                                 tapi.ConstraintSet.from_tree(grads, device="cpu"))
        label = f"{base}/{step}"
        for a, b in zip(cs_j.stacks, cs_t.stacks):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=f"{label}/x",
                                       **X_TOL)
        for a, b in zip(st_j.last_distance.per_group, st_t.last_distance.per_group):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       err_msg=f"{label}/dist", **DIST_TOL)
        mu_j, nu_j = _slots_j(st_j, base_j)
        mu_t, nu_t, _ = topt.resolve_fused_base(base_t).get_slots(st_t.base_state)
        for tj, tt, name in ((mu_j, mu_t, "mu"), (nu_j, nu_t, "nu")):
            if tj is None:
                continue
            for a, b in zip(tj.stacks, tt.stacks):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           err_msg=f"{label}/{name}", **X_TOL)
        assert bool(h_t.finite) and bool(h_j.finite)
        assert int(st_t.count) == int(st_j.count)


@pytest.mark.parametrize("base", ["trace", "vadam"])
def test_fixed_step_landing_tree_update_matches_jax(base):
    """The out-of-place ``update`` on a tree with a tall leaf."""
    make_j, make_t = DRIVER_BASES[base]
    params = _params(1)
    opt_j = japi.orthogonal("landing", learning_rate=0.1, use_kernel=True,
                            safe_step=False, base_optimizer=make_j())
    opt_t = tapi.orthogonal("landing", learning_rate=0.1, use_kernel=True,
                            safe_step=False, base_optimizer=make_t())
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    st_j, st_t = opt_j.init(pj), opt_t.init(pt)
    for step in range(2):
        grads = _grads(step)
        uj, st_j = opt_j.update(jax.tree.map(jnp.asarray, grads), st_j, pj)
        ut, st_t = opt_t.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                st_t, pt)
        pj = jax.tree.map(lambda a, b: a + b, pj, uj)
        pt = {k: pt[k] + ut[k] for k in pt}
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), err_msg=k, **X_TOL)
    np.testing.assert_allclose(float(tapi.max_distance(st_t)),
                               float(japi.max_distance(st_j)), **DIST_TOL)


def test_fixed_step_landing_watchdog_repairs_a_drift_as_jax_does():
    """The fused watchdog (``repro/core/api.py:1551-1564``): the fused
    kernel has no careful form, so escalation tightens the Newton-Schulz
    repair threshold from ``hard`` to ``soft``. Scaling the stacks by 1.5
    puts every matrix past ``hard``: both packages repair all of them in
    that step and report the repaired distance."""
    wd_j = japi.WatchdogConfig()
    wd_t = tapi.WatchdogConfig()
    params = _params(2)
    kw = dict(learning_rate=0.05, use_kernel=True, safe_step=False)
    opt_j = japi.orthogonal("landing", base_optimizer=jopt.chain(jopt.trace(0.1)),
                            watchdog=wd_j, **kw)
    opt_t = tapi.orthogonal("landing", base_optimizer=topt.chain(topt.trace(0.1)),
                            watchdog=wd_t, **kw)
    cs_j = japi.ConstraintSet.from_tree(jax.tree.map(jnp.asarray, params))
    cs_t = tapi.ConstraintSet.from_tree(params, device="cpu")
    st_j, st_t = opt_j.init(cs_j), opt_t.init(cs_t)
    step_j, step_t = japi.constraint_step(opt_j), tapi.constraint_step(opt_t)
    n_mat = sum(s.shape[0] for s in cs_t.stacks)
    for step in range(3):
        if step == 1:  # drift every matrix past `hard`
            cs_j = japi.ConstraintSet(cs_j.plan, tuple(1.5 * s for s in cs_j.stacks))
            for s in cs_t.stacks:
                s.mul_(1.5)
        grads = _grads(step, 0.01)
        cs_j, st_j, _ = step_j(cs_j, st_j, japi.ConstraintSet.from_tree(
            jax.tree.map(jnp.asarray, grads)))
        cs_t, st_t, h_t = step_t(cs_t, st_t,
                                 tapi.ConstraintSet.from_tree(grads, device="cpu"))
        want, got = japi.watchdog_summary(st_j), tapi.watchdog_summary(st_t)
        assert got["repairs"] == want["repairs"], (step, got, want)
        assert got["repairs"] == (n_mat if step >= 1 else 0)
        assert bool(h_t.finite)
        assert float(tapi.max_distance(st_t)) < wd_t.hard
        for a, b in zip(cs_j.stacks, cs_t.stacks):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=str(step),
                                       atol=2e-5, rtol=1e-4)
