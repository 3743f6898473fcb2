"""The port's feasibility watchdog against the JAX package's, on the CPU.

Mirrors ``tests/test_health.py:136-341`` (state, rising-edge escalation,
hysteresis release, drift repair, no repair below the threshold, the
careful sibling, the grouping modes) and runs each scenario through both
packages from the same numpy params and gradients, holding the counters
and latches equal and the updates and reported distances to the
two-stage step tolerance of ``tests/test_torch_two_stage.py`` (atol 2e-5
/ rtol 1e-4) on every route: the fused step (``use_kernel`` with a base
the kernel replays), the two-stage step (POGO's blended land, POGO over
Adam with the ``find_root`` sibling, the Landing sibling) and
``constraint_step`` in place.

Where a matrix is repaired, the JAX package projects ``x + (x' - x)`` and
the port projects ``x'`` (the same iterate up to one fp32 rounding), and
the unrepaired matrices' distances come from the fused telemetry in the
port where JAX re-measures them: the tolerance covers both. POGO's blended
land repairs a drifted matrix with the quartic-root lambda of its gram,
which is not comparable per matrix between the packages at that distance
(a near-double root in fp32, ``tests/test_torch_quartic.py``): on those
scenarios both packages are held to equal repair counts and to
feasibility bounds, not to each other's iterates or escalation latches. The bound after the repair step is
``hard`` there, not the ``hard / 2`` of ``tests/test_health.py``: in both
packages about one matrix in five of a 1.5x drift lands at 0.06-0.07
with the blended lambda (numpy draws of six seeds: port 5/24, JAX 4/24);
the reference test's draws happen to miss it. The next step brings every
matrix below 1e-3 in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import api as japi
from repro_torch import optim as topt
from repro_torch.core import api as tapi

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are small, and the suite runs in
    several worker processes at once, where torch's thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stiefel(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((*lead, n, p)))
    return np.ascontiguousarray(np.swapaxes(q, -1, -2), np.float32)


def _noise(shape, seed, scale):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _driver_problem(b=4, p=6, n=12, drift=1.0):
    xs = drift * _stiefel((b, p, n), 0)
    gs = _noise((b, p, n), 2, 0.1)
    return ({f"w{i}": xs[i] for i in range(b)}, {f"w{i}": gs[i] for i in range(b)})


class Both:
    """One orthoptimizer in both packages, stepped on the same numpy
    params and gradients with ``opt.update`` + ``params + updates``."""

    def __init__(self, method, params, *, base=None, compare=True, **kw):
        self.compare = compare
        jbase, tbase = base() if base else (None, None)
        self.j = japi.orthogonal(method, base_optimizer=jbase, **kw)
        kw = {k: (tapi.WatchdogConfig(**vars(v)) if k == "watchdog" and v else v)
              for k, v in kw.items()}
        self.t = tapi.orthogonal(method, base_optimizer=tbase, **kw)
        self.jp = {k: jnp.asarray(v) for k, v in params.items()}
        self.tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        self.js, self.ts = self.j.init(self.jp), self.t.init(self.tp)

    def step(self, grads):
        ju, self.js = self.j.update({k: jnp.asarray(v) for k, v in grads.items()},
                                    self.js, self.jp)
        tu, self.ts = self.t.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                    self.ts, self.tp)
        self.jp = {k: self.jp[k] + ju[k] for k in self.jp}
        self.tp = {k: self.tp[k] + tu[k] for k in self.tp}
        if self.compare:
            for k in self.jp:
                np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                           err_msg=f"update {k}", **TOL)
            for a, b in zip(self.js.last_distance.per_group,
                            self.ts.last_distance.per_group):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg="dist",
                                           **TOL)
        for both in (float(tapi.max_distance(self.ts)), float(japi.max_distance(self.js))):
            assert np.isfinite(both)
        return self.summary()

    def summary(self):
        s = tapi.watchdog_summary(self.ts)
        want = japi.watchdog_summary(self.js)
        if self.compare:
            assert s == want
        else:  # the latches follow distances that are not comparable
            assert s["repairs"] == want["repairs"]
        return s

    def with_residual(self, value):
        """Both states with every telemetry residual set to ``value``."""
        gd = self.js.last_distance
        self.js = self.js._replace(last_distance=gd._replace(
            per_group=tuple(jnp.full_like(d, value) for d in gd.per_group)))
        gd = self.ts.last_distance
        self.ts = self.ts._replace(last_distance=gd._replace(
            per_group=tuple(torch.full_like(d, value) for d in gd.per_group)))


def _vadam():
    return jopt.chain(jopt.scale_by_vadam()), topt.chain(topt.scale_by_vadam())


def _adam():
    return jopt.scale_by_adam(), topt.scale_by_adam()


def test_watchdog_state_initialized():
    params, _ = _driver_problem()
    both = Both("pogo", params, learning_rate=0.1, watchdog=japi.WatchdogConfig())
    assert isinstance(both.ts.extras, tapi.WatchdogState)
    assert both.summary() == {"repairs": 0, "escalations": 0, "escalated": [False]}


def test_watchdog_off_has_no_state():
    params, _ = _driver_problem()
    both = Both("pogo", params, learning_rate=0.1)
    assert both.ts.extras == ()
    assert tapi.watchdog_summary(both.ts) is None


# (method, orthogonal kwargs, base): every route the watchdog dispatches
ROUTES = {
    "pogo_blend": ("pogo", dict(use_kernel=False), None),
    "pogo_fused": ("pogo", dict(use_kernel=True), None),
    "pogo_fused_vadam": ("pogo", dict(use_kernel=True), _vadam),
    "pogo_adam_find_root": ("pogo", dict(use_kernel=True, learning_rate=0.01), _adam),
    "landing_sibling": ("landing", dict(safe_step=False), None),
}


def _route(name, params, wd, lr=0.1, compare=True):
    method, kw, base = ROUTES[name]
    kw = {"learning_rate": lr, **kw}
    return Both(method, params, base=base, watchdog=wd, compare=compare, **kw)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_watchdog_escalation_rising_edge(route):
    """soft below any real residual: step 2 escalates off step 1's
    telemetry; the counter counts the 0->1 edge once, and hysteresis keeps
    the group escalated on step 3 without re-counting. A fused group has no
    careful sibling: escalated, its repair threshold drops to ``soft``, so
    each of its four matrices is repaired on steps 2 and 3."""
    params, grads = _driver_problem()
    both = _route(route, params, japi.WatchdogConfig(soft=1e-12, hard=1e9))
    assert both.step(grads)["escalations"] == 0
    s2 = both.step(grads)
    assert s2["escalated"] == [True] and s2["escalations"] == 1
    s3 = both.step(grads)
    assert s3["escalated"] == [True] and s3["escalations"] == 1
    assert s3["repairs"] == (8 if "fused" in route else 0)


@pytest.mark.parametrize("route", ["pogo_blend", "pogo_fused"])
def test_watchdog_hysteresis_release(route):
    params, grads = _driver_problem()
    both = _route(route, params, japi.WatchdogConfig(soft=1e-3, hard=1e9, release=0.25))
    both.step(grads)
    for value, escalated in ((5e-4, False), (2e-3, True)):
        probe = _route(route, params, japi.WatchdogConfig(soft=1e-3, hard=1e9,
                                                          release=0.25))
        probe.js, probe.ts = both.js, both.ts
        probe.with_residual(value)
        assert probe.step(grads)["escalated"] == [escalated]
    # escalated: stays so in the hysteresis band, releases below it
    esc = probe
    for value, escalated in ((5e-4, True), (1e-4, False)):
        again = _route(route, params, japi.WatchdogConfig(soft=1e-3, hard=1e9,
                                                          release=0.25))
        again.js, again.ts, again.jp, again.tp = esc.js, esc.ts, esc.jp, esc.tp
        again.with_residual(value)
        assert again.step(grads)["escalated"] == [escalated]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_watchdog_repair_restores_drift(route):
    """1.5x off-manifold drift crosses ``hard``: every matrix is repaired
    in the step (the reported residual is post-repair), and the next,
    escalated step brings the iterate back to spec."""
    b, p, n = 4, 6, 12
    params = {f"w{i}": 1.5 * x for i, x in enumerate(_stiefel((b, p, n), 0))}
    grads = {f"w{i}": g for i, g in enumerate(_noise((b, p, n), 2, 0.05))}
    wd = japi.WatchdogConfig()
    blend = route == "pogo_blend"
    both = _route(route, params, wd, compare=not blend)
    assert both.step(grads)["repairs"] == b
    bound = wd.hard if blend else wd.hard / 2
    assert float(tapi.max_distance(both.ts)) < bound
    assert float(japi.max_distance(both.js)) < bound
    both.step(grads)
    assert float(tapi.max_distance(both.ts)) < 1e-3
    for v in both.tp.values():
        torch.testing.assert_close(v @ v.T, torch.eye(p), atol=1e-3, rtol=0)


@pytest.mark.parametrize("route", ["pogo_blend", "pogo_fused", "landing_sibling"])
def test_watchdog_no_repair_below_threshold(route):
    params, grads = _driver_problem()
    both = _route(route, params, japi.WatchdogConfig())
    for _ in range(3):
        s = both.step(grads)
    assert s["repairs"] == 0


def test_watchdog_escalated_sibling_runs():
    """Landing's careful sibling (safe_step=True) runs once escalated, and
    the steps stay finite and feasible."""
    params, grads = _driver_problem()
    both = _route("landing_sibling", params, japi.WatchdogConfig(soft=1e-12, hard=1e9))
    for _ in range(3):
        s = both.step(grads)
    assert s["escalated"] == [True]
    assert bool(tapi.step_health(both.ts).ok())


def test_escalated_siblings():
    careful = tapi.Pogo(lam=1.0).escalated()
    assert careful.find_root and careful.lam == 1.0
    assert tapi.Pogo(lam=1.0, find_root=True).escalated() is None
    assert tapi.Landing(lam=1.0, safe_step=False).escalated().safe_step
    assert tapi.Landing(lam=1.0).escalated() is None


@pytest.mark.parametrize("grouping", ["auto", "per_leaf"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_watchdog_grouping_modes(grouping, use_kernel):
    """Drift on one shape family is repaired without touching the clean
    family (two groups under ``auto``, four under ``per_leaf``)."""
    a = _stiefel((2, 4, 8), 1)
    c = _stiefel((2, 6, 12), 2)
    params = {"a0": 1.5 * a[0], "a1": 1.5 * a[1], "c0": c[0], "c1": c[1]}
    grads = {k: _noise(v.shape, 3, 0.05) for k, v in params.items()}
    both = Both("pogo", params, learning_rate=0.1, grouping=grouping,
                use_kernel=use_kernel, watchdog=japi.WatchdogConfig(),
                compare=use_kernel)
    assert both.step(grads)["repairs"] == 2
    bound = 1e-2 if use_kernel else 0.1  # blended lambda: see the docstring
    assert float(tapi.max_distance(both.ts)) < bound
    both.step(grads)
    assert float(tapi.max_distance(both.ts)) < 1e-3


@pytest.mark.parametrize("route", ["pogo_fused_vadam", "pogo_blend", "landing_sibling"])
def test_constraint_step_in_place_matches_update(route):
    """The in-place step (``constraint_step`` on a ``ConstraintSet``, the
    repair written over the stack) gives what ``update`` gives."""
    b, p, n = 4, 6, 12
    xs = 1.5 * _stiefel((b, p, n), 0)
    grads = [_noise((b, p, n), 10 + i, 0.05) for i in range(3)]
    method, kw, base = ROUTES[route]
    kw = {"learning_rate": 0.1, "watchdog": tapi.WatchdogConfig(), **kw}
    t_base = (lambda: base()[1]) if base else (lambda: None)
    opt_a = tapi.orthogonal(method, base_optimizer=t_base(), **kw)
    opt_b = tapi.orthogonal(method, base_optimizer=t_base(), **kw)
    cs = tapi.ConstraintSet.from_tree({"w": torch.from_numpy(xs.copy())}, device="cpu")
    st_a = opt_a.init(cs)
    tree_p = {"w": torch.from_numpy(xs.copy())}
    st_b = opt_b.init(tree_p)
    step = tapi.constraint_step(opt_a)
    for g in grads:
        cs, st_a, _ = step(cs, st_a,
                           tapi.ConstraintSet.from_tree({"w": torch.from_numpy(g)},
                                                        device="cpu"))
        u, st_b = opt_b.update({"w": torch.from_numpy(g)}, st_b, tree_p)
        tree_p = {"w": tree_p["w"] + u["w"]}
        torch.testing.assert_close(cs.stacks[0], tree_p["w"], **TOL)
        assert tapi.watchdog_summary(st_a) == tapi.watchdog_summary(st_b)
    assert tapi.watchdog_summary(st_a)["repairs"] == b
