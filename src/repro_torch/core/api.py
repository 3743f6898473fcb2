"""Orthoptimizers of the port: POGO and Landing on stacked constraint
groups.

Port of ``repro.core.api``. ``orthogonal(method, ...)`` buckets the param
leaves into ``(B, p, n)`` groups (:func:`plan_groups`) and runs each group
through one of two routes, chosen as the JAX package chooses them
(``repro/core/api.py:1154-1167``):

* the **fused group step**: ``use_kernel=True``, a base optimizer the
  kernel replays (none, ``trace``, ``scale_by_vadam``, chains of those with
  ``scale``) and a method with a fused stage (POGO without ``find_root``):
  ``Pogo.fused_step`` -> ``kernels.ops.fused_group_step``, one launch per
  group;
* the **two-stage group step** otherwise: the base optimizer runs first,
  in PyTorch, then :meth:`Method.direction` and :meth:`Method.land`, or
  the method's ``kernel_update``. With ``use_kernel=True`` POGO's update
  is ``kernels.ops.pogo_update`` and Landing's field
  ``kernels.ops.landing_field``, one launch per group; with
  ``use_kernel=False`` every stage is plain PyTorch, as the JAX package's
  own plain route.

:class:`ConstraintSet` keeps the groups stacked at rest;
:func:`constraint_step` updates its stacks and the optimizer moments in
place.

Combinations this slice does not port raise ``NotImplementedError`` naming
the ROADMAP entry that holds them: Landing's fixed-step fused branch
(``safe_step=False`` with a linear base and ``use_kernel=True``), methods
other than POGO and Landing, POGO's ``find_root``, complex groups, the
feasibility watchdog, Newton-Schulz safety projection, tensor parallelism
and padded megagroups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import tree
from .._device import resolve_device
from ..health import StepHealth, from_residual
from ..optim import fused as optim_fused
from ..optim.transform import GradientTransformation
from . import quartic, stiefel
from .schedule import GroupMember, GroupPlan, GroupSpec, plan_groups

__all__ = [
    "ConstraintSet", "FusedSlots", "GroupMember", "GroupPlan", "GroupSpec",
    "GroupedDistances", "Landing", "Method", "OrthoState", "Pogo", "StepCtx",
    "constraint_step", "leaf_distances", "max_distance", "orthogonal",
    "plan_groups", "step_health",
]


# ---------------------------------------------------------- constraint groups


def _gather_group(group: GroupSpec, leaves) -> torch.Tensor:
    """Stack a group's member leaves into one ``(B, p, n)`` tensor. A
    single untransposed ``(B, p, n)`` member is returned as is (no copy),
    which is what lets :func:`constraint_step` update stacks in place."""
    parts = []
    for m in group.members:
        x = leaves[m.leaf]
        if m.transpose:
            x = x.transpose(-1, -2)
        parts.append(x.reshape(m.count, m.p, m.n))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _scatter_group(group: GroupSpec, stacked: torch.Tensor, out: list) -> None:
    """Split a group's ``(B, p, n)`` result back into member-leaf layout."""
    for m in group.members:
        u = stacked[m.offset:m.offset + m.count].reshape(*m.lead, m.p, m.n)
        out[m.leaf] = u.transpose(-1, -2) if m.transpose else u


def _gather_group_scalars(group: GroupSpec, leaves) -> torch.Tensor:
    """Stack per-matrix scalar leaves (shape = lead dims) into ``(B,)``."""
    parts = [leaves[m.leaf].reshape(m.count) for m in group.members]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _scatter_group_scalars(group: GroupSpec, stacked: torch.Tensor, out: list) -> None:
    for m in group.members:
        out[m.leaf] = stacked[m.offset:m.offset + m.count].reshape(m.lead)


class ConstraintSet:
    """Stacked storage for a constrained param tree: one ``(B, p, n)``
    tensor per constraint group plus the static :class:`GroupPlan`.

        cs = ConstraintSet.from_tree(params)          # stack once
        gs = ConstraintSet.from_tree(grads)           # same plan/layout
        cs, state, health = constraint_step(opt)(cs, state, gs)
        params = cs.to_tree()                         # unstack at the end

    It is a tree node whose leaves are its stacks, so the step (and the
    base optimizers' ``init``) consume it with zero repacking.
    """

    def __init__(self, plan: GroupPlan, stacks):
        self.plan = plan
        self.stacks = tuple(stacks)

    @classmethod
    def from_tree(cls, params, grouping: str = "auto",
                  device="cuda") -> "ConstraintSet":
        """Stack a tree of tensors or arrays onto ``device`` (tall leaves
        transpose in; ``to_tree`` transposes them back out)."""
        device = resolve_device(device)
        leaves, treedef = tree.flatten(params)
        leaves = [torch.as_tensor(x).to(device) for x in leaves]
        plan = plan_groups(leaves, treedef, grouping)
        stacks = tuple(_gather_group(g, leaves).contiguous() for g in plan.groups)
        return cls(plan, stacks)

    def to_tree(self):
        out: list = [None] * self.plan.n_leaves
        for group, stack in zip(self.plan.groups, self.stacks):
            _scatter_group(group, stack, out)
        return tree.unflatten(self.plan.treedef, out)

    def apply(self, updates: "ConstraintSet") -> "ConstraintSet":
        """Add an update set (same plan) — stacked ``params + updates``."""
        if updates.plan != self.plan:
            raise ValueError("ConstraintSet plans differ")
        return ConstraintSet(
            self.plan, tuple(s + u for s, u in zip(self.stacks, updates.stacks))
        )

    def stacked_plan(self) -> GroupPlan:
        """The plan of this set's OWN stacks: one single-member group per
        stack (each stack IS its group's batch)."""
        groups = []
        key_base = 0
        for i, g in enumerate(self.plan.groups):
            groups.append(GroupSpec(
                p=g.p, n=g.n, dtype=g.dtype, batch=g.batch,
                members=(GroupMember(
                    leaf=i, lead=(g.batch,), transpose=False, offset=0,
                    key_base=key_base, p=g.p, n=g.n,
                ),),
            ))
            key_base += g.batch
        return GroupPlan(
            groups=tuple(groups), treedef=tree.flatten(self)[1],
            n_leaves=len(self.stacks), n_matrices=key_base,
        )

    def tree_flatten(self):
        return self.stacks, self.plan

    @classmethod
    def tree_unflatten(cls, plan, stacks):
        return cls(plan, stacks)

    def __repr__(self):
        shapes = ", ".join(str(tuple(s.shape)) for s in self.stacks)
        return f"ConstraintSet({self.plan.n_matrices} matrices: {shapes})"


def constraint_step(opt: GradientTransformation):
    """Resting-state step over :class:`ConstraintSet`\\ s, in place.

        step = constraint_step(orthogonal("pogo", use_kernel=True, ...))
        params, state, health = step(params, state, grads)

    JAX's ``constraint_step`` donates the param stacks and the optimizer
    state into a jitted step. Here the step **writes X' over the param
    stacks and the new moments over the state's moment buffers in
    place**: the kernels write X' directly and Landing's leap subtracts
    in place, the plain POGO route copies X' in; the base optimizer's
    ``update_inplace`` overwrites its moments (a base without one keeps
    its functional ``update``). The returned ``params`` is the same
    object. The returned state is a new :class:`OrthoState` whose moment
    tensors are the updated originals. Gradients are only read. The third
    output is the step's :class:`~repro_torch.health.StepHealth`.
    """
    if not (opt.tag and opt.tag[0] == "orthogonal"):
        raise TypeError("constraint_step needs an optimizer built by orthogonal()")

    def step(params: ConstraintSet, state, grads: ConstraintSet):
        _, state = opt.update_inplace(grads, state, params)
        return params, state, step_health(state)

    return step


# --------------------------------------------------------------------- state


class GroupedDistances(NamedTuple):
    """Per-group ``(B_g,)`` fp32 arrays of ``||X_b X_b^T - I||_F`` of each
    post-update matrix, in manifold orientation; ``plan`` is static."""

    plan: GroupPlan
    per_group: tuple


class OrthoState(NamedTuple):
    """Optimizer state: step ``count`` (0-d int32 tensor), the wrapped base
    optimizer's state, the RNG seed (no ported method draws random
    numbers), the :class:`GroupedDistances` telemetry, method extras."""

    count: torch.Tensor
    base_state: tuple
    rng: Any
    last_distance: Any  # GroupedDistances
    extras: Any = ()


@dataclasses.dataclass
class StepCtx:
    """Per-group context of one step: the fp32 stacked group in manifold
    orientation, the learning rate (a method may rescale it per matrix,
    as Landing's safe step does), the step count, whether kernels run,
    and ``pv`` (per-matrix valid rows; ``None`` for the uniform groups of
    this slice)."""

    x: torch.Tensor
    g: torch.Tensor
    eta: Any
    count: torch.Tensor
    use_kernel: bool = False
    pv: Optional[torch.Tensor] = None


class FusedSlots(NamedTuple):
    """Runtime operands of one fused group step: the base optimizer's
    ``FusedBase`` fields plus its group-gathered moments (``mu`` stacked
    ``(B, p, n)``, ``nu`` ``(B,)``) and its own step counter."""

    kind: str
    hyper: tuple
    post_scale: float
    mu: Optional[torch.Tensor]
    nu: Optional[torch.Tensor]
    count: Optional[torch.Tensor]


def _accum_dtype(dtype):
    """Land steps need >= fp32 accumulation for ~1e-6 feasibility."""
    return torch.promote_types(dtype, torch.float32)


class Method:
    """One orthoptimizer as two stages (``repro/core/api.py:394-402``):
    ``direction`` gives D and may rescale ``ctx.eta``, the step leaps
    ``M = X - eta D``, and ``land`` maps M back towards the manifold.
    ``kernel_update``, where a method has one, replaces all three on the
    kernel path; ``fused_step`` is the single-pass fused group step."""

    name: str = "?"
    kernel_update: Optional[Callable] = None
    fused_stage: Optional[str] = None
    lam: float = 0.5

    def direction(self, x, g, ctx: StepCtx) -> torch.Tensor:
        raise NotImplementedError

    def land(self, m, ctx: StepCtx) -> torch.Tensor:
        return m

    def fused_ready(self) -> bool:
        """Instance-level gate for the fused group step."""
        return self.fused_stage is not None

    def fused_step(self, x, g, ctx: StepCtx, slots: FusedSlots,
                   inplace: bool = False):
        """``(x_next, mu', nu', dist, finite)`` of one group; with
        ``inplace`` the kernel writes them over ``x``, ``slots.mu``,
        ``slots.nu``."""
        from ..kernels import ops as kops

        return kops.fused_group_step(
            x, g, ctx.eta, method=self.fused_stage, lam=self.lam,
            base_kind=slots.kind, hyper=slots.hyper,
            post_scale=slots.post_scale, mu=slots.mu, nu=slots.nu,
            count=slots.count, pv=ctx.pv, inplace=inplace,
        )


class Pogo(Method):
    """POGO (the paper's Alg. 1): ``R = 1/2 (X X^T G - X G^T X)``,
    ``M = X - eta R``, ``X' = (1 + lam) M - lam (M M^T) M``."""

    name = "pogo"
    fused_stage = "pogo"

    def __init__(self, lam: float = 0.5, find_root: bool = False):
        if find_root:
            raise NotImplementedError(
                "POGO find_root (quartic land) is not ported "
                "(ROADMAP: remaining methods + quartic)"
            )
        self.lam = lam

    def direction(self, x, g, ctx):
        return stiefel.riemannian_gradient(x, g)

    def land(self, m, ctx):
        c = stiefel.gram(m)
        return (1.0 + self.lam) * m - self.lam * (c @ m)

    def kernel_update(self, x, g, ctx, inplace=False):
        from ..kernels import ops as kops

        return kops.pogo_update(x, g, ctx.eta, lam=self.lam, inplace=inplace)


def _safe_eta(x, direction, eta0, eps):
    """Exact safe step (``repro/core/api.py:579``): the largest eta in
    (0, eta0] with dist(X - eta D) <= eps, per matrix.

    dist^2(eta) is the quartic ``||C + eta Dm + eta^2 Em||^2`` with
    ``C = XX^T - I``, ``Dm = -(X D^T + D X^T)``, ``Em = D D^T``. Solve
    dist^2(eta) = eps^2 and take the smallest positive real root; if none
    is below eta0, eta0 itself is safe. A matrix already outside the
    eps-ball takes at most eta0 / 2. Nothing here waits for the card.
    """
    xt = x.transpose(-1, -2)
    dt = direction.transpose(-1, -2)
    c = x @ xt - torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    dm = -(x @ dt + direction @ xt)
    em = direction @ dt

    def ip(a, b):
        return torch.sum(a * b, dim=(-2, -1))

    a4 = ip(em, em)
    a3 = 2.0 * ip(dm, em)
    a2 = ip(dm, dm) + 2.0 * ip(c, em)
    a1 = 2.0 * ip(c, dm)
    a0 = ip(c, c) - eps**2
    roots = quartic.solve_quartic(a4, a3, a2, a1, a0)
    real_ok = roots.imag.abs() < 1e-5 * (1 + roots.real.abs())
    pos = roots.real > 0
    inf = torch.full_like(roots.real, float("inf"))
    eta_max = torch.where(real_ok & pos, roots.real, inf).amin(dim=-1)
    eta0 = torch.as_tensor(eta0, dtype=eta_max.dtype, device=eta_max.device)
    eta = torch.minimum(eta0, eta_max)
    eta = torch.where(a0 > 0, torch.minimum(eta, 0.5 * eta0), eta)
    return torch.clamp_min(eta, 1e-8)


class Landing(Method):
    """Landing (Ablin & Peyre 2022): combined field, identity land stage.

    direction:  D = R + lam (X X^T - I) X
    land:       identity (feasibility is asymptotic, kept inside an
                eps-ball by the exact safe step that rescales ctx.eta)
    """

    name = "landing"
    fused_stage = "landing"

    def __init__(self, lam: float = 1.0, eps: float = 0.5, safe_step: bool = True):
        self.lam = lam
        self.eps = eps
        self.safe_step = safe_step

    def fused_ready(self) -> bool:
        # The exact safe step rescales eta per matrix from a quartic solve;
        # it has no in-kernel form, so only the fixed-step variant fuses.
        return not self.safe_step

    def _field(self, x, g, ctx):
        if ctx.use_kernel:
            from ..kernels import ops as kops

            return kops.landing_field(x, g, self.lam)
        return stiefel.riemannian_gradient(x, g) + self.lam * stiefel.penalty_grad(x)

    def direction(self, x, g, ctx):
        d = self._field(x, g, ctx)
        if self.safe_step:
            ctx.eta = _safe_eta(x, d, ctx.eta, self.eps)[..., None, None]
        return d


# -------------------------------------------------------------- orthoptimizer


def _not_ported(what: str, entry: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {entry})")


_METHODS = {"pogo": Pogo, "landing": Landing}


def orthogonal(
    method: str,
    *,
    learning_rate: float | Callable = 1e-2,
    base_optimizer: Optional[GradientTransformation] = None,
    use_kernel: bool = False,
    safety_project_every: int = 0,
    seed: int = 0,
    grouping: str = "auto",
    watchdog: Any = None,
    tp_compress: bool = False,
    **method_kwargs,
) -> GradientTransformation:
    """Build an orthoptimizer, with the signature of
    ``repro.core.api.orthogonal``: ``"pogo"`` or ``"landing"``, on the
    fused or the two-stage group step as the module docstring says. Every
    combination this slice does not port raises ``NotImplementedError``
    naming its ROADMAP entry."""
    if method not in _METHODS:
        raise _not_ported(f"orthoptimizer {method!r}", "remaining methods + quartic")
    if watchdog is not None:
        raise _not_ported("the feasibility watchdog", "self-healing training")
    if safety_project_every:
        raise _not_ported("Newton-Schulz safety projection", "Newton-Schulz")
    if tp_compress:
        raise _not_ported("tensor-parallel compression", "sharded schedules")
    if grouping == "padded":
        raise _not_ported("grouping='padded'", "ragged megagroups")
    if grouping not in ("auto", "per_leaf"):
        raise ValueError(f"grouping must be 'auto' or 'per_leaf', got {grouping!r}")
    try:
        meth = _METHODS[method](**method_kwargs)
    except TypeError as e:
        raise TypeError(f"bad kwargs for orthoptimizer {method!r}: {e}") from None
    fused_base = optim_fused.resolve_fused_base(base_optimizer)
    fused = use_kernel and fused_base is not None and meth.fused_ready()
    if fused and meth.fused_stage != "pogo":
        raise _not_ported(
            f"the fused group step of {method!r} (safe_step=False with a base "
            "the kernel replays)", "Landing's fused branches")
    return _build(meth, fused_base if fused else None, base_optimizer,
                  learning_rate, seed, grouping, use_kernel)


def _build(method: Method, fused_base, base, learning_rate, seed, grouping,
           use_kernel) -> GradientTransformation:
    """The orthoptimizer: the fused group step when ``fused_base`` is
    given, else the two-stage group step."""

    def make_plan(params, leaves, treedef) -> GroupPlan:
        if isinstance(params, ConstraintSet):
            return params.stacked_plan()
        return plan_groups(leaves, treedef, grouping)

    def init(params):
        base_state = base.init(params) if base else ()
        leaves, treedef = tree.flatten(params)
        plan = make_plan(params, leaves, treedef)
        device = leaves[0].device if leaves else torch.device("cpu")
        dist = GroupedDistances(plan=plan, per_group=tuple(
            torch.zeros((grp.batch,), dtype=torch.float32, device=device)
            for grp in plan.groups
        ))
        return OrthoState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            base_state=base_state, rng=seed, last_distance=dist,
        )

    def stacks(group, leaves, gleaves, inplace):
        """The group's stored stack, its fp32 stack (the stored stack
        itself when ``inplace``) and its fp32 gradient stack."""
        xg = _gather_group(group, leaves)
        x32 = xg.to(_accum_dtype(xg.dtype)).contiguous()
        if inplace and x32.data_ptr() != xg.data_ptr():
            raise TypeError(
                "in-place steps need fp32 ConstraintSet stacks, got a "
                f"{xg.dtype} group of shape {tuple(xg.shape)}"
            )
        g32 = _gather_group(group, gleaves).to(x32.dtype).contiguous()
        return xg, x32, g32

    def fused_groups(plan, leaves, state, grads, eta0, inplace):
        """Every group through the fused step (base moments in-kernel)."""
        gleaves = tree.leaves(grads)
        mu_tree, nu_tree, base_count = fused_base.get_slots(state.base_state)
        mu_leaves = tree.leaves(mu_tree) if mu_tree is not None else None
        nu_leaves = tree.leaves(nu_tree) if nu_tree is not None else None
        mu_out: list = [None] * len(leaves)
        nu_out: list = [None] * len(leaves)
        results = []
        for group in plan.groups:
            xg, x32, g32 = stacks(group, leaves, gleaves, inplace)
            mug = (_gather_group(group, mu_leaves).contiguous()
                   if mu_leaves is not None else None)
            nug = (_gather_group_scalars(group, nu_leaves)
                   if nu_leaves is not None else None)
            ctx = StepCtx(x=x32, g=g32, eta=eta0, count=state.count,
                          use_kernel=True)
            slots = FusedSlots(kind=fused_base.kind, hyper=fused_base.hyper,
                               post_scale=fused_base.post_scale, mu=mug,
                               nu=nug, count=base_count)
            x_next, mu2, nu2, dist, _ = method.fused_step(
                x32, g32, ctx, slots, inplace=inplace
            )
            results.append((group, xg, x32, x_next, dist))
            if mu2 is not None:
                _scatter_group(group, mu2, mu_out)
            if nu2 is not None:
                _scatter_group_scalars(group, nu2, nu_out)
        mu_tree2 = tree.unflatten(tree.flatten(mu_tree)[1], mu_out) \
            if mu_leaves is not None else None
        nu_tree2 = tree.unflatten(tree.flatten(nu_tree)[1], nu_out) \
            if nu_leaves is not None else None
        return results, fused_base.set_slots(state.base_state, mu_tree2, nu_tree2)

    def two_stage_groups(plan, leaves, params, state, grads, eta0, inplace):
        """The base optimizer first, then each group through
        ``group_step`` (``repro/core/api.py:1296-1299, 1324-1383``)."""
        if base is None:
            g, base_state = grads, ()
        elif inplace and base.update_inplace is not None:
            g, base_state = base.update_inplace(grads, state.base_state, params)
        else:
            g, base_state = base.update(grads, state.base_state, params)
        gleaves = tree.leaves(g)
        results = []
        for group in plan.groups:
            xg, x32, g32 = stacks(group, leaves, gleaves, inplace)
            x_next = group_step(x32, g32, eta0, state.count, inplace)
            results.append((group, xg, x32, x_next, None))
        return results, base_state

    def group_step(x32, g32, eta, count, inplace):
        """One batched two-stage update of a group: the method's
        ``kernel_update`` on the kernel path, else direction, leap and
        land. With ``inplace`` X' ends up in ``x32``."""
        ctx = StepCtx(x=x32, g=g32, eta=eta, count=count, use_kernel=use_kernel)
        if use_kernel and method.kernel_update is not None:
            return method.kernel_update(x32, g32, ctx, inplace=inplace)
        d = method.direction(x32, g32, ctx)
        d.mul_(ctx.eta)  # direction() hands over a tensor of its own
        m = x32.sub_(d) if inplace else x32 - d
        x_next = method.land(m, ctx)
        return x32.copy_(x_next) if inplace and x_next is not x32 else x_next

    def run(params, state, grads, inplace):
        """Every group through its step. Returns ``(group, stored stack,
        fp32 stack, x_next)`` per group (``x_next`` is the stack itself
        when ``inplace``), the params' treedef and leaf count, and the new
        state."""
        leaves, treedef = tree.flatten(params)
        plan = make_plan(params, leaves, treedef)
        if any(grp.dtype.is_complex for grp in plan.groups):
            raise _not_ported("complex constraint groups",
                              "remaining methods + quartic")
        eta0 = (learning_rate(state.count) if callable(learning_rate)
                else learning_rate)
        if fused_base is not None:
            results, base_state = fused_groups(plan, leaves, state, grads,
                                               eta0, inplace)
        else:
            results, base_state = two_stage_groups(plan, leaves, params, state,
                                                   grads, eta0, inplace)
        dists = []
        for _, xg, x32, x_next, dist in results:
            if dist is None or xg.dtype != x32.dtype:
                # The telemetry gram (JAX's ``_measure``), of the stored
                # iterate: a reduced-precision stack after its cast.
                y = x_next if xg.dtype == x32.dtype else \
                    (xg + (x_next - x32).to(xg.dtype)).to(x32.dtype)
                dist = stiefel.manifold_distance(y)
            dists.append(dist.to(torch.float32))
        new_state = OrthoState(
            count=state.count + 1, base_state=base_state, rng=state.rng,
            last_distance=GroupedDistances(plan=plan, per_group=tuple(dists)),
            extras=state.extras,
        )
        return [r[:4] for r in results], treedef, len(leaves), new_state

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(
                f"{method.name} is a manifold optimizer; params are required"
            )
        results, treedef, n_leaves, new_state = run(params, state, grads, False)
        out: list = [None] * n_leaves
        for group, xg, x32, x_next in results:
            _scatter_group(group, (x_next - x32).to(xg.dtype), out)
        return tree.unflatten(treedef, out), new_state

    def update_inplace(grads, state, params=None):
        if not isinstance(params, ConstraintSet):
            raise TypeError("in-place steps take a ConstraintSet of params")
        return None, run(params, state, grads, True)[3]

    return GradientTransformation(init, update, tag=("orthogonal", method.name),
                                  update_inplace=update_inplace)


# ----------------------------------------------------------------- telemetry


def ortho_states(opt_state) -> list[OrthoState]:
    """Every :class:`OrthoState` inside an optimizer state (chained,
    nested in tuples, lists or dicts)."""
    if isinstance(opt_state, OrthoState):
        return [opt_state]
    if isinstance(opt_state, dict):
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (tuple, list)):
        return [s for item in opt_state for s in ortho_states(item)]
    return []


def _distances(opt_state) -> list:
    out = []
    for s in ortho_states(opt_state):
        if not isinstance(s.last_distance, GroupedDistances):
            raise TypeError("OrthoState.last_distance must be a GroupedDistances")
        out.extend(s.last_distance.per_group)
    return out


def max_distance(opt_state) -> torch.Tensor:
    """Max manifold distance across every orthoptimizer-managed matrix
    (a 0-d tensor on the state's device; reading it syncs)."""
    dists = _distances(opt_state)
    if not dists:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([d.max() for d in dists]).max()


def step_health(opt_state) -> StepHealth:
    """:class:`StepHealth` of the last step: scalar ``finite`` plus the
    worst feasibility residual, from telemetry the step already made."""
    return from_residual(max_distance(opt_state))


def leaf_distances(state: OrthoState):
    """Per-leaf max distance, as a tree with the params' structure."""
    ld = state.last_distance
    plan = ld.plan
    out: list = [None] * plan.n_leaves
    for group, arr in zip(plan.groups, ld.per_group):
        for m in group.members:
            out[m.leaf] = arr[m.offset:m.offset + m.count].max()
    return tree.unflatten(plan.treedef, out)
