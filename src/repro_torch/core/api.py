"""Orthoptimizer of the port: POGO on stacked constraint groups
through the fused group step.

Port of the fused path of ``repro.core.api``: ``orthogonal("pogo",
use_kernel=True, base_optimizer=trace|vadam|None)`` buckets the param
leaves into ``(B, p, n)`` groups (:func:`plan_groups`) and runs each group
through ``Pogo.fused_step`` -> ``kernels.ops.fused_group_step``, one
kernel launch per group on the card. :class:`ConstraintSet` keeps the
groups stacked at rest; :func:`constraint_step` updates its stacks and the
optimizer moments in place.

Combinations this slice does not port raise ``NotImplementedError`` naming
the ROADMAP entry that holds them: the unfused two-stage path
(``use_kernel=False`` or a base the kernel cannot replay), methods other
than POGO, the feasibility watchdog, Newton-Schulz safety projection,
tensor parallelism and padded megagroups.
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
from . import stiefel
from .schedule import GroupMember, GroupPlan, GroupSpec, plan_groups

__all__ = [
    "ConstraintSet", "FusedSlots", "GroupMember", "GroupPlan", "GroupSpec",
    "GroupedDistances", "Method", "OrthoState", "Pogo", "StepCtx",
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
    state into a jitted step. Here the fused kernel **writes X' over the
    param stacks and the new moments over the state's moment buffers in
    place**: the returned ``params`` is the same object, and no param-sized
    copy is made. The returned state is a new :class:`OrthoState` whose
    moment tensors are the updated originals. Gradients are only read.
    The third output is the step's :class:`~repro_torch.health.StepHealth`.
    """
    if opt.update_inplace is None:
        raise TypeError("constraint_step needs an optimizer built by orthogonal()")

    def step(params: ConstraintSet, state, grads: ConstraintSet):
        state = opt.update_inplace(params, state, grads)
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
    orientation, the learning rate, the step count, and ``pv`` (per-matrix
    valid rows; ``None`` for the uniform groups of this slice)."""

    x: torch.Tensor
    g: torch.Tensor
    eta: Any
    count: torch.Tensor
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


class Method:
    """One orthoptimizer. In this slice a method is only its fused group
    step: base moments, direction, leap, land and telemetry in one kernel."""

    name: str = "?"
    fused_stage: Optional[str] = None
    lam: float = 0.5

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


# -------------------------------------------------------------- orthoptimizer


def _not_ported(what: str, entry: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {entry})")


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
    ``repro.core.api.orthogonal``. This slice ports
    ``orthogonal("pogo", use_kernel=True, base_optimizer=...)`` with a
    base the fused kernel replays (none, ``trace``, ``scale_by_vadam``,
    chains of those with ``scale``); every other combination raises
    ``NotImplementedError`` naming its ROADMAP entry."""
    if method != "pogo":
        entry = ("Landing's fused branches" if method == "landing"
                 else "remaining methods + quartic")
        raise _not_ported(f"orthoptimizer {method!r}", entry)
    if not use_kernel:
        raise _not_ported("the unfused two-stage path (use_kernel=False)",
                          "unfused kernels")
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
    fused_base = optim_fused.resolve_fused_base(base_optimizer)
    if fused_base is None:
        raise _not_ported(
            "a base optimizer the fused kernel cannot replay", "unfused kernels"
        )
    try:
        meth = Pogo(**method_kwargs)
    except TypeError as e:
        raise TypeError(f"bad kwargs for orthoptimizer {method!r}: {e}") from None
    return _build(meth, fused_base, base_optimizer, learning_rate, seed,
                  grouping)


def _build(method: Method, fused_base, base, learning_rate, seed,
           grouping) -> GradientTransformation:

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

    def run(params, state, grads, inplace):
        """Every group through the fused step. Returns ``(group, stored
        stack, fp32 stack, x_next)`` per group (``x_next`` is the stack
        itself when ``inplace``), the params' treedef and leaf count, and
        the new state."""
        leaves, treedef = tree.flatten(params)
        plan = make_plan(params, leaves, treedef)
        gleaves = tree.leaves(grads)
        mu_tree, nu_tree, base_count = fused_base.get_slots(state.base_state)
        mu_leaves = tree.leaves(mu_tree) if mu_tree is not None else None
        nu_leaves = tree.leaves(nu_tree) if nu_tree is not None else None
        eta0 = (learning_rate(state.count) if callable(learning_rate)
                else learning_rate)
        mu_out: list = [None] * len(leaves)
        nu_out: list = [None] * len(leaves)
        results, dists = [], []
        for group in plan.groups:
            xg = _gather_group(group, leaves)
            x32 = xg.to(torch.float32).contiguous()
            if inplace and x32.data_ptr() != xg.data_ptr():
                raise TypeError(
                    "in-place steps need fp32 ConstraintSet stacks, got a "
                    f"{xg.dtype} group of shape {tuple(xg.shape)}"
                )
            g32 = _gather_group(group, gleaves).to(torch.float32).contiguous()
            mug = (_gather_group(group, mu_leaves).contiguous()
                   if mu_leaves is not None else None)
            nug = (_gather_group_scalars(group, nu_leaves)
                   if nu_leaves is not None else None)
            ctx = StepCtx(x=x32, g=g32, eta=eta0, count=state.count)
            slots = FusedSlots(kind=fused_base.kind, hyper=fused_base.hyper,
                               post_scale=fused_base.post_scale, mu=mug,
                               nu=nug, count=base_count)
            x_next, mu2, nu2, dist, _ = method.fused_step(
                x32, g32, ctx, slots, inplace=inplace
            )
            if xg.dtype != torch.float32:
                # Telemetry measures the stored (cast) iterate.
                y = (xg + (x_next - x32).to(xg.dtype)).to(torch.float32)
                dist = stiefel.manifold_distance(y)
            results.append((group, xg, x32, x_next))
            dists.append(dist.to(torch.float32))
            if mu2 is not None:
                _scatter_group(group, mu2, mu_out)
            if nu2 is not None:
                _scatter_group_scalars(group, nu2, nu_out)
        mu_tree2 = tree.unflatten(tree.flatten(mu_tree)[1], mu_out) \
            if mu_leaves is not None else None
        nu_tree2 = tree.unflatten(tree.flatten(nu_tree)[1], nu_out) \
            if nu_leaves is not None else None
        new_state = OrthoState(
            count=state.count + 1,
            base_state=fused_base.set_slots(state.base_state, mu_tree2, nu_tree2),
            rng=state.rng,
            last_distance=GroupedDistances(plan=plan, per_group=tuple(dists)),
            extras=state.extras,
        )
        return results, treedef, len(leaves), new_state

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

    def update_inplace(params, state, grads):
        if not isinstance(params, ConstraintSet):
            raise TypeError("in-place steps take a ConstraintSet of params")
        return run(params, state, grads, True)[3]

    return GradientTransformation(init, update, update_inplace=update_inplace)


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
