"""Orthoptimizers of the port: POGO and Landing on stacked constraint
groups.

Port of ``repro.core.api``. ``orthogonal(method, ...)`` buckets the param
leaves into ``(B, p, n)`` groups (:func:`plan_groups`) and runs each group
through one of two routes, chosen as the JAX package chooses them
(``repro/core/api.py:1154-1167``):

* the **fused group step**: ``use_kernel=True``, a base optimizer the
  kernel replays (none, ``trace``, ``scale_by_vadam``, chains of those with
  ``scale``) and a method with a fused stage (POGO without ``find_root``,
  Landing with ``safe_step=False``): ``Method.fused_step`` ->
  ``kernels.ops.fused_group_step``, one launch per group. Under a mesh
  with a "model" dim (``distributed.shard_hints.set_mesh``) a group of
  ``DTensor`` leaves takes its **tensor-parallel** form instead
  (``repro/core/api.py:1433-1480``): each rank runs ``tp_gram`` on its
  ``(B_local, p, n_local)`` block, one all-reduce of the ``(B, K)`` gram
  payload over "model", then ``tp_apply`` in place, when the step has no
  watchdog and no ``safety_project_every`` and the group is fp32
  (``:1272-1282``);
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

The feasibility watchdog (``watchdog=WatchdogConfig(...)``) escalates a
group whose previous residual crossed ``soft`` and repairs every matrix
whose post-step residual exceeds the repair threshold with Newton-Schulz,
in place; with ``use_kernel`` on a card that is a kernel of
``csrc/newton_schulz_tc.cu`` or ``csrc/newton_schulz.cu``
(``ops.plan_newton_schulz``), gated per matrix by a device mask (no host
sync). POGO's ``find_root`` lands with the quartic-root lambda, and
``safety_project_every`` re-projects every k-th step.

Combinations this slice does not port raise ``NotImplementedError`` naming
the ROADMAP entry that holds them: methods other than POGO and Landing,
complex groups, ``tp_compress``, ``DTensor`` leaves off the TP route, and
padded megagroups.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import tree
from .._device import resolve_device
from ..distributed import shard_hints
from ..health import StepHealth, from_residual
from ..optim import fused as optim_fused
from ..optim.transform import GradientTransformation
from . import quartic, stiefel
from .schedule import GroupMember, GroupPlan, GroupSpec, plan_groups, tp_spec

__all__ = [
    "ConstraintSet", "FusedSlots", "GroupMember", "GroupPlan", "GroupSpec",
    "GroupedDistances", "Landing", "Method", "OrthoConfig", "OrthoState",
    "Pogo", "StepCtx", "WatchdogConfig", "WatchdogState", "constraint_step",
    "leaf_distances", "max_distance", "method_overrides", "orthogonal",
    "plan_groups", "step_health", "watchdog_summary",
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


def _gather_local(group: GroupSpec, leaves, scalars: bool = False):
    """The rank's local stack of a group of ``DTensor`` leaves: ``(B_local,
    p, n_local)`` (or ``(B_local,)`` per-matrix scalars), the local block
    itself for a single member (no copy, so in-place steps reach it)."""
    parts = []
    for m in group.members:
        if m.transpose:
            raise _not_ported("tall (transposed) leaves under TP",
                              "sharded schedules")
        loc = shard_hints.local_block(leaves[m.leaf]) if not scalars else \
            leaves[m.leaf].to_local()
        parts.append(loc.reshape(-1) if scalars else
                     loc.reshape(-1, m.p, loc.shape[-1]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _scatter_local(group: GroupSpec, stacked, out: list, like) -> None:
    """Split a local stack back into ``DTensor`` member leaves with the
    mesh, placements and global shapes of ``like`` (no collective)."""
    off = 0
    for m in group.members:
        shape = like[m.leaf].to_local().shape
        # Per-matrix scalars are (B_local,); matrices (B_local, p, n_local).
        count = math.prod(shape) if stacked.dim() == 1 else math.prod(shape[:-2])
        out[m.leaf] = shard_hints.wrap_like(
            stacked[off:off + count].reshape(shape), like[m.leaf])
        off += count


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
        transpose in; ``to_tree`` transposes them back out). ``DTensor``
        leaves stay where they are, and each must be a group of its own,
        untransposed, ``(B, p, n)``: the stack is the leaf itself."""
        device = resolve_device(device)
        leaves, treedef = tree.flatten(params)
        if any(shard_hints.is_dtensor(x) for x in leaves):
            plan = plan_groups(leaves, treedef, grouping)
            for g in plan.groups:
                m = g.members[0]
                x = leaves[m.leaf]
                if len(g.members) > 1 or m.transpose or x.ndim != 3:
                    raise ValueError(
                        "a ConstraintSet of DTensor leaves needs one (B, p, n) "
                        f"leaf per group, wide (p <= n); got {tuple(x.shape)}")
            return cls(plan, [leaves[g.members[0].leaf] for g in plan.groups])
        leaves = [torch.as_tensor(x).to(device) for x in leaves]
        plan = plan_groups(leaves, treedef, grouping)
        stacks = tuple(_gather_group(g, leaves).contiguous() for g in plan.groups)
        return cls(plan, stacks)

    def to_tree(self):
        out: list = [None] * self.plan.n_leaves
        for group, stack in zip(self.plan.groups, self.stacks):
            if shard_hints.is_dtensor(stack):  # the leaf itself (from_tree)
                out[group.members[0].leaf] = stack
                continue
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
    ``pv`` (per-matrix valid rows; ``None`` for the uniform groups of
    this slice), and ``scratch``, what one stage hands the next (the
    watchdog's blend operands and repair mask)."""

    x: torch.Tensor
    g: torch.Tensor
    eta: Any
    count: torch.Tensor
    use_kernel: bool = False
    pv: Optional[torch.Tensor] = None
    scratch: dict = dataclasses.field(default_factory=dict)


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

    def escalated(self) -> Optional["Method"]:
        """The careful sibling the feasibility watchdog escalates a
        drifting group to, or ``None`` (the repair threshold tightens to
        ``soft`` instead)."""
        return None

    def careful_blend(self) -> bool:
        """True if the careful sibling folds into this method's own land
        stage as per-matrix scalars (``ctx.scratch['wd_blend']``), so the
        driver needs neither a sibling branch nor the Newton-Schulz
        repair; the method records the repair mask in
        ``ctx.scratch['wd_repaired']``."""
        return False

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
        self.lam = lam
        self.find_root = find_root

    def fused_ready(self) -> bool:
        return not self.find_root  # the quartic root has no fused form

    def escalated(self) -> Optional["Method"]:
        return None if self.find_root else Pogo(lam=self.lam, find_root=True)

    def careful_blend(self) -> bool:
        return not self.find_root

    def direction(self, x, g, ctx):
        return stiefel.riemannian_gradient(x, g)

    def land(self, m, ctx):
        c = stiefel.gram(m)
        wd_blend = None if self.find_root else ctx.scratch.get("wd_blend")
        if self.find_root:
            lam = quartic.optimal_lambda(m, fallback=self.lam, pv=ctx.pv)
            lam = lam[..., None, None].to(m.real.dtype)
        elif wd_blend is not None:
            lam = self._blend_lambda(m, c, ctx, wd_blend)
        else:
            lam = self.lam
        return (1.0 + lam) * m - lam * (c @ m)

    def _blend_lambda(self, m, c, ctx, wd_blend):
        """Watchdog-blended per-matrix land lambda
        (``repro/core/api.py:515-560``): matrices of an escalated group, or
        whose pre-land gram diagonal ``||diag(C) - 1||`` exceeds ``hard``,
        land with the quartic-root lambda of their gram; the rest keep
        ``self.lam``. JAX skips the solve under a ``lax.cond`` when no
        matrix needs it; here it always runs (small (B, p, p) operands)
        and a ``where`` selects, so nothing waits for the card."""
        esc, hard = wd_blend
        eye = torch.eye(m.shape[-2], dtype=c.dtype, device=c.device)
        diag_dev = torch.diagonal(c - eye, dim1=-2, dim2=-1).real
        dist_m = torch.sqrt(torch.sum(diag_dev * diag_dev, dim=-1))
        rep = torch.isfinite(dist_m) & (dist_m > hard)
        need = esc | rep
        ctx.scratch["wd_repaired"] = rep
        lam_vec = quartic.optimal_lambda_from_gram(c - eye, fallback=self.lam)
        lam_vec = torch.where(need, lam_vec, torch.full_like(lam_vec, self.lam))
        return lam_vec[..., None, None].to(m.real.dtype)

    def kernel_update(self, x, g, ctx, inplace=False):
        from ..kernels import ops as kops

        return kops.pogo_update(x, g, ctx.eta, lam=self.lam,
                                find_root=self.find_root, inplace=inplace)


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

    def escalated(self) -> Optional["Method"]:
        if self.safe_step:
            return None  # already the careful variant
        return Landing(lam=self.lam, eps=self.eps, safe_step=True)

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


# ------------------------------------------------------------------- configs


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Feasibility watchdog and drift repair (``repro/core/api.py:813``).

    ``soft``: a group whose previous residual crossed it runs the method's
    careful sibling (:meth:`Method.escalated`) until the residual drops
    below ``soft * release``; methods without one, and fused groups,
    tighten the repair threshold to ``soft`` instead. ``hard``: every
    matrix whose post-step residual exceeds it (finite only) is
    re-orthonormalised by ``ns_iters`` Newton-Schulz iterations in the
    same step."""

    soft: float = 1e-3
    hard: float = 1e-1
    release: float = 0.25
    ns_iters: int = 12


class WatchdogState(NamedTuple):
    """Per-group watchdog telemetry in ``OrthoState.extras``: the
    escalation latch (0-d bool) and cumulative repair and escalation
    counts (0-d int32), all on the card; :func:`watchdog_summary` reads
    them on the host."""

    escalated: tuple
    repairs: tuple
    escalations: tuple


@dataclasses.dataclass(frozen=True)
class OrthoConfig:
    """Driver-level knobs shared by every method: the fields of
    ``repro.core.api.OrthoConfig`` that no method declares."""

    learning_rate: Any = 1e-2
    base_optimizer: Optional[GradientTransformation] = None
    use_kernel: bool = False
    safety_project_every: int = 0
    seed: int = 0
    grouping: str = "auto"
    watchdog: Optional[WatchdogConfig] = None
    tp_compress: bool = False


# -------------------------------------------------------------- orthoptimizer


def _not_ported(what: str, entry: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {entry})")


_METHODS = {"pogo": Pogo, "landing": Landing}
_METHOD_FIELDS = {"pogo": ("lam", "find_root"),
                  "landing": ("lam", "eps", "safe_step")}


def method_overrides(method: str, **candidates) -> dict:
    """Filter kwargs down to those ``method`` declares, dropping ``None``
    (``repro.core.api.method_overrides``)."""
    if method not in _METHODS:
        raise _not_ported(f"orthoptimizer {method!r}", "remaining methods + quartic")
    fields = _METHOD_FIELDS[method]
    return {k: v for k, v in candidates.items() if v is not None and k in fields}


def orthogonal(
    method: str,
    *,
    learning_rate: float | Callable = 1e-2,
    base_optimizer: Optional[GradientTransformation] = None,
    use_kernel: bool = False,
    safety_project_every: int = 0,
    seed: int = 0,
    grouping: str = "auto",
    watchdog: Optional[WatchdogConfig] = None,
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
    if watchdog is not None and not isinstance(watchdog, WatchdogConfig):
        raise TypeError(f"watchdog must be a WatchdogConfig, got {type(watchdog).__name__}")
    if tp_compress:
        raise _not_ported("tensor-parallel compression",
                          "sharded schedules (tp_compress)")
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
    cfg = OrthoConfig(learning_rate=learning_rate, base_optimizer=base_optimizer,
                      use_kernel=use_kernel,
                      safety_project_every=safety_project_every, seed=seed,
                      grouping=grouping, watchdog=watchdog)
    return _build(meth, fused_base if fused else None, cfg)


def _fresh_watchdog_state(plan: GroupPlan, device) -> WatchdogState:
    def zeros(dtype):
        return tuple(torch.zeros((), dtype=dtype, device=device) for _ in plan.groups)

    return WatchdogState(escalated=zeros(torch.bool), repairs=zeros(torch.int32),
                         escalations=zeros(torch.int32))


def _build(method: Method, fused_base, cfg: OrthoConfig) -> GradientTransformation:
    """The orthoptimizer: the fused group step when ``fused_base`` is
    given, else the two-stage group step; with ``cfg.watchdog`` the
    watchdog's escalation and repair around each group step
    (``repro/core/api.py:1483-1566, 1590-1625``)."""
    base = cfg.base_optimizer
    use_kernel = cfg.use_kernel
    wd = cfg.watchdog
    careful = method.escalated() if wd is not None else None
    # Escalation and repair fold into the land stage (no sibling branch,
    # no Newton-Schulz) where the land stage runs.
    blend_careful = (careful is not None and method.careful_blend()
                     and not (use_kernel and method.kernel_update is not None))

    def make_plan(params, leaves, treedef) -> GroupPlan:
        if isinstance(params, ConstraintSet):
            return params.stacked_plan()
        ax = shard_hints.tp_axis()
        return plan_groups(leaves, treedef, cfg.grouping,
                           tp_shards=ax[1] if ax else 1)

    def tp_specs(plan, leaves):
        """Per group, its :class:`~.schedule.TpSpec` when it takes the TP
        step (``repro/core/api.py:1272-1282``: fused, no watchdog, no
        safety projection, a "model" dim of width >= 2, fp32, and here
        ``DTensor`` leaves), else ``None``. A group of ``DTensor`` leaves
        that fails the gates raises: it has no other route."""
        ax = shard_hints.tp_axis()
        tp_now = (fused_base is not None and wd is None
                  and not cfg.safety_project_every and ax is not None)
        specs = []
        for grp in plan.groups:
            sharded = any(shard_hints.is_dtensor(leaves[m.leaf])
                          for m in grp.members)
            spec = (tp_spec(grp.n, ax[1], axis=ax[0])
                    if tp_now and sharded and grp.dtype == torch.float32 else None)
            if sharded and spec is None:
                raise _not_ported(
                    f"DTensor leaves of a ({grp.p}, {grp.n}) {grp.dtype} group off "
                    "the TP route (it needs a mesh with a 'model' dim of width "
                    ">= 2, the fused step, fp32, no watchdog and no "
                    "safety_project_every)", "sharded schedules")
            specs.append(spec)
        return specs

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
            base_state=base_state,
            rng=torch.tensor([0, cfg.seed], dtype=torch.int64, device=device),
            last_distance=dist,
            extras=_fresh_watchdog_state(plan, device) if wd is not None else (),
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

    def project_due(state) -> bool:
        """Whether this step runs the safety projection (JAX's ``lax.cond``
        on ``count % k``; one host read of the step counter)."""
        k = cfg.safety_project_every
        return bool(k) and (int(state.count) + 1) % k == 0

    def repair(x_next, dist, thresh):
        """Newton-Schulz repair of the matrices with ``isfinite(dist) &
        (dist > thresh)``, in place on ``x_next`` and ``dist``: the kernel
        with ``use_kernel`` (the plain version on a CPU tensor), else the
        plain projection. Returns the ``(B,)`` repair mask."""
        from ..kernels import newton_schulz as kns
        from ..kernels import ops as kops

        if use_kernel:
            return kops.newton_schulz_repair(x_next, dist, thresh, wd.ns_iters)
        rep = torch.isfinite(dist) & (dist > thresh)
        kns.run_plain(x_next, wd.ns_iters, out=x_next, mask=rep, dist=dist)
        return rep

    def tp_group_step(group, spec, leaves, gleaves, mu_leaves, nu_leaves,
                      eta0, base_count, inplace):
        """One group's TP step on this rank (``repro/core/api.py:1433``):
        its local blocks zero-padded to ``spec.local_n`` columns, the local
        partial, ONE all-reduce of the payload over "model", the finish,
        and the crop. With ``inplace`` X' and mu' are written over the
        local blocks and nu' over nu's. Returns ``(x_local, x_next, mu',
        nu', dist)`` as local tensors; ``dist`` covers this rank's
        matrices and is the same on every rank of the "model" group."""
        from ..kernels import ops as kops

        x_loc = _gather_local(group, leaves)
        if inplace and len(group.members) > 1:
            raise TypeError("in-place TP steps need one leaf per group "
                            "(a ConstraintSet of DTensor stacks)")
        n_loc = x_loc.shape[-1]
        pad = spec.local_n - n_loc

        def padded(t):
            if t is None:
                return None
            t = t.contiguous()
            return torch.nn.functional.pad(t, (0, pad)) if pad else t

        mu_loc = (_gather_local(group, mu_leaves) if mu_leaves is not None
                  else None)
        nu_loc = (_gather_local(group, nu_leaves, scalars=True)
                  if nu_leaves is not None else None)
        x32 = padded(x_loc)
        mu32 = padded(mu_loc)
        payload, gbase, mu2 = kops.fused_group_step_tp_partial(
            x32, padded(_gather_local(group, gleaves)), base_kind=fused_base.kind,
            hyper=fused_base.hyper, post_scale=fused_base.post_scale, mu=mu32,
            inplace=inplace)
        shard_hints.all_reduce_payload(payload)
        x2, nu2, dist, _ = kops.fused_group_step_tp_finish(
            x32, gbase, payload, eta0, method=method.fused_stage, lam=method.lam,
            base_kind=fused_base.kind, hyper=fused_base.hyper,
            post_scale=fused_base.post_scale, nu=nu_loc, count=base_count,
            inplace=inplace)
        if pad:
            x2 = x2[..., :n_loc]
            mu2 = mu2[..., :n_loc] if mu2 is not None else None
            if inplace:
                x2 = x_loc.copy_(x2)
                mu2 = mu_loc.copy_(mu2) if mu2 is not None else None
        if inplace and nu2 is not None:
            nu2 = nu_loc.copy_(nu2)
        return x_loc, x2, mu2, nu2, dist.to(torch.float32)

    def fused_groups(plan, leaves, state, grads, eta0, inplace, escs, project,
                     specs):
        """Every group through the fused step (base moments in-kernel), in
        its TP form where ``specs`` has a spec for it."""
        gleaves = tree.leaves(grads)
        mu_tree, nu_tree, base_count = fused_base.get_slots(state.base_state)
        mu_leaves = tree.leaves(mu_tree) if mu_tree is not None else None
        nu_leaves = tree.leaves(nu_tree) if nu_tree is not None else None
        mu_out: list = [None] * len(leaves)
        nu_out: list = [None] * len(leaves)
        results = []
        for group, esc, spec in zip(plan.groups, escs, specs):
            if spec is not None:
                x_loc, x_next, mu2, nu2, dist = tp_group_step(
                    group, spec, leaves, gleaves, mu_leaves, nu_leaves, eta0,
                    base_count, inplace)
                results.append((group, x_loc, x_loc, x_next, dist, None))
                if mu2 is not None:
                    _scatter_local(group, mu2, mu_out, mu_leaves)
                if nu2 is not None:
                    _scatter_local(group, nu2, nu_out, nu_leaves)
                continue
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
            if project:
                y = stiefel.project_newton_schulz(x_next)
                x_next = x_next.copy_(y) if inplace else y
                dist = stiefel.manifold_distance(x_next).to(torch.float32)
            rep = None
            if wd is not None:
                thresh = torch.where(esc, wd.soft, wd.hard)
                rep = repair(x_next, dist, thresh)
            results.append((group, xg, x32, x_next, dist, rep))
            if mu2 is not None:
                _scatter_group(group, mu2, mu_out)
            if nu2 is not None:
                _scatter_group_scalars(group, nu2, nu_out)
        mu_tree2 = tree.unflatten(tree.flatten(mu_tree)[1], mu_out) \
            if mu_leaves is not None else None
        nu_tree2 = tree.unflatten(tree.flatten(nu_tree)[1], nu_out) \
            if nu_leaves is not None else None
        return results, fused_base.set_slots(state.base_state, mu_tree2, nu_tree2)

    def two_stage_groups(plan, leaves, params, state, grads, eta0, inplace,
                         escs, project):
        """The base optimizer first, then each group through
        ``group_step`` (``repro/core/api.py:1296-1299, 1324-1383``), under
        the watchdog's dispatch (``:1520-1549``) when it is on."""
        if base is None:
            g, base_state = grads, ()
        elif inplace and base.update_inplace is not None:
            g, base_state = base.update_inplace(grads, state.base_state, params)
        else:
            g, base_state = base.update(grads, state.base_state, params)
        gleaves = tree.leaves(g)
        results = []
        for group, esc in zip(plan.groups, escs):
            xg, x32, g32 = stacks(group, leaves, gleaves, inplace)
            meth, scratch, thresh = method, {}, None
            if wd is not None and blend_careful:
                scratch["wd_blend"] = (esc, wd.hard)
            elif wd is not None and careful is not None:
                # A per-group branch on a device flag: one host read.
                meth = careful if bool(esc) else method
                thresh = wd.hard
            elif wd is not None:
                thresh = torch.where(esc, wd.soft, wd.hard)
            x_next = group_step(meth, x32, g32, eta0, state.count, inplace, scratch)
            if project:
                y = stiefel.project_newton_schulz(x_next)
                x_next = x_next.copy_(y) if inplace else y
            dist, rep = None, scratch.get("wd_repaired")
            if wd is not None and rep is None:
                dist = stiefel.manifold_distance(x_next).to(torch.float32)
                rep = repair(x_next, dist, thresh)
            results.append((group, xg, x32, x_next, dist, rep))
        return results, base_state

    def group_step(meth, x32, g32, eta, count, inplace, scratch):
        """One batched two-stage update of a group: the method's
        ``kernel_update`` on the kernel path, else direction, leap and
        land. With ``inplace`` X' ends up in ``x32``."""
        ctx = StepCtx(x=x32, g=g32, eta=eta, count=count, use_kernel=use_kernel,
                      scratch=scratch)
        if use_kernel and meth.kernel_update is not None:
            return meth.kernel_update(x32, g32, ctx, inplace=inplace)
        d = meth.direction(x32, g32, ctx)
        d.mul_(ctx.eta)  # direction() hands over a tensor of its own
        m = x32.sub_(d) if inplace else x32 - d
        x_next = meth.land(m, ctx)
        return x32.copy_(x_next) if inplace and x_next is not x32 else x_next

    def escalations(plan, state):
        """Per group, whether it runs escalated this step: decided from
        the previous step's residual with hysteresis (a NaN residual
        compares False on both thresholds), on the card."""
        wstate = state.extras
        if (not isinstance(wstate, WatchdogState)
                or len(wstate.escalated) != len(plan.groups)):
            wstate = _fresh_watchdog_state(plan, state.count.device)
        prev = state.last_distance
        use_prev = (isinstance(prev, GroupedDistances)
                    and len(prev.per_group) == len(plan.groups))
        escs = []
        for gi, esc_prev in enumerate(wstate.escalated):
            prev_max = (prev.per_group[gi].max().to(torch.float32) if use_prev
                        else torch.zeros((), device=esc_prev.device))
            escs.append(prev_max > torch.where(esc_prev, wd.soft * wd.release,
                                               wd.soft))
        return wstate, escs

    def run(params, state, grads, inplace):
        """Every group through its step. Returns ``(group, stored stack,
        fp32 stack, x_next)`` per group (``x_next`` is the stack itself
        when ``inplace``; local blocks for a TP group), the groups' TP
        specs, the params' leaves and treedef, and the new state."""
        leaves, treedef = tree.flatten(params)
        plan = make_plan(params, leaves, treedef)
        if any(grp.dtype.is_complex for grp in plan.groups):
            raise _not_ported("complex constraint groups",
                              "remaining methods + quartic")
        eta0 = (cfg.learning_rate(state.count) if callable(cfg.learning_rate)
                else cfg.learning_rate)
        wstate = None
        escs = [None] * len(plan.groups)
        if wd is not None:
            wstate, escs = escalations(plan, state)
        project = project_due(state)
        specs = tp_specs(plan, leaves)
        if fused_base is not None:
            results, base_state = fused_groups(plan, leaves, state, grads,
                                               eta0, inplace, escs, project,
                                               specs)
        else:
            results, base_state = two_stage_groups(plan, leaves, params, state,
                                                   grads, eta0, inplace, escs,
                                                   project)
        dists = []
        for _, xg, x32, x_next, dist, _ in results:
            if dist is None or xg.dtype != x32.dtype:
                # The telemetry gram (JAX's ``_measure``), of the stored
                # iterate: a reduced-precision stack after its cast.
                y = x_next if xg.dtype == x32.dtype else \
                    (xg + (x_next - x32).to(xg.dtype)).to(x32.dtype)
                dist = stiefel.manifold_distance(y)
            dists.append(dist.to(torch.float32))
        extras = state.extras
        if wd is not None:
            extras = WatchdogState(
                escalated=tuple(escs),
                repairs=tuple(r + rep.sum(dtype=torch.int32) for r, (*_, rep)
                              in zip(wstate.repairs, results)),
                escalations=tuple(e + (esc & ~prev).to(torch.int32) for e, esc, prev
                                  in zip(wstate.escalations, escs, wstate.escalated)),
            )
        new_state = OrthoState(
            count=state.count + 1, base_state=base_state, rng=state.rng,
            last_distance=GroupedDistances(plan=plan, per_group=tuple(dists)),
            extras=extras,
        )
        return [r[:4] for r in results], specs, leaves, treedef, new_state

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(
                f"{method.name} is a manifold optimizer; params are required"
            )
        results, specs, leaves, treedef, new_state = run(params, state, grads,
                                                         False)
        out: list = [None] * len(leaves)
        for (group, xg, x32, x_next), spec in zip(results, specs):
            if spec is not None:  # local updates, as DTensors like the leaves
                _scatter_local(group, x_next - x32, out, leaves)
            else:
                _scatter_group(group, (x_next - x32).to(xg.dtype), out)
        return tree.unflatten(treedef, out), new_state

    def update_inplace(grads, state, params=None):
        if not isinstance(params, ConstraintSet):
            raise TypeError("in-place steps take a ConstraintSet of params")
        return None, run(params, state, grads, True)[4]

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


def watchdog_summary(opt_state) -> Optional[dict]:
    """Host-side snapshot of the watchdog's counters: total ``repairs``,
    ``escalations`` and the per-group ``escalated`` latches, or ``None``
    when no state carries a :class:`WatchdogState`."""
    repairs = escalations = 0
    escalated: list = []
    found = False
    for s in ortho_states(opt_state):
        w = s.extras
        if not isinstance(w, WatchdogState):
            continue
        found = True
        repairs += sum(int(r) for r in w.repairs)
        escalations += sum(int(e) for e in w.escalations)
        escalated.extend(bool(e) for e in w.escalated)
    if not found:
        return None
    return {"repairs": repairs, "escalations": escalations, "escalated": escalated}
