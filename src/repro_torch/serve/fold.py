"""Fold trained orthogonal constraint stacks into inference weights
(``repro.serve.fold``).

Training keeps the constrained matrices in a
:class:`~repro_torch.core.api.ConstraintSet` (stacked ``(B, p, n)``
storage); serving consumes the parameter tree. This module writes a
trained set back into the transformer params (``models.ortho`` selects
the destinations, the same paths the optimizer partitioned on) and checks
that the folded weights sit on their Stiefel manifolds before the engine
may use them.

Feasibility contract: every folded matrix ``X`` (tall leaves measured
along their transpose, the optimizer's orientation) must have ``max ||X
X^T - I||_F <= atol``. POGO keeps feasibility at all times, so a
violation means the stack is corrupt or came from an infeasible method;
folding it would serve attention projections that are not the trained
operator, so the fold raises and names the worst leaf.
"""

from __future__ import annotations

import dataclasses

from ..core import stiefel
from ..core.api import ConstraintSet
from ..models import ortho

DEFAULT_ATOL = 1e-2


class FoldFeasibilityError(RuntimeError):
    """A folded matrix is off-manifold beyond ``atol``."""

    def __init__(self, path: str, distance: float, atol: float):
        super().__init__(
            f"folded leaf {path!r} is off-manifold: "
            f"max ||XX^H - I|| = {distance:.3e} > atol={atol:.3e}"
        )
        self.path = path
        self.distance = distance
        self.atol = atol


@dataclasses.dataclass(frozen=True)
class FoldResult:
    params: object          # the updated parameter tree
    n_leaves: int           # constrained leaves written
    max_distance: float     # worst post-fold feasibility residual
    worst_path: str         # leaf path of that residual


def extract_constraint_set(params, cfg, grouping: str = "auto") -> ConstraintSet:
    """Stack the constrained leaves of ``params`` into a ConstraintSet on
    their device, in the leaf order the optimizer's partition uses."""
    leaves = ortho.extract_constrained(params, cfg)
    if not leaves:
        raise ValueError(
            f"config {cfg.name!r} has no constrained families "
            f"(ortho_families={cfg.ortho_families!r})"
        )
    return ConstraintSet.from_tree(leaves, grouping, device=leaves[0].device)


def feasibility_distance(params, cfg):
    """Worst off-manifold residual over the constrained leaves of
    ``params``: ``(max_distance, worst_path)``. The serving watchdog
    re-checks a live engine's weights with it against the fold's ``atol``."""
    worst = 0.0
    worst_path = ""
    infos = ortho.orthogonal_leaf_info(params, cfg)
    leaves = ortho.extract_constrained(params, cfg)
    for (path, _shape), leaf in zip(infos, leaves):
        x = leaf.float()
        if x.shape[-2] > x.shape[-1]:
            x = x.transpose(-1, -2)
        d = float(stiefel.manifold_distance(x).max())
        if d > worst:
            worst, worst_path = d, path
    return worst, worst_path


def fold_constraint_set(params, cfg, cs: ConstraintSet, *,
                        atol: float = DEFAULT_ATOL) -> FoldResult:
    """Write the trained stacks of ``cs`` (built by
    :func:`extract_constraint_set` or over the same leaves) back into
    ``params`` and verify post-fold feasibility; raises
    :class:`FoldFeasibilityError` when any folded leaf exceeds ``atol``."""
    merged = ortho.merge_constrained(params, cfg, tuple(cs.to_tree()))
    worst, worst_path = feasibility_distance(merged, cfg)
    if worst > atol:
        raise FoldFeasibilityError(worst_path, worst, atol)
    n_leaves = len(ortho.extract_constrained(merged, cfg))
    return FoldResult(params=merged, n_leaves=n_leaves, max_distance=worst,
                      worst_path=worst_path)
