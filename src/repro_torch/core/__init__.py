"""Manifold primitives, constraint-group scheduling and the orthoptimizer."""

from . import quartic, stiefel
from .api import (
    ConstraintSet,
    GroupedDistances,
    Landing,
    OrthoState,
    Pogo,
    constraint_step,
    leaf_distances,
    max_distance,
    orthogonal,
    step_health,
)
from .schedule import GroupMember, GroupPlan, GroupSpec, plan_groups

__all__ = [
    "ConstraintSet", "GroupMember", "GroupPlan", "GroupSpec",
    "GroupedDistances", "Landing", "OrthoState", "Pogo", "constraint_step",
    "leaf_distances", "max_distance", "orthogonal", "plan_groups",
    "quartic", "step_health", "stiefel",
]
