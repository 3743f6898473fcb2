"""Manifold primitives, constraint-group scheduling and the orthoptimizer."""

from . import stiefel
from .api import (
    ConstraintSet,
    GroupedDistances,
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
    "GroupedDistances", "OrthoState", "Pogo", "constraint_step",
    "leaf_distances", "max_distance", "orthogonal", "plan_groups",
    "step_health", "stiefel",
]
