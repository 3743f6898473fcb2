"""Manifold primitives, constraint-group scheduling and the orthoptimizer."""

from . import quartic, stiefel
from .api import (
    ConstraintSet,
    GroupedDistances,
    Landing,
    OrthoConfig,
    OrthoState,
    Pogo,
    WatchdogConfig,
    WatchdogState,
    constraint_step,
    leaf_distances,
    max_distance,
    method_overrides,
    orthogonal,
    step_health,
    watchdog_summary,
)
from .schedule import GroupMember, GroupPlan, GroupSpec, plan_groups

__all__ = [
    "ConstraintSet", "GroupMember", "GroupPlan", "GroupSpec",
    "GroupedDistances", "Landing", "OrthoConfig", "OrthoState", "Pogo",
    "WatchdogConfig", "WatchdogState", "constraint_step", "leaf_distances",
    "max_distance", "method_overrides", "orthogonal", "plan_groups",
    "quartic", "step_health", "stiefel", "watchdog_summary",
]
