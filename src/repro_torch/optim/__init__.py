"""Base optimizers of the port: the linear ones the fused step replays
(trace, VAdam) and the opaque ones the two-stage step runs first (Adam,
AdamW, schedules)."""

from .alias import (
    AddDecayedWeightsState,
    ScaleByAdamState,
    ScaleByVAdamState,
    TraceState,
    adam,
    adamw,
    add_decayed_weights,
    scale_by_adam,
    scale_by_vadam,
    sgd,
    trace,
)
from .fused import FusedBase, resolve_fused_base
from .transform import (
    GradientTransformation,
    ScaleByScheduleState,
    chain,
    identity,
    scale,
    scale_by_learning_rate,
    scale_by_schedule,
)

__all__ = [
    "AddDecayedWeightsState", "FusedBase", "GradientTransformation",
    "ScaleByAdamState", "ScaleByScheduleState", "ScaleByVAdamState",
    "TraceState", "adam", "adamw", "add_decayed_weights", "chain",
    "identity", "resolve_fused_base", "scale", "scale_by_adam",
    "scale_by_learning_rate", "scale_by_schedule", "scale_by_vadam", "sgd",
    "trace",
]
