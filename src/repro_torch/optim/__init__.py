"""Optimizers of the port: the linear bases the fused step replays (trace,
VAdam), the opaque ones the two-stage step runs first (Adam, AdamW,
schedules), and the trainer's clipping, schedule and label partition."""

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
from .clip import clip_by_global_norm
from .fused import FusedBase, resolve_fused_base
from .partition import PartitionState, partition
from .schedule import warmup_cosine
from .transform import (
    EmptyState,
    GradientTransformation,
    ScaleByScheduleState,
    apply_updates,
    chain,
    global_norm,
    identity,
    scale,
    scale_by_learning_rate,
    scale_by_schedule,
)


def scale_by_adafactor(*args, **kwargs):
    raise NotImplementedError(
        "Adafactor is not ported yet (ROADMAP: models + training stack)")


__all__ = [
    "AddDecayedWeightsState", "EmptyState", "FusedBase",
    "GradientTransformation", "PartitionState", "ScaleByAdamState",
    "ScaleByScheduleState", "ScaleByVAdamState", "TraceState", "adam",
    "adamw", "add_decayed_weights", "apply_updates", "chain",
    "clip_by_global_norm", "global_norm", "identity", "partition",
    "resolve_fused_base", "scale", "scale_by_adafactor", "scale_by_adam",
    "scale_by_learning_rate", "scale_by_schedule", "scale_by_vadam", "sgd",
    "trace", "warmup_cosine",
]
