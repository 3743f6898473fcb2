"""Base optimizers of the port (the linear ones the fused step replays)."""

from .alias import ScaleByVAdamState, TraceState, scale_by_vadam, trace
from .fused import FusedBase, resolve_fused_base
from .transform import GradientTransformation, chain, identity, scale

__all__ = [
    "FusedBase", "GradientTransformation", "ScaleByVAdamState", "TraceState",
    "chain", "identity", "resolve_fused_base", "scale", "scale_by_vadam",
    "trace",
]
