"""Gradient clipping (``repro.optim.clip``): the trainer's global-norm guard."""

from __future__ import annotations

import torch

from .. import tree
from .transform import EmptyState, GradientTransformation, global_norm


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``min(1, max_norm / ||updates||)``."""

    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        norm = global_norm(updates)
        scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
        return tree.tree_map(lambda u: (u * scale).to(u.dtype), updates), state

    return GradientTransformation(init, update)
