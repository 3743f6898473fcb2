"""Learning-rate schedules (``repro.optim.schedule``): ``step -> value``."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_value: float, warmup_steps: int, decay_steps: int,
                  end_value: float = 0.0):
    """Linear warmup to ``peak_value``, then cosine decay to ``end_value``;
    evaluated on the step counter's device (no host sync)."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = count.to(torch.float32)
        warm = peak_value * count / max(warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps) / max(decay_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = end_value + 0.5 * (peak_value - end_value) * (1 + torch.cos(math.pi * frac))
        return torch.where(count < warmup_steps, warm, cos)

    return schedule
