"""StepHealth: the health verdict of one constraint step or one serving
dispatch.

Mirrors ``repro.health``: for a constraint step ``finite`` is derived
from the feasibility residual, because a NaN or Inf anywhere in a row of
the iterate poisons that row's gram diagonal and hence the residual
``||X X^T - I||_F``; for the serving prefill and decode it is the
all-finite verdict of the logits (``residual=None``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StepHealth(NamedTuple):
    """``finite``: bool tensor, True where the step's output is finite.
    ``residual``: optional fp32 feasibility residual(s) of the same shape."""

    finite: torch.Tensor
    residual: Optional[torch.Tensor] = None

    def ok(self) -> torch.Tensor:
        """Scalar bool: every element finite (and every residual finite)."""
        good = torch.all(self.finite)
        if self.residual is not None:
            good = good & torch.all(torch.isfinite(self.residual))
        return good


def from_residual(residual: torch.Tensor) -> StepHealth:
    """Health from a feasibility residual alone: ``finite = isfinite``."""
    return StepHealth(finite=torch.isfinite(residual), residual=residual)


def from_logits(logits: torch.Tensor, *, per_row: bool = False) -> StepHealth:
    """Health of a logits tensor: a scalar verdict, or one per leading-axis
    row (the serving decode batch) when ``per_row``."""
    if per_row:
        return StepHealth(finite=torch.isfinite(logits).flatten(1).all(dim=1))
    return StepHealth(finite=torch.isfinite(logits).all())
