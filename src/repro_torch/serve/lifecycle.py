"""Request lifecycle: typed states, terminal outcomes, and serving errors.

The port's copy of ``repro.serve.lifecycle``. Every request handed to
:class:`~repro_torch.serve.engine.ServeEngine` moves through a small
state machine:

    QUEUED -> PREFILL -> DECODE -> FINISHED
                 |  ^        |  ^
                 v  |        v  |
                 SWAPPED (preempted; KV lives host-side, restorable)

and can exit at any point into one of the five *terminal* states:

    FINISHED    ran to completion; ``out_tokens`` is the full answer
    PREEMPTED   evicted under pool pressure and NOT restorable (kill-mode
                preemption, or the bounded swap pool was full) — the
                client may resubmit
    EXPIRED     missed its deadline or TTFT budget (tick-granular)
    CANCELLED   client called ``cancel(request_id)``
    FAILED      a typed serving fault (divergence, corrupted swap);
                ``Request.error`` carries the exception

The engine guarantees that every submitted request reaches exactly one
terminal state — overload, preemption and faults narrow *which* terminal
state, never whether one is reached.

Errors are typed so callers can route on them: :class:`DivergenceError`
(watchdog quarantined the slot), :class:`SwapCorruptError` (swap-out
round trip failed its checksum; only the victim fails),
:class:`DeadlineExceededError`, :class:`PreemptedError`.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional


class RequestState(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    SWAPPED = "swapped"
    # terminal
    FINISHED = "finished"
    PREEMPTED = "preempted"
    EXPIRED = "expired"
    CANCELLED = "cancelled"
    FAILED = "failed"


TERMINAL_STATES = frozenset({
    RequestState.FINISHED,
    RequestState.PREEMPTED,
    RequestState.EXPIRED,
    RequestState.CANCELLED,
    RequestState.FAILED,
})


def is_terminal(state: RequestState) -> bool:
    return state in TERMINAL_STATES


class ServeError(RuntimeError):
    """Base class for typed serving faults attached to ``Request.error``."""


class DivergenceError(ServeError):
    """The watchdog saw a diverged decode (non-finite logits) in this
    request's slot; the slot was quarantined and only this request fails."""

    def __init__(self, uid: int, slot: int, where: str):
        super().__init__(
            f"request {uid}: non-finite logits in slot {slot} during {where}"
        )
        self.uid = uid
        self.slot = slot
        self.where = where


class SwapCorruptError(ServeError):
    """A swapped-out KV snapshot failed its checksum on restore. The
    victim request fails; its device blocks were already freed, so
    neighbour slots are untouched."""

    def __init__(self, uid: int, expected: int, actual: int):
        super().__init__(
            f"request {uid}: swapped KV snapshot corrupt "
            f"(checksum {actual:#x} != recorded {expected:#x})"
        )
        self.uid = uid
        self.expected = expected
        self.actual = actual


class DeadlineExceededError(ServeError):
    """The request ran past its deadline or TTFT budget (in engine ticks)."""

    def __init__(self, uid: int, budget: str, limit_ticks: int, age_ticks: int):
        super().__init__(
            f"request {uid}: {budget} budget of {limit_ticks} ticks exceeded "
            f"(age {age_ticks} ticks)"
        )
        self.uid = uid
        self.budget = budget
        self.limit_ticks = limit_ticks
        self.age_ticks = age_ticks


class PreemptedError(ServeError):
    """The request was evicted under pool pressure and could not be kept
    restorable (kill-mode preemption or a full swap pool)."""

    def __init__(self, uid: int, reason: str):
        super().__init__(f"request {uid} preempted without swap: {reason}")
        self.uid = uid


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Non-raising admission outcome carrying backpressure advice.

    ``retry_after_ticks`` is set for QUEUE_FULL rejections: the number of
    engine ticks after which a retry is expected to find queue space,
    derived from the measured drain rate (see
    ``ServeEngine._retry_after_ticks``). Other reject reasons are
    permanent for this request shape, so the hint is None.
    """

    reason: "object"  # RejectReason (kept untyped to avoid an import cycle)
    msg: str
    retry_after_ticks: Optional[int] = None
