"""Deterministic fault injection for the serving engine and the trainer:
the port's copy of ``repro.faults`` (that module imports no JAX, but the
port keeps its own copy rather than import the JAX package).

A :class:`FaultPlan` is a seeded, fully explicit schedule of faults that
a runtime consults at well-defined hook points; the same seed and
arguments give the same events as the JAX package's plan (numpy's
generator draws them). Every hook sits behind a single ``plan is not
None`` test in the runtime. The serving engine (``serve/engine.py``)
consults the serving kinds; the port's trainer does not take a plan yet
(``train(fault_plan=...)`` raises), so the training kinds are only
scheduled here.

Serving fault kinds (tick-granular):

  ``alloc_exhaust``   block allocator reads as empty for ``duration``
                      ticks: admission stalls, preemption fires.
  ``nan_logits``      slot ``slot``'s decode logits poisoned to NaN in
                      the decode dispatch, before its health reduction.
  ``delay_prefill``   slot skipped by the prefill scheduler.
  ``corrupt_swap``    one byte of the next swap-out of ``uid`` flipped
                      after its checksum is recorded.

Training fault kinds (step-granular): ``nan_grad``, ``drift_inject``,
``corrupt_checkpoint``, ``delay_step`` (``repro.faults``).

Every fault that fires is appended to ``plan.fired`` as ``(tick, kind,
detail)``, so a replay from the same seed can be checked to have fired
identically.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

SERVE_FAULT_KINDS = (
    "alloc_exhaust", "nan_logits", "delay_prefill", "corrupt_swap",
)
TRAIN_FAULT_KINDS = (
    "nan_grad", "drift_inject", "corrupt_checkpoint", "delay_step",
)
FAULT_KINDS = SERVE_FAULT_KINDS + TRAIN_FAULT_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    tick: int = 0                  # first tick/step the fault is active
    duration: int = 1              # ticks the condition persists
    slot: Optional[int] = None     # nan_logits / delay_prefill target
    uid: Optional[int] = None      # corrupt_swap target (None = any)
    scale: Optional[float] = None  # drift_inject magnitude / delay seconds

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.duration < 1:
            raise ValueError(f"duration {self.duration} < 1")

    def active(self, tick: int) -> bool:
        return self.tick <= tick < self.tick + self.duration


class FaultPlan:
    """An explicit or seeded-random schedule of :class:`FaultEvent`.

    Two plans built from the same events (or the same ``random`` seed and
    arguments) inject byte-identical faults — determinism is the whole
    point: every recovery path is exercised by a *reproducible* test.
    """

    def __init__(self, events: Tuple[FaultEvent, ...] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.fired: List[tuple] = []
        # one-shot events (corrupt_swap, nan_grad, drift_inject,
        # corrupt_checkpoint) track spent schedule indices, so a rollback
        # replay of the same step window never re-fires them
        self._spent: set = set()

    def __repr__(self):
        return f"FaultPlan({list(self.events)!r})"

    @property
    def kinds(self) -> set:
        return {e.kind for e in self.events}

    @classmethod
    def random(cls, seed: int, *, n_events: int, max_tick: int,
               n_slots: int = 1, kinds: Tuple[str, ...] = SERVE_FAULT_KINDS,
               max_duration: int = 4) -> "FaultPlan":
        """A deterministic chaos schedule: ``n_events`` faults sampled
        uniformly over ``kinds``, ticks ``[1, max_tick)`` and slots.
        ``kinds`` defaults to the serving set;
        pass :data:`TRAIN_FAULT_KINDS` (or any mix) for training chaos."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            tick = int(rng.integers(1, max(2, max_tick)))
            duration = int(rng.integers(1, max_duration + 1))
            slot = int(rng.integers(0, n_slots))
            if kind == "corrupt_swap":
                events.append(FaultEvent(kind, tick=tick, uid=None))
            elif kind in ("alloc_exhaust", "nan_grad", "corrupt_checkpoint"):
                events.append(FaultEvent(kind, tick=tick, duration=duration))
            elif kind == "drift_inject":
                events.append(FaultEvent(
                    kind, tick=tick,
                    scale=float(0.02 + 0.08 * rng.random()),
                ))
            elif kind == "delay_step":
                events.append(FaultEvent(kind, tick=tick, duration=duration,
                                         scale=0.05))
            else:
                events.append(FaultEvent(kind, tick=tick, duration=duration,
                                         slot=slot))
        return cls(tuple(events))

    # ------------------------------------------------------------ hook queries

    def _fire(self, tick: int, kind: str, detail) -> None:
        self.fired.append((tick, kind, detail))

    # --- serving hooks

    def alloc_blocked(self, tick: int) -> bool:
        """True while an ``alloc_exhaust`` fault is active."""
        for e in self.events:
            if e.kind == "alloc_exhaust" and e.active(tick):
                self._fire(tick, e.kind, None)
                return True
        return False

    def nan_slots(self, tick: int) -> List[int]:
        """Slots whose decode logits are poisoned this tick."""
        out = []
        for e in self.events:
            if e.kind == "nan_logits" and e.active(tick) and e.slot is not None:
                self._fire(tick, e.kind, e.slot)
                out.append(e.slot)
        return out

    def has_nan_faults(self) -> bool:
        """Whether the engine must compile the poison-mask decode variant."""
        return any(e.kind == "nan_logits" for e in self.events)

    def prefill_delayed(self, tick: int, slot: int) -> bool:
        for e in self.events:
            if e.kind == "delay_prefill" and e.active(tick) and (
                e.slot is None or e.slot == slot
            ):
                self._fire(tick, e.kind, slot)
                return True
        return False

    def corrupt_swap(self, tick: int, uid: int, buffers: List[np.ndarray]) -> bool:
        """One-shot: flip one byte of the first non-empty snapshot buffer
        of request ``uid``'s swap-out. Returns True if corruption fired.
        Called AFTER the checksum was recorded, so the restore-side
        integrity check is what detects it."""
        for i, e in enumerate(self.events):
            if e.kind != "corrupt_swap" or i in self._spent:
                continue
            if e.uid is not None and e.uid != uid:
                continue
            if tick < e.tick:
                continue
            for buf in buffers:
                flat = buf.view(np.uint8).reshape(-1)
                if flat.size:
                    flat[flat.size // 2] ^= 0xFF
                    self._spent.add(i)
                    self._fire(tick, e.kind, uid)
                    return True
        return False

    # --- training hooks

    def nan_grad(self, step: int) -> bool:
        """One-shot: True when step ``step``'s parameters must be
        poisoned (non-finite loss/grads/StepHealth this step)."""
        for i, e in enumerate(self.events):
            if e.kind == "nan_grad" and e.active(step) and i not in self._spent:
                self._spent.add(i)
                self._fire(step, e.kind, None)
                return True
        return False

    def drift_scale(self, step: int) -> Optional[float]:
        """One-shot: off-manifold scale to apply to constrained weights
        before step ``step`` (None = no drift this step)."""
        for i, e in enumerate(self.events):
            if (e.kind == "drift_inject" and e.active(step)
                    and i not in self._spent):
                self._spent.add(i)
                scale = 0.05 if e.scale is None else float(e.scale)
                self._fire(step, e.kind, scale)
                return scale
        return None

    def corrupt_checkpoint(self, step: int, path: str) -> bool:
        """One-shot: flip one byte in the first payload file of the
        checkpoint directory just committed at ``path``. Fires on the
        first save at or after the event's ``tick``. The crc in the
        manifest (checkpoint.py) is what must detect it."""
        import os

        for i, e in enumerate(self.events):
            if e.kind != "corrupt_checkpoint" or i in self._spent:
                continue
            if step < e.tick:
                continue
            leaves = sorted(
                f for f in os.listdir(path) if f.startswith("leaf_")
            )
            if not leaves:
                continue
            victim = os.path.join(path, leaves[0])
            with open(victim, "r+b") as f:
                f.seek(max(0, os.path.getsize(victim) // 2))
                byte = f.read(1)
                f.seek(max(0, os.path.getsize(victim) // 2))
                f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
            self._spent.add(i)
            self._fire(step, e.kind, victim)
            return True
        return False

    def step_delay(self, step: int) -> float:
        """Seconds to sleep before step ``step`` (0.0 = no delay)."""
        for e in self.events:
            if e.kind == "delay_step" and e.active(step):
                delay = 0.05 if e.scale is None else float(e.scale)
                self._fire(step, e.kind, delay)
                return delay
        return 0.0
