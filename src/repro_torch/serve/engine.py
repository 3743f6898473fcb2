"""Paged continuous-batching serving engine, overload-safe
(``repro.serve.engine``).

Requests flow queue -> slot -> terminal state. A slot is a row in the
fixed ``(n_slots, 1)`` decode batch; its KV lives in fixed-size blocks
drawn from a shared pool (``kv_cache.BlockAllocator``), so slot count is
decoupled from worst-case sequence length — admitting a request reserves
``ceil((prompt_len + max_new_tokens) / block_size)`` blocks up front and
can therefore never run out of cache mid-flight.

Scheduling (one ``step()`` tick):

  1. **expire** — tick-granular deadline / TTFT-budget enforcement over
     queued, running and swapped requests (``EXPIRED`` terminal state).
  2. **admit** — strict FIFO with restore priority: swapped-out requests
     (which were admitted before anything still queued) are restored
     first, then the queue head is admitted the moment a free slot AND
     its block reservation are both available. When the head has starved
     for ``preempt_after_ticks`` consecutive ticks and preemption is
     enabled, a victim (``victim_policy``, default youngest-by-decode-
     progress) is swapped out to the host-side ``SwapPool`` (or killed to
     terminal ``PREEMPTED`` in kill-mode / when the pool is full) and its
     blocks are reclaimed. Restores never trigger preemption (no
     swap-in/swap-out livelock) and a slot placed this tick is never the
     same tick's victim.
  3. **prefill** — up to ``prefill_token_budget`` prompt tokens through
     bulk ``tfm.prefill_chunk`` dispatches (one per chunk, writing only
     into the request's own blocks).
  4. **decode** — one ``tfm.decode_step_paged`` over the full slot batch;
     rows that are free or still prefilling ride along masked. Both
     dispatches return a :class:`repro_torch.health.StepHealth` verdict
     (all-finite logits, reduced on the device); an unhealthy row
     quarantines ONLY that slot — the request fails with
     :class:`~repro_torch.serve.lifecycle.DivergenceError`, its
     blocks are freed, and neighbour slots decode on token-identical to
     a no-fault run.

Every submitted request reaches exactly one typed terminal state
(``FINISHED / PREEMPTED / EXPIRED / CANCELLED / FAILED`` — see
``serve.lifecycle``); ``run()`` returns them all and ``Request.state`` /
``Request.error`` say what happened.

Admission control: ``submit`` raises :class:`AdmissionError` with a typed
:class:`RejectReason`; ``try_submit`` is the non-raising variant and
returns a :class:`~repro_torch.serve.lifecycle.Rejection` whose
``retry_after_ticks`` (for ``QUEUE_FULL``) is derived from the measured
terminal-event drain rate — backpressure clients can act on instead of
blind retry.

Fault injection: construct the engine with a seeded
:class:`~repro_torch.serve.faults.FaultPlan` and every hook site
(allocator exhaustion, NaN poisoning of the logits, prefill delay, swap
corruption) fires deterministically. All hooks sit behind a single
``fault_plan is not None`` test; the NaN-poison decode variant exists
only for engines whose plan contains ``nan_logits`` events.

The port runs eagerly: where JAX compiles the prefill and decode programs
once per config (``_JIT_CACHE``), the port calls the model's functions
(``_prefill_fn``, ``_decode_fn``, ``_poison_fn``), so a tick is paced by
the host's dispatch of the model's small operations. The engine runs on
the device of the params; greedy tokens are taken on the device, and one
small transfer a dispatch brings them and the health verdict to the host.

``generate_reference`` is the sequential one-request-at-a-time oracle
(dense cache path) that the engine's batched output is held against —
including requests that were preempted, swapped out and restored (the
swap round trip is bit-exact). The two paths reduce over caches of other
lengths, so their logits may differ in the last bits and a greedy token
may part at a near-tie (``serve/parity.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import deque
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import health as health_mod
from ..models import transformer as tfm
from . import fold as fold_mod
from . import kv_cache
from .faults import FaultPlan
from .kv_cache import (
    BlockAllocator,
    BlockTables,
    SwapPool,
    SwapRecord,
    blocks_needed,
    gather_slot_kv,
    scatter_slot_kv,
    snapshot_checksum,
)
from .lifecycle import (
    DeadlineExceededError,
    DivergenceError,
    PreemptedError,
    Rejection,
    RequestState,
    SwapCorruptError,
)

_FREE, _PREFILL, _DECODE = "free", "prefill", "decode"

class RejectReason(Enum):
    QUEUE_FULL = "queue_full"        # bounded queue at capacity (retryable)
    TOO_LONG = "too_long"            # can never fit: blocks > table/pool
    EMPTY_PROMPT = "empty_prompt"
    ZERO_NEW_TOKENS = "zero_new_tokens"  # max_new_tokens < 1 (pinned: reject)
    UNHEALTHY = "unhealthy"          # weight watchdog tripped; engine draining


class AdmissionError(RuntimeError):
    """Typed admission rejection; ``.reason`` is a :class:`RejectReason`."""

    def __init__(self, reason: RejectReason, msg: str,
                 retry_after_ticks: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ticks = retry_after_ticks


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    # tick-granular budgets (None = unbounded): a request older than
    # ``deadline_ticks`` (or without a first token after
    # ``ttft_budget_ticks``) is expired deterministically — ticks, not
    # wall-clock, so tests and replays agree.
    deadline_ticks: Optional[int] = None
    ttft_budget_ticks: Optional[int] = None
    out_tokens: Optional[list] = None
    # lifecycle (engine-owned)
    state: RequestState = RequestState.QUEUED
    error: Optional[Exception] = None
    n_preemptions: int = 0
    # tick telemetry (engine-owned; -1 = not yet)
    submit_tick: int = -1
    admit_tick: int = -1
    first_tick: int = -1
    finish_tick: int = -1
    # wall-clock telemetry (perf_counter timestamps)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0
    token_times: Optional[list] = None


def youngest_by_decode_progress(engine: "ServeEngine",
                                candidates: List[int]) -> int:
    """Default victim policy: evict the slot that loses the least work —
    fewest generated tokens, ties broken by most recent admission."""
    return min(
        candidates,
        key=lambda s: (
            len(engine.slot_req[s].out_tokens or ()),
            -engine.slot_req[s].admit_tick,
            s,
        ),
    )


class ServeEngine:
    """Continuous batching over a paged KV cache, on the device of
    ``params`` (a tree from ``transformer.init_params`` or
    ``convert.params_from_jax``).

    Parameters
    ----------
    n_slots: concurrent decode lanes (rows of the decode batch).
    n_blocks: physical KV blocks in the pool (block 0 is reserved).
    block_size: tokens per block.
    max_model_len: longest prompt+generation a request may need; sets the
        block-table width (and with it the gathered-attention span).
        Defaults to the whole pool.
    prefill_chunk: prompt tokens per prefill dispatch; the final chunk
        is padded to this size (its pad writes go to the null block).
    prefill_token_budget: max prompt tokens prefilled per tick — the
        knob bounding how long a prompt may stall concurrent decodes.
        Defaults to ``prefill_chunk``.
    max_queue: bounded admission queue; ``None`` = unbounded.
    preemption: ``"off"`` (head-of-line waits), ``"swap"``
        (victims swapped to host and restored bit-exactly later) or
        ``"kill"`` (victims get terminal ``PREEMPTED``; client resubmits).
    preempt_after_ticks: consecutive starved ticks before the scheduler
        preempts for the stuck head.
    max_preemptions: per-request eviction cap (anti-thrash); a request at
        the cap is never picked as victim again.
    swap_pool_size: max host-side swap records; a full pool downgrades
        the next swap to a kill. ``None`` = unbounded.
    victim_policy: ``f(engine, candidate_slots) -> slot``; defaults to
        :func:`youngest_by_decode_progress`.
    fault_plan: optional :class:`~repro_torch.serve.faults.FaultPlan`; all
        hook sites are behind ``is not None`` guards.
    weight_check_interval: every N ticks, re-measure fold feasibility of
        the live params (``fold.feasibility_distance``); drift beyond
        ``fold_atol`` marks the engine unhealthy — in-flight requests
        drain, new submissions are rejected (``UNHEALTHY``).
    """

    def __init__(self, params, cfg, *, n_slots: int = 8, n_blocks: int = 128,
                 block_size: int = 16, max_model_len: Optional[int] = None,
                 prefill_chunk: int = 32,
                 prefill_token_budget: Optional[int] = None,
                 max_queue: Optional[int] = None, greedy: bool = True,
                 preemption: str = "off", preempt_after_ticks: int = 4,
                 max_preemptions: int = 2,
                 swap_pool_size: Optional[int] = None,
                 victim_policy: Optional[Callable] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 weight_check_interval: Optional[int] = None,
                 fold_atol: float = fold_mod.DEFAULT_ATOL):
        if not greedy:
            raise NotImplementedError("only greedy decoding is implemented")
        if preemption not in ("off", "swap", "kill"):
            raise ValueError(f"preemption={preemption!r}")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.block_size = block_size
        if max_model_len is None:
            max_model_len = (n_blocks - 1) * block_size
        self.max_model_len = max_model_len
        self.max_blocks = blocks_needed(max_model_len, block_size)
        self.prefill_chunk = prefill_chunk
        self.prefill_token_budget = (
            prefill_chunk if prefill_token_budget is None else prefill_token_budget
        )
        self.max_queue = max_queue
        self.greedy = greedy
        self.preemption = preemption
        self.preempt_after_ticks = preempt_after_ticks
        self.max_preemptions = max_preemptions
        self.victim_policy = victim_policy or youngest_by_decode_progress
        self.fault_plan = fault_plan
        self.weight_check_interval = weight_check_interval
        self.fold_atol = fold_atol
        self.weight_healthy = True

        self.caches = tfm.init_paged_cache(cfg, n_slots, n_blocks, block_size,
                                           device=self.device)
        self.layouts = tfm.paged_cache_layout(cfg)
        self.allocator = BlockAllocator(n_blocks)
        self.tables = BlockTables(n_slots, self.max_blocks)
        self.swap_pool = SwapPool(swap_pool_size)
        self._swapped: Dict[int, Request] = {}  # uid -> swapped-out request

        self.slot_state = [_FREE] * n_slots
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int64)       # cached positions
        self.slot_prefill_pos = np.zeros(n_slots, np.int64)
        self.slot_remaining = np.zeros(n_slots, np.int64)
        self.queue: deque = deque()
        self.finished: list = []        # every terminal request, any state

        self._starve_ticks = 0          # consecutive ticks the head starved
        self._drain_ticks: deque = deque(maxlen=32)  # recent terminal ticks

        self.stats: dict = {
            "admitted": 0,
            "finished": 0,
            "rejected": {},                      # reason.value -> count
            "admissions_per_slot": [0] * n_slots,
            "prefill_tokens": 0,
            "n_prefill_dispatches": 0,
            "n_decode_dispatches": 0,
            "prefill_time_s": 0.0,
            "decode_time_s": 0.0,
            "util_samples": [],                  # (slot_frac, block_frac)
            "ticks": 0,
            # robustness telemetry
            "preemptions": 0,                    # victim evictions (swap+kill)
            "swapped_out": 0,
            "swapped_in": 0,
            "preempted": 0,                      # terminal PREEMPTED
            "expired": 0,
            "cancelled": 0,
            "failed": 0,
            "watchdog_trips": 0,                 # divergence quarantines
            "weight_checks": 0,
            "weight_drift_trips": 0,
        }

        # the model's dispatches, with the JAX engine's operand order
        self._decode_fn = functools.partial(_decode, cfg)
        self._prefill_fn = functools.partial(_prefill, cfg)
        # the poison variant exists only when the plan can need it
        self._poison_fn = (
            functools.partial(_decode, cfg)
            if fault_plan is not None and fault_plan.has_nan_faults()
            else None
        )

    # -------------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        """Enqueue a request; raises :class:`AdmissionError` on rejection."""
        plen = len(req.prompt)
        if not self.weight_healthy:
            self._reject(
                RejectReason.UNHEALTHY,
                "weight watchdog tripped: folded params drifted off-manifold",
            )
        if plen == 0:
            self._reject(RejectReason.EMPTY_PROMPT, "empty prompt")
        if req.max_new_tokens < 1:
            self._reject(
                RejectReason.ZERO_NEW_TOKENS,
                f"max_new_tokens={req.max_new_tokens} (must be >= 1)",
            )
        need = blocks_needed(plen + req.max_new_tokens, self.block_size)
        if need > self.max_blocks or need > self.n_blocks - 1:
            self._reject(
                RejectReason.TOO_LONG,
                f"request needs {need} blocks "
                f"(table holds {self.max_blocks}, pool {self.n_blocks - 1})",
            )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject(
                RejectReason.QUEUE_FULL, f"queue at capacity {self.max_queue}",
                retry_after_ticks=self._retry_after_ticks(),
            )
        req.out_tokens = []
        req.token_times = []
        req.state = RequestState.QUEUED
        req.submit_tick = self.stats["ticks"]
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def try_submit(self, req: Request) -> Optional[Rejection]:
        """Non-raising :meth:`submit`; returns a :class:`Rejection` on
        rejection (``None`` on success). ``QUEUE_FULL`` rejections carry a
        ``retry_after_ticks`` backpressure hint from the measured drain
        rate."""
        try:
            self.submit(req)
            return None
        except AdmissionError as e:
            return Rejection(
                reason=e.reason, msg=str(e),
                retry_after_ticks=e.retry_after_ticks,
            )

    def _reject(self, reason: RejectReason, msg: str,
                retry_after_ticks: Optional[int] = None):
        r = self.stats["rejected"]
        r[reason.value] = r.get(reason.value, 0) + 1
        raise AdmissionError(reason, msg, retry_after_ticks)

    def _retry_after_ticks(self) -> int:
        """Backpressure hint: ticks until one queue seat is expected to
        free, from the recent terminal-event rate. With no drain history
        yet the hint is the head-of-line depth (pessimistic floor 1)."""
        d = self._drain_ticks
        if len(d) >= 2 and d[-1] > d[0]:
            per_event = (d[-1] - d[0]) / (len(d) - 1)
            return max(1, math.ceil(per_event))
        return max(1, len(self.queue))

    def cancel(self, uid: int) -> bool:
        """Client-side cancel. Works in any non-terminal state (queued,
        prefilling, decoding, swapped out); returns False if the request
        is unknown or already terminal."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self._terminal(req, RequestState.CANCELLED)
                return True
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and req.uid == uid:
                self._release_slot(slot)
                self._terminal(req, RequestState.CANCELLED)
                return True
        if uid in self._swapped:
            req = self._swapped.pop(uid)
            self.swap_pool.pop(uid)
            self._terminal(req, RequestState.CANCELLED)
            return True
        return False

    # ------------------------------------------------------------- lifecycle

    def _terminal(self, req: Request, state: RequestState,
                  error: Optional[Exception] = None):
        """Move a request into a terminal state (exactly once)."""
        req.state = state
        req.error = error
        req.finish_tick = self.stats["ticks"]
        req.t_finish = time.perf_counter()
        self.finished.append(req)
        self._drain_ticks.append(self.stats["ticks"])
        if state is RequestState.FINISHED:
            self.stats["finished"] += 1
        elif state is RequestState.PREEMPTED:
            self.stats["preempted"] += 1
        elif state is RequestState.EXPIRED:
            self.stats["expired"] += 1
        elif state is RequestState.CANCELLED:
            self.stats["cancelled"] += 1
        elif state is RequestState.FAILED:
            self.stats["failed"] += 1

    def _release_slot(self, slot: int):
        """Free a slot's blocks and clear its bookkeeping."""
        self.allocator.free(self.tables.release(slot))
        self.slot_state[slot] = _FREE
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self.slot_prefill_pos[slot] = 0
        self.slot_remaining[slot] = 0

    def _enforce_deadlines(self):
        """Tick-granular EXPIRED: deadline over total age, TTFT budget
        until the first token exists. Applies uniformly to queued, slotted
        and swapped-out requests."""
        now = self.stats["ticks"]

        def expired(req: Request) -> Optional[DeadlineExceededError]:
            age = now - req.submit_tick
            if req.deadline_ticks is not None and age > req.deadline_ticks:
                return DeadlineExceededError(
                    req.uid, "deadline", req.deadline_ticks, age
                )
            if (req.ttft_budget_ticks is not None and req.first_tick < 0
                    and age > req.ttft_budget_ticks):
                return DeadlineExceededError(
                    req.uid, "ttft", req.ttft_budget_ticks, age
                )
            return None

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._terminal(req, RequestState.EXPIRED, expired(req))
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            err = expired(req)
            if err is not None:
                self._release_slot(slot)
                self._terminal(req, RequestState.EXPIRED, err)
        for uid in [u for u, r in self._swapped.items() if expired(r)]:
            req = self._swapped.pop(uid)
            self.swap_pool.pop(uid)
            self._terminal(req, RequestState.EXPIRED, expired(req))

    # ------------------------------------------------------- preemption/swap

    def _swap_out(self, slot: int):
        """Evict ``slot`` to the host-side swap pool: gather its block
        contents + per-slot state, checksum, free the device blocks."""
        req = self.slot_req[slot]
        phys = self.tables.owned(slot)
        pool_rows, state_rows = gather_slot_kv(
            self.caches, self.layouts, slot, phys
        )
        rec = SwapRecord(
            uid=req.uid,
            n_blocks=len(phys),
            pool_rows=pool_rows,
            state_rows=state_rows,
            checksum=snapshot_checksum(pool_rows + state_rows),
            slot_len=int(self.slot_len[slot]),
            prefill_pos=int(self.slot_prefill_pos[slot]),
            remaining=int(self.slot_remaining[slot]),
            phase=self.slot_state[slot],
        )
        if self.fault_plan is not None:
            # corruption fires AFTER the checksum is recorded — the
            # restore-side verify is what must catch it
            self.fault_plan.corrupt_swap(self.stats["ticks"], req.uid, pool_rows)
        self.swap_pool.put(rec)
        self._swapped[req.uid] = req
        self._release_slot(slot)
        req.state = RequestState.SWAPPED
        req.n_preemptions += 1
        self.stats["preemptions"] += 1
        self.stats["swapped_out"] += 1

    def _kill_preempt(self, slot: int, why: str):
        req = self.slot_req[slot]
        self._release_slot(slot)
        req.n_preemptions += 1
        self.stats["preemptions"] += 1
        self._terminal(
            req, RequestState.PREEMPTED, PreemptedError(req.uid, why)
        )

    def _preempt_one(self, placed: set) -> bool:
        """Evict one victim for the starved head. Returns True if a
        victim was evicted."""
        candidates = [
            s for s in range(self.n_slots)
            if self.slot_state[s] in (_PREFILL, _DECODE)
            and s not in placed
            and self.slot_req[s].n_preemptions < self.max_preemptions
        ]
        if not candidates:
            return False
        victim = self.victim_policy(self, candidates)
        if self.preemption == "swap" and not self.swap_pool.full:
            self._swap_out(victim)
        else:
            why = (
                "swap pool full" if self.preemption == "swap"
                else "kill-mode preemption"
            )
            self._kill_preempt(victim, why)
        return True

    def _restore_one(self, slot: int, rec: SwapRecord,
                     blocks: List[int]) -> None:
        """Scatter a verified swap record into freshly allocated blocks."""
        req = self._swapped.pop(rec.uid)
        self.tables.assign(slot, blocks)
        scatter_slot_kv(
            self.caches, self.layouts, slot, blocks,
            rec.pool_rows, rec.state_rows,
        )
        self.slot_state[slot] = rec.phase
        self.slot_req[slot] = req
        self.slot_len[slot] = rec.slot_len
        self.slot_prefill_pos[slot] = rec.prefill_pos
        self.slot_remaining[slot] = rec.remaining
        req.state = (
            RequestState.PREFILL if rec.phase == _PREFILL else RequestState.DECODE
        )
        self.stats["swapped_in"] += 1

    def _place_pass(self, placed: set, alloc_blocked: bool) -> bool:
        """One placement sweep in strict age order: restores (older than
        anything queued) first, then queue admissions. Returns True if at
        least one request landed in a slot."""
        progressed = False
        # restores: FIFO over swap-out order
        while len(self.swap_pool):
            rec = self.swap_pool.peek_first()
            free = [s for s in range(self.n_slots)
                    if self.slot_state[s] == _FREE]
            if not free or alloc_blocked:
                return progressed
            blocks = self.allocator.alloc(rec.n_blocks)
            if blocks is None:
                return progressed
            self.swap_pool.pop(rec.uid)
            try:
                rec.verify()
            except SwapCorruptError as e:
                # integrity check fails BEFORE any device write: only the
                # victim fails, the fresh blocks go straight back
                self.allocator.free(blocks)
                req = self._swapped.pop(rec.uid)
                self._terminal(req, RequestState.FAILED, e)
                progressed = True
                continue
            slot = free[0]
            self._restore_one(slot, rec, blocks)
            placed.add(slot)
            progressed = True
        # queue admissions: strict FIFO, all-or-nothing block reservation
        while self.queue:
            free = [s for s in range(self.n_slots)
                    if self.slot_state[s] == _FREE]
            if not free or alloc_blocked:
                return progressed
            req = self.queue[0]
            need = blocks_needed(
                len(req.prompt) + req.max_new_tokens, self.block_size
            )
            blocks = self.allocator.alloc(need)
            if blocks is None:
                return progressed  # head-of-line waits; order preserved
            self.queue.popleft()
            slot = free[0]
            self.tables.assign(slot, blocks)
            # zero per-slot recurrent state rows (layout-driven; KV pool
            # blocks need no reset — unique ownership + position masking)
            kv_cache.reset_slot(self.caches, self.layouts, slot)
            self.slot_state[slot] = _PREFILL
            self.slot_req[slot] = req
            self.slot_len[slot] = 0
            self.slot_prefill_pos[slot] = 0
            self.slot_remaining[slot] = req.max_new_tokens
            req.state = RequestState.PREFILL
            req.admit_tick = self.stats["ticks"]
            req.t_admit = time.perf_counter()
            placed.add(slot)
            progressed = True
            self.stats["admitted"] += 1
            self.stats["admissions_per_slot"][slot] += 1
        return progressed

    def _admit(self):
        """Strict FIFO placement with restore priority; preempts for a
        head that has starved ``preempt_after_ticks`` consecutive ticks."""
        alloc_blocked = (
            self.fault_plan is not None
            and self.fault_plan.alloc_blocked(self.stats["ticks"])
        )
        placed: set = set()
        while True:
            progressed = self._place_pass(placed, alloc_blocked)
            pending = bool(self.queue) or bool(len(self.swap_pool))
            if not pending:
                self._starve_ticks = 0
                return
            if progressed:
                self._starve_ticks = 0
                continue
            # head starved this tick. Preemption is only ever triggered by
            # a starved QUEUE head — a stuck restore waits for a natural
            # finish instead (swapping one victim out to swap another in
            # is the livelock this rule exists to prevent).
            self._starve_ticks += 1
            if (self.preemption == "off" or alloc_blocked
                    or not self.queue
                    or self._starve_ticks < self.preempt_after_ticks):
                return
            # evict victims until the head fits (or no candidate remains);
            # TOO_LONG screening at submit guarantees the head can fit an
            # empty pool, so this terminates with the head placed or every
            # eligible victim evicted
            if not self._preempt_one(placed):
                return
            self._starve_ticks = 0

    # ----------------------------------------------------------------- prefill

    def _dispatch_prefill(self, slot: int, req: Request, pos: int,
                          n_valid: int):
        """One chunk dispatch (padded to ``prefill_chunk`` tokens); returns
        (the greedy token at the chunk's last valid position, healthy:
        bool — the chunk's StepHealth verdict)."""
        tokens = np.zeros((1, self.prefill_chunk), np.int64)
        tokens[0, :n_valid] = req.prompt[pos:pos + n_valid]
        logits, self.caches, health = self._prefill_fn(
            self.params, self._on_device(tokens), self.caches,
            self._on_device(self.tables.array[slot:slot + 1]), pos, n_valid,
            slot,
        )
        tok, finite = torch.stack(
            [logits[0, 0].argmax(), health.finite.long()]).tolist()
        return tok, bool(finite)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _prefill_tick(self) -> bool:
        """Spend up to ``prefill_token_budget`` prompt tokens, round-robin
        over prefilling slots. Returns True if any chunk ran."""
        budget = self.prefill_token_budget
        ran = False
        progressed = True
        while budget > 0 and progressed:
            progressed = False
            for slot in range(self.n_slots):
                if budget <= 0:
                    break
                if self.slot_state[slot] != _PREFILL:
                    continue
                if (self.fault_plan is not None
                        and self.fault_plan.prefill_delayed(
                            self.stats["ticks"], slot)):
                    continue
                req = self.slot_req[slot]
                plen = len(req.prompt)
                pos = int(self.slot_prefill_pos[slot])
                n_valid = min(self.prefill_chunk, plen - pos, budget)
                t0 = time.perf_counter()
                tok, healthy = self._dispatch_prefill(slot, req, pos, n_valid)
                dt = time.perf_counter() - t0
                self.stats["prefill_time_s"] += dt
                self.stats["n_prefill_dispatches"] += 1
                self.stats["prefill_tokens"] += n_valid
                if not healthy:
                    self._quarantine(slot, "prefill")
                    progressed = True
                    continue
                pos += n_valid
                budget -= n_valid
                self.slot_prefill_pos[slot] = pos
                self.slot_len[slot] = pos
                ran = progressed = True
                if pos >= plen:
                    # prompt complete: its last logits yield the first token
                    now = time.perf_counter()
                    req.out_tokens.append(tok)
                    req.token_times.append(now)
                    req.t_first = now
                    req.first_tick = self.stats["ticks"]
                    self.slot_remaining[slot] -= 1
                    self.slot_state[slot] = _DECODE
                    req.state = RequestState.DECODE
                    if self.slot_remaining[slot] <= 0:
                        self._finish(slot)
        return ran

    # ------------------------------------------------------------------ decode

    def _quarantine(self, slot: int, where: str):
        """Watchdog action for a diverged (non-finite) slot: fail ONLY
        this request, free its blocks. Neighbour slots are untouched —
        their KV lives in disjoint blocks and their tokens come from
        their own batch rows."""
        req = self.slot_req[slot]
        err = DivergenceError(req.uid, slot, where)
        self._release_slot(slot)
        self._terminal(req, RequestState.FAILED, err)
        self.stats["watchdog_trips"] += 1

    def _decode_tick(self) -> bool:
        """One decode step for every decoding slot. Returns True if ran."""
        active = [s for s in range(self.n_slots) if self.slot_state[s] == _DECODE]
        if not active:
            return False
        last = np.zeros((self.n_slots, 1), np.int64)
        lengths = np.zeros(self.n_slots, np.int64)
        mask = np.zeros(self.n_slots, bool)
        for s in active:
            last[s, 0] = self.slot_req[s].out_tokens[-1]
            lengths[s] = self.slot_len[s]
            mask[s] = True
        t0 = time.perf_counter()
        poison = None
        if self._poison_fn is not None:
            sick = self.fault_plan.nan_slots(self.stats["ticks"])
            if sick:
                poison = np.zeros(self.n_slots, bool)
                poison[[s for s in sick if s < self.n_slots]] = True
        operands = (self.params, self._on_device(last), self.caches,
                    self._on_device(self.tables.array), self._on_device(lengths),
                    self._on_device(mask))
        if poison is not None:
            logits, self.caches, health = self._poison_fn(
                *operands, self._on_device(poison))
        else:
            logits, self.caches, health = self._decode_fn(*operands)
        # greedy tokens and the (B,) per-slot StepHealth mask, one transfer
        picked = torch.stack([logits[:, 0].argmax(dim=-1),
                              health.finite.long()]).cpu().numpy()
        tokens, finite = picked[0], picked[1].astype(bool)
        now = time.perf_counter()
        self.stats["decode_time_s"] += now - t0
        self.stats["n_decode_dispatches"] += 1
        for s in active:
            if not finite[s]:
                self._quarantine(s, "decode")
                continue
            self.slot_len[s] += 1
            req = self.slot_req[s]
            nxt = int(tokens[s])
            req.out_tokens.append(nxt)
            req.token_times.append(now)
            self.slot_remaining[s] -= 1
            if self.slot_remaining[s] <= 0:
                self._finish(s)
        return True

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self._release_slot(slot)
        self._terminal(req, RequestState.FINISHED)

    # ---------------------------------------------------------------- watchdog

    def _check_weights(self):
        """Periodic fold-feasibility re-measurement of the live params.
        POGO serves *folded orthogonal* weights; drift past the fold gate
        means the buffers were corrupted after folding — the engine stops
        accepting work and drains what's in flight."""
        self.stats["weight_checks"] += 1
        worst, _path = fold_mod.feasibility_distance(self.params, self.cfg)
        # Same StepHealth contract as the training watchdog: a non-finite
        # residual is unhealthy by definition (a bare `worst > atol` would
        # read NaN as False and miss corrupted buffers entirely).
        verdict = health_mod.from_residual(torch.tensor(worst, dtype=torch.float32))
        if not bool(verdict.ok()) or worst > self.fold_atol:
            self.weight_healthy = False
            self.stats["weight_drift_trips"] += 1

    # ------------------------------------------------------------------- drive

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._swapped) or any(
            st != _FREE for st in self.slot_state
        )

    def step(self) -> bool:
        """One engine tick: expire -> admit/restore/preempt -> chunked
        prefill -> decode."""
        if (self.weight_check_interval is not None
                and self.stats["ticks"] > 0
                and self.stats["ticks"] % self.weight_check_interval == 0):
            self._check_weights()
        self._enforce_deadlines()
        self._admit()
        ran = self._prefill_tick()
        ran = self._decode_tick() or ran
        n_active = sum(st != _FREE for st in self.slot_state)
        self.stats["util_samples"].append((
            n_active / self.n_slots,
            self.allocator.n_used / max(self.n_blocks - 1, 1),
        ))
        self.stats["ticks"] += 1
        return ran

    def run(self, max_ticks: int = 100_000):
        """Drive to quiescence; returns every request that reached a
        terminal state (check ``Request.state`` — FINISHED is only one of
        five outcomes)."""
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished


# ------------------------------------------------------------------ reference


def _decode(cfg, params, tokens, caches, block_tables, lengths, mask,
            poison=None):
    return tfm.decode_step_paged(params, cfg, tokens, caches,
                                 block_tables=block_tables, lengths=lengths,
                                 write_mask=mask, poison_mask=poison)


def _prefill(cfg, params, tokens, caches, block_table, start, n_valid, slot):
    return tfm.prefill_chunk(params, cfg, tokens, caches, block_table=block_table,
                             start=start, n_valid=n_valid, slot=slot)


def generate_reference(params, cfg, prompt, max_new_tokens: int, *,
                       cache_len: Optional[int] = None,
                       logits: Optional[list] = None) -> list:
    """Sequential single-request greedy oracle on the dense cache path —
    the correctness pin for the batched paged engine (one request, one
    slot, per-token decode; no batching, no paging), on the device of the
    params. ``logits``, where given, receives the fp32 logits ``(V,)`` (on
    the host) from which each returned token was taken."""
    prompt = np.asarray(prompt, np.int64)
    if cache_len is None:
        cache_len = len(prompt) + max_new_tokens
    dev = params["embed"]["table"].device
    caches = tfm.init_cache(cfg, 1, cache_len, device=dev)
    step = None
    for t in prompt:
        step, caches = tfm.decode_step(
            params, cfg, torch.full((1, 1), int(t), device=dev), caches)
    out: list = []
    while len(out) < max_new_tokens:
        row = step[0, 0].float()
        out.append(int(row.argmax()))
        if logits is not None:
            logits.append(row.cpu())
        if len(out) < max_new_tokens:
            step, caches = tfm.decode_step(
                params, cfg, torch.full((1, 1), out[-1], device=dev), caches)
    return out
