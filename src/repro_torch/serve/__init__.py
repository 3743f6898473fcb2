"""Serving subsystem of the port: paged continuous batching + orthogonal
weight folding (``repro.serve``, with the same exports).

  engine     ServeEngine (paged KV, chunked prefill, admission control,
             preemption + swap-out, deadlines, divergence watchdog),
             Request, generate_reference oracle
  lifecycle  RequestState machine, typed terminal errors, Rejection
  faults     deterministic seeded FaultPlan (chaos testing)
  kv_cache   BlockAllocator (refcounted) / BlockTables / reset_slot /
             SwapPool + bit-exact gather/scatter swap round trip
  fold       fold trained ConstraintSet stacks into inference params,
             feasibility_distance (serve-time drift watchdog)
  parity     the engine's tokens against the oracle, with the tie rule
"""

from .engine import (  # noqa: F401
    AdmissionError,
    RejectReason,
    Request,
    ServeEngine,
    generate_reference,
    youngest_by_decode_progress,
)
from .faults import FAULT_KINDS, FaultEvent, FaultPlan  # noqa: F401
from .fold import (  # noqa: F401
    FoldFeasibilityError,
    FoldResult,
    extract_constraint_set,
    feasibility_distance,
    fold_constraint_set,
)
from .kv_cache import (  # noqa: F401
    BlockAllocator,
    BlockTables,
    SwapPool,
    SwapRecord,
    blocks_needed,
    gather_slot_kv,
    reset_slot,
    scatter_slot_kv,
    snapshot_checksum,
)
from .lifecycle import (  # noqa: F401
    TERMINAL_STATES,
    DeadlineExceededError,
    DivergenceError,
    PreemptedError,
    Rejection,
    RequestState,
    ServeError,
    SwapCorruptError,
    is_terminal,
)
