"""The serving face of :mod:`repro_torch.faults`: ``FAULT_KINDS`` here is
the serving subset, so ``FaultPlan.random(..., kinds=FAULT_KINDS)``
samples the four engine kinds (``repro.serve.faults``)."""

from ..faults import (  # noqa: F401
    SERVE_FAULT_KINDS as FAULT_KINDS,
    FaultEvent,
    FaultPlan,
)
