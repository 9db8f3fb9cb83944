"""Host-side runtime of the bulk export (counterpart: psrsigsim_tpu/runtime/).

- :mod:`~psrsigsim_torch.runtime.telemetry` — per-stage timers for the
  streaming export pipeline (dispatch/fetch/encode/write, queue depths,
  bytes), accumulated into the export manifest.
- :mod:`~psrsigsim_torch.runtime.retry` — capped exponential backoff for
  the writer pool's respawns.
- :mod:`~psrsigsim_torch.runtime.faults` — deterministic, explicitly
  armed fault injection at the export's named points.

Copies of the JAX package's modules (it cannot be imported without jax);
its run supervisor, integrity lattice, program registry and pod runtime
are not ported yet.
"""

from .faults import FaultPlan
from .retry import RetriesExhausted, RetryPolicy, call_with_retry
from .telemetry import StageTimers

__all__ = [
    "FaultPlan",
    "RetryPolicy",
    "RetriesExhausted",
    "StageTimers",
    "call_with_retry",
]
