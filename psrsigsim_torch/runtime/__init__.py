"""Host-side runtime of the bulk export (counterpart: psrsigsim_tpu/runtime/).

- :mod:`~psrsigsim_torch.runtime.supervisor` — the resumable, self-healing
  run loop around the chunked ensemble -> PSRFITS export
  (:func:`supervised_export` / :class:`RunSupervisor`): crash-safe
  journaled output with sha256-verified resume, NaN quarantine with a
  salted retry, and an append-only chunk journal + atomic cursor.
- :mod:`~psrsigsim_torch.runtime.integrity` — the silent-corruption
  defense of the export: the checksum lattice (per-observation digests
  computed on the card by the packed-digest kernel and re-checked on the
  host), duplicate-execution audits and the scrub of committed files.
- :mod:`~psrsigsim_torch.runtime.telemetry` — per-stage timers for the
  streaming export pipeline (dispatch/fetch/encode/write, queue depths,
  bytes), accumulated into the export manifest.
- :mod:`~psrsigsim_torch.runtime.retry` — capped exponential backoff for
  the writer pool's respawns and the integrity heal.
- :mod:`~psrsigsim_torch.runtime.faults` — deterministic, explicitly
  armed fault injection at the export's named points.

Host-only: importing this package imports no torch (the export's spawn
writers import it).  The JAX package's ``ProcessSupervisor`` (serving),
its program registry, its pod runtime (``dist``) and the Monte-Carlo,
dataset and serving digests and scrubs are not ported yet.
"""

from .faults import FaultPlan
from .integrity import (IntegrityChecker, IntegrityError,
                        resolve_integrity, scrub_export_dir)
from .retry import RetriesExhausted, RetryPolicy, call_with_retry
from .supervisor import (RunResult, RunSupervisor, load_chunk_journal,
                         load_journal_records, supervised_export)
from .telemetry import StageTimers

__all__ = [
    "FaultPlan",
    "IntegrityChecker",
    "IntegrityError",
    "resolve_integrity",
    "scrub_export_dir",
    "load_chunk_journal",
    "load_journal_records",
    "RetryPolicy",
    "RetriesExhausted",
    "StageTimers",
    "call_with_retry",
    "RunResult",
    "RunSupervisor",
    "supervised_export",
]
