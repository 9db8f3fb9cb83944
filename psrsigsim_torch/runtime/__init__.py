"""Host-side runtime of the bulk export (counterpart: psrsigsim_tpu/runtime/).

- :mod:`~psrsigsim_torch.runtime.supervisor` — the resumable, self-healing
  run loop around the chunked ensemble -> PSRFITS export
  (:func:`supervised_export` / :class:`RunSupervisor`): crash-safe
  journaled output with sha256-verified resume, NaN quarantine with a
  salted retry, and an append-only chunk journal + atomic cursor; and
  :class:`ProcessSupervisor`, the serving fleet's spawn/watch/restart
  loop around one replica process.
- :mod:`~psrsigsim_torch.runtime.journal` — the durable record every
  chunked producer (export, study, dataset factory) writes through:
  crash-safe JSON, the export manifest, file hashes, and the append-only
  :class:`~psrsigsim_torch.runtime.journal.ChunkJournal` with its atomic
  cursor and ``*.kill`` fault points, plus the one torn-tail loader.
- :mod:`~psrsigsim_torch.runtime.integrity` — the silent-corruption
  defense: the checksum lattice (per-row digests computed on the card
  and re-checked on the host), duplicate-execution audits, the one
  per-chunk verdict every producer runs
  (:meth:`IntegrityChecker.verify_chunk`) and the scrub of committed
  files.
- :mod:`~psrsigsim_torch.runtime.telemetry` — per-stage timers for the
  streaming export pipeline (dispatch/fetch/encode/write, queue depths,
  bytes), accumulated into the export manifest.
- :mod:`~psrsigsim_torch.runtime.retry` — capped exponential backoff for
  the writer pool's respawns and the integrity heal.
- :mod:`~psrsigsim_torch.runtime.faults` — deterministic, explicitly
  armed fault injection at the export's named points.

- :mod:`~psrsigsim_torch.runtime.programs` — the program registry: one
  store of staged inputs and callables per hashable key with build and hit
  counts (the serving layer's width buckets resolve through a private
  instance of it).

The integrity layer also digests and scrubs the Monte-Carlo study's and
the dataset factory's artifacts (:func:`scrub_mc_dir`,
:func:`scrub_dataset_dir`); the serving cache scrubs its own artifacts
(:mod:`psrsigsim_torch.serve.cache`).

- :mod:`~psrsigsim_torch.runtime.dist` — pods: the ``PSS_POD_*``
  bootstrap with a byte-identical single-process fallback, the process
  index on every mesh position, the pod exchange behind
  :func:`device_get` (the TCP channel by default, ``torch.distributed``
  under ``PSS_POD_FETCH=collective``), the leader-rooted control channel
  with its peer-death watchdog, and the topology fingerprint the registry
  keys on.

Host-only: importing this package imports no torch (the export's spawn
writers import it).
"""

from .dist import (PodChannel, PodInfo, PodPeerLost, device_get, init_pod,
                   is_leader, is_pod, pod_info, pod_key, put_sharded,
                   shutdown_pod)
from .faults import FaultPlan
from .integrity import (IntegrityChecker, IntegrityError,
                        resolve_integrity, scrub_dataset_dir,
                        scrub_export_dir, scrub_mc_dir)
from .journal import load_chunk_journal, load_journal_records
from .programs import (ProgramRegistry, enable_compilation_cache,
                       global_registry)
from .retry import RetriesExhausted, RetryPolicy, call_with_retry
from .supervisor import (ProcessSupervisor, RunResult, RunSupervisor,
                         supervised_export)
from .telemetry import StageTimers

__all__ = [
    "FaultPlan",
    "PodChannel",
    "PodInfo",
    "PodPeerLost",
    "init_pod",
    "pod_info",
    "pod_key",
    "is_pod",
    "is_leader",
    "put_sharded",
    "device_get",
    "shutdown_pod",
    "IntegrityChecker",
    "IntegrityError",
    "resolve_integrity",
    "scrub_export_dir",
    "scrub_mc_dir",
    "scrub_dataset_dir",
    "load_chunk_journal",
    "load_journal_records",
    "ProgramRegistry",
    "enable_compilation_cache",
    "global_registry",
    "RetryPolicy",
    "RetriesExhausted",
    "StageTimers",
    "call_with_retry",
    "ProcessSupervisor",
    "RunResult",
    "RunSupervisor",
    "supervised_export",
]
