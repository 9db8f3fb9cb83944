"""Fault-tolerant run supervision for chunked ensemble exports
(counterpart: psrsigsim_tpu/runtime/supervisor.py).

The north-star workload is a 10k-observation fold-mode ensemble streamed
through :meth:`FoldEnsemble.iter_chunks` into
:func:`~psrsigsim_torch.io.export.export_ensemble_psrfits` — a long,
multi-process run.  This module is the layer that makes that run survive
its environment:

- **Crash-safe output** — every PSRFITS file is already written
  temp-then-rename (atomic commit); the supervisor adds the durable
  record: per-file sha256 in an append-only fsync'd journal and, at
  finalize, in the export manifest.  ``resume="verify"`` re-hashes
  existing files against that record instead of trusting existence, so a
  torn disk or a truncated file from a previous crash is re-written, not
  silently shipped.
- **Chunk journal + atomic cursor** — one fsync'd journal line per
  committed chunk (files + hashes) and a temp+rename cursor file
  (:class:`~psrsigsim_torch.runtime.journal.ChunkJournal`).  A
  SIGKILL at ANY point leaves either a committed record or none; the
  resume path re-derives everything else from hashes, so output is
  bit-identical to an uninterrupted run.
- **NaN quarantine** — every chunk carries the per-(observation, channel)
  finite mask its kernel (or the unfused body) computes beside the codes,
  no per-observation host round-trip.  Non-finite observations are
  quarantined in the journal, re-run once with a fresh fold of their PRNG
  key (:meth:`FoldEnsemble.run_quantized_at`), and recorded in the
  manifest if still bad — one poisoned observation costs one
  observation, never the run.
- **Degradation ladder** — the export writer pool heals itself
  (respawn-with-backoff, then in-process serial writer;
  ``io/export._WriterPool``); the supervisor records when the run
  finished degraded.

Everything is exercised by the deterministic fault-injection layer in
:mod:`psrsigsim_torch.runtime.faults`; injection points are armed only by
an explicit :class:`~psrsigsim_torch.runtime.faults.FaultPlan`.

Host-only: nothing here imports torch.  :class:`ProcessSupervisor` is
the serving fleet's keep-one-subprocess-alive loop (spawn, watch,
restart under a jittered :class:`~psrsigsim_torch.runtime.retry.
RetryPolicy`).  ``observe_rfi``/``observe_rfi_retry``
journal a scenario export's RFI ground truth (the exporter calls them for
ensembles built with an RFI scenario).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time

import numpy as np

from .journal import (RUN_JOURNAL_NAME, ChunkJournal, file_sha,
                      load_chunk_journal, load_journal_records,
                      load_manifest, load_resume_hashes, remove_files,
                      write_manifest)
from .retry import RetryPolicy

# the journal loaders (runtime/journal.py) are re-exported for callers
# that import them from here
__all__ = ["RunSupervisor", "RunResult", "supervised_export",
           "ProcessSupervisor", "load_chunk_journal",
           "load_journal_records"]

_CURSOR_NAME = "run_cursor.json"

# folded into a quarantined observation's key for its single re-run: any
# fixed nonzero constant works; it only has to differ from the epoch
# folds (small ints) other derivations use
RETRY_FOLD_SALT = 0x7E7247


def file_done_check(path, hashes, verify, verified):
    """THE per-file resume predicate: existence under plain resume;
    existence + sha256 match against ``hashes`` under ``verify``
    (unknown or mismatched hashes mean "rewrite it").  Paths proven ok
    are remembered in the caller-owned ``verified`` set so chunk-skip /
    per-file / group predicates don't re-hash multi-GB outputs.  Shared by
    :meth:`RunSupervisor.file_ok` and the pod follower mirror — the
    definition of "done" is a single point of truth."""
    if path in verified:
        return True
    if not os.path.exists(path):
        return False
    if not verify:
        verified.add(path)
        return True
    want = hashes.get(os.path.basename(path))
    if want is not None and file_sha(path) == want:
        verified.add(path)
        return True
    return False


class RunResult:
    """What a supervised export run produced.

    Attributes
    ----------
    paths : list[str]
        Every output file path of the export (finished or quarantined).
    quarantined : list[int]
        Observations that stayed non-finite after their retry; their
        files are NOT written and the manifest records them.
    retried : list[int]
        Observations the NaN guard quarantined and re-ran.
    recovered : list[int]
        The subset of ``retried`` whose re-run came back finite.
    degraded : bool
        True when the writer pool fell back to the serial writer.
    hashes : dict[str, str]
        basename -> sha256 for every committed file.
    pipeline : dict or None
        The export's stage-telemetry snapshot (the manifest's
        ``pipeline`` key): per-stage busy seconds, fetched bytes, queue
        depths, and the named bottleneck stage.
    integrity : dict or None
        The run's integrity counters (the manifest's ``integrity``
        key) when the checksum lattice was armed: checks, checksum/
        audit mismatches, healed chunks, and the ``sdc_suspect`` flag.
    """

    def __init__(self, paths, quarantined, retried, recovered, degraded,
                 hashes, out_dir, pipeline=None, integrity=None):
        self.paths = list(paths)
        self.quarantined = sorted(quarantined)
        self.retried = sorted(retried)
        self.recovered = sorted(recovered)
        self.degraded = bool(degraded)
        self.hashes = dict(hashes)
        self.out_dir = out_dir
        self.pipeline = pipeline
        self.integrity = integrity

    def __repr__(self):
        return (f"RunResult(files={len(self.paths)}, "
                f"quarantined={self.quarantined}, retried={self.retried}, "
                f"degraded={self.degraded})")


class RunSupervisor:
    """Journal/quarantine/verify state machine for one supervised export.

    Wire-up: :func:`export_ensemble_psrfits` calls :meth:`file_ok` for
    resume decisions, :meth:`observe_chunk` on every fetched finite mask,
    and :meth:`chunk_committed` when a chunk's files are durably written
    (from the writer pool's FIFO drain or directly after serial writes);
    the retry phase reports through :meth:`record_retry`.  Tests drive
    the same machine through :func:`supervised_export`.
    """

    def __init__(self, out_dir, resume=True, verify=False, faults=None,
                 retry=True, retry_fold_salt=RETRY_FOLD_SALT):
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.verify = bool(verify)
        self.faults = faults
        self.retry_enabled = bool(retry)
        self.retry_fold_salt = int(retry_fold_salt)
        self._journal = ChunkJournal(
            os.path.join(self.out_dir, RUN_JOURNAL_NAME),
            os.path.join(self.out_dir, _CURSOR_NAME), faults=faults)
        self._hashes = {}        # basename -> sha256 of committed files
        self._verified = set()   # paths already proven ok THIS run
        self._quarantined = set()  # ever flagged non-finite this run
        self._rfi_obs = {}       # global obs id -> contaminated cell count
        self._retried = set()
        self._recovered = set()
        self._still_bad = set()
        self._degraded = False
        if not resume:
            remove_files(self._journal.path, self._journal.cursor_path)
        else:
            self._load_previous()

    # -- resume state ------------------------------------------------------

    def _load_previous(self):
        """Rebuild the hash record from the manifest and the journal —
        replayed through the repo's ONE torn-tail loader
        (:func:`load_journal_records`): a newline-less tail from a
        crash is skipped and truncated, costing at most one chunk's
        re-verify."""
        hashes, records = load_resume_hashes(self.out_dir,
                                             self._journal.path)
        self._hashes.update(hashes)
        for rec in records:
            if rec.get("e") in ("rfi", "rfi_retry"):
                # replay the scenario-truth record so a resumed
                # export's manifest summary stays COMPLETE (the
                # skipped committed chunks never re-observe)
                for i, c in zip(rec.get("obs", ()),
                                rec.get("cells", ())):
                    if c:
                        self._rfi_obs[int(i)] = int(c)
                    else:
                        self._rfi_obs.pop(int(i), None)

    # -- exporter hooks ----------------------------------------------------

    def file_ok(self, path):
        """Is this output file already done?  Existence under plain
        resume; existence + sha256 match under ``verify`` (unknown or
        mismatched hashes mean "rewrite it").

        A path proven ok once this run — verified here, or committed by
        this run's writers — is remembered, so the chunk-skip, per-file
        and group predicates don't re-hash multi-GB outputs two or three
        times each.  (Delegates to :func:`file_done_check`, the single
        definition of "done".)"""
        return file_done_check(path, self._hashes, self.verify,
                               self._verified)

    def poisoned_noise_norms(self, n_obs, noise_norms, default=1.0):
        """Apply the ``nan.obs`` injection point (tests only): NaN the
        configured observations' noise norms so non-finite data flows
        through the REAL pipeline and guard.  The clean array is what the
        manifest fingerprints and what the retry pass uses."""
        if self.faults is None:
            return noise_norms
        cfg = self.faults.config("nan.obs")
        if cfg is None:
            return noise_norms
        idx = np.asarray(cfg.get("indices", ()), np.int64)
        if idx.size == 0:
            return noise_norms
        if noise_norms is None:
            norms = np.full(n_obs, float(default), np.float64)
        else:
            norms = np.array(noise_norms, np.float64, copy=True)
        norms[idx] = np.nan
        return norms

    def observe_chunk(self, start, finite):
        """Digest one chunk's finite mask ``(count, Nchan)`` (computed on
        the device beside the codes):
        quarantine every observation with any non-finite channel, journal
        the event, and return the newly bad global ids."""
        finite = np.asarray(finite)
        bad_rows = np.where(~finite.all(axis=tuple(range(1, finite.ndim))))[0]
        recs = []
        for j in bad_rows:
            i = start + int(j)
            self._quarantined.add(i)
            recs.append({"e": "quarantine", "obs": i,
                         "bad_chans": int((~finite[j]).sum())})
        if recs:
            self._journal.append(*recs)
        return {rec["obs"] for rec in recs}

    def observe_rfi(self, start, mask):
        """Digest one chunk's ground-truth RFI mask ``(count,
        Nchan, nsub)`` from the scenario engine: journal which
        observations carry injected RFI and how many (channel, subint)
        cells it touches — provenance, not quarantine (the contamination
        is intentional physics; nothing re-runs).  Rides the same
        fsync'd append-only journal as the finite guard, so a resumed
        export keeps a complete contamination record."""
        mask = np.asarray(mask)
        hit = np.where(mask.any(axis=tuple(range(1, mask.ndim))))[0]
        fresh = []
        for j in hit:
            i = start + int(j)
            cells = int(mask[j].sum())
            if self._rfi_obs.get(i) == cells:
                continue  # a resumed chunk re-observing the same truth
            self._rfi_obs[i] = cells
            fresh.append((i, cells))
        if fresh:
            self._journal.append({
                "e": "rfi", "start": int(start),
                "obs": [i for i, _ in fresh],
                "cells": [c for _, c in fresh]})

    def observe_rfi_retry(self, indices, mask):
        """Overwrite the RFI truth for re-folded observations: a healed
        (``fold_salt``) re-run draws a FRESH realization, so the main
        pass's record for these observations is stale — the journal and
        manifest must follow the bytes actually delivered.  ``mask`` rows
        align with ``indices``; zero contaminated cells DELETES the
        entry (the healed draw may carry no RFI at all).  Also used to
        drop the record of still-bad observations whose files are not
        written."""
        mask = np.asarray(mask) if mask is not None else None
        changed = []
        for j, i in enumerate(indices):
            i = int(i)
            cells = int(mask[j].sum()) if mask is not None else 0
            prev = self._rfi_obs.get(i)
            if cells == 0:
                if prev is None:
                    continue
                del self._rfi_obs[i]
            else:
                if prev == cells:
                    continue
                self._rfi_obs[i] = cells
            changed.append((i, cells))
        if changed:
            self._journal.append({
                "e": "rfi_retry",
                "obs": [i for i, _ in changed],
                "cells": [c for _, c in changed]})

    def chunk_committed(self, token, results):
        """A chunk's files are durably on disk: record their hashes in
        the append-only journal (fsync'd — THE crash-safe record), then
        advance the atomic cursor.  ``token`` is the exporter's
        ``(kind, ident, paths)`` tag; ``results`` is
        ``[(path, sha_or_None), ...]`` from the writers."""
        files = {os.path.basename(p): sha for p, sha in results
                 if sha is not None}
        self._hashes.update(files)
        self._verified.update(p for p, _ in results)
        kind, ident = token[0], token[1]
        self._journal.commit({"e": "commit", "kind": kind, "ident": ident,
                              "files": files})
        if self.faults is not None:
            # disk.bitrot injection: decay a just-committed file AFTER
            # its sha256 became the durable record — exactly what the
            # scrub layer exists to find (tests only)
            from .integrity import maybe_bitrot

            for p, _sha in results:
                maybe_bitrot(self.faults, p)
        # run.kill: ``after_start`` matches the chunk start (one-obs-per-
        # file exports) or the group index (packed exports) — a target the
        # commit stream can never reach must not silently disarm a fault
        # test by construction, so both token families participate
        self._journal.maybe_kill(
            "run.kill", ident,
            targetable=kind in ("chunk", "group", "groups"))

    def record_retry(self, group, retried, still_bad):
        """The retry phase's verdict for one file/group: which
        observations were re-run, and which stayed non-finite."""
        self._retried.update(retried)
        self._recovered.update(i for i in retried if i not in still_bad)
        self._still_bad.update(still_bad)
        self._journal.append({
            "e": "retry", "group": int(group),
            "obs": [int(i) for i in retried],
            "still_bad": [int(i) for i in still_bad]})

    def record_integrity(self, kind, start, obs=(), healed=True,
                         detail=None):
        """Durable record of one integrity event (``kind`` is
        ``"checksum"`` — the lattice caught a fetch-window corruption —
        or ``"audit"`` — duplicate execution caught the device
        disagreeing with itself): which chunk, which observations, and
        whether verified re-execution healed it.  Rides the same
        fsync'd append-only journal as every other durable claim, so a
        resumed run (and the operator) sees the full corruption
        history."""
        rec = {"e": "integrity", "kind": str(kind), "start": int(start),
               "obs": [int(i) for i in obs], "healed": bool(healed)}
        if detail:
            rec["detail"] = dict(detail)
        self._journal.append(rec)

    def note_degraded(self):
        self._degraded = True
        self._journal.append({"e": "degraded"})

    def quarantined_indices(self):
        return set(self._quarantined)

    # -- finalize ----------------------------------------------------------

    def close(self):
        """Release the journal handle (idempotent).  The failure path of
        :func:`supervised_export` calls this so a driver looping over
        failed runs does not accumulate leaked fds; everything recorded
        so far is already durable (appends are fsync'd per commit)."""
        self._journal.close()

    def finalize(self, paths):
        """Fold the run's durable record into the manifest (atomic
        rewrite), close the journal, and summarize."""
        man = load_manifest(self.out_dir) or {}
        man["files"] = dict(sorted(self._hashes.items()))
        man["quarantined"] = sorted(int(i) for i in self._still_bad)
        if self._rfi_obs:
            # scenario provenance: how much injected RFI the dataset
            # carries (per-observation detail lives in the journal)
            man["rfi"] = {
                "obs_with_rfi": len(self._rfi_obs),
                "contaminated_cells": int(sum(self._rfi_obs.values())),
            }
        write_manifest(self.out_dir, man)
        self.close()
        return RunResult(paths, self._still_bad, self._retried,
                         self._recovered, self._degraded, self._hashes,
                         self.out_dir, pipeline=man.get("pipeline"),
                         integrity=man.get("integrity"))


class ProcessSupervisor:
    """Keep one subprocess alive: spawn, watch, restart with backoff.

    The process-level sibling of the export writer pool's self-healing
    loop, grown for the serving fleet: a replica that dies (OOM kill,
    preemption, a ``replica.kill`` chaos shot) is restarted under a
    :class:`~psrsigsim_torch.runtime.retry.RetryPolicy` — jittered, so a
    fleet respawning after a shared outage does not restart in lockstep
    — and a replica that keeps dying faster than ``healthy_after_s``
    exhausts the policy's attempt budget and is marked ``failed``
    instead of flapping forever (the bounded-respawn discipline the
    writer pool established; an unbounded respawn loop amplifies the
    outage it is supposed to absorb).

    Parameters
    ----------
    name : str
        Label for introspection/logging.
    spawn : callable
        Zero-argument callable returning a started
        :class:`subprocess.Popen`.  Called for the initial start and
        for every restart.
    policy : RetryPolicy, optional
        Restart backoff budget.  ``max_attempts`` bounds CONSECUTIVE
        unhealthy deaths; a child that stayed up ``healthy_after_s``
        resets the counter.  Default: 5 attempts, 0.05 s base, jittered.
    healthy_after_s : float
        Uptime after which a death counts as fresh (resets backoff).
    on_spawn, on_exit : callable, optional
        ``on_spawn(supervisor, proc)`` after every (re)spawn;
        ``on_exit(supervisor, returncode)`` after every child death
        (restart decisions already made) — the fleet uses these to
        re-wire routing to the replacement's new port.
    """

    def __init__(self, name, spawn, policy=None, healthy_after_s=5.0,
                 on_spawn=None, on_exit=None):
        self.name = str(name)
        self._spawn = spawn
        self.policy = policy if policy is not None else RetryPolicy(
            max_attempts=5, base_delay=0.05, max_delay=2.0, jitter=0.5)
        self.healthy_after_s = float(healthy_after_s)
        self._on_spawn = on_spawn
        self._on_exit = on_exit
        self._lock = threading.Lock()
        self._proc = None
        self._stopping = False
        self.failed = False
        self.restarts = 0
        self._consecutive_deaths = 0
        self._spawned_at = 0.0
        self._watcher = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Spawn the child and the watcher thread.  Idempotent on the
        WATCHER, not the child: while a watcher is alive (child running
        OR dead-and-in-backoff) a re-invocation is a no-op — a second
        watcher would double-count every death and leak an unsupervised
        child.  A fresh start (never started / stopped / failed) resets
        the death budget."""
        with self._lock:
            if self._watcher is not None and self._watcher.is_alive():
                return self
            self._stopping = False
            self.failed = False
            self._consecutive_deaths = 0
            self._respawn_locked()
            self._watcher = threading.Thread(
                target=self._watch, daemon=True,
                name=f"pss-supervise-{self.name}")
            self._watcher.start()
        return self

    def _respawn_locked(self):
        self._proc = self._spawn()
        self._spawned_at = time.monotonic()
        if self._on_spawn is not None:
            self._on_spawn(self, self._proc)

    def _watch(self):
        while True:
            with self._lock:
                proc = self._proc
            if proc is None:
                return
            rc = proc.wait()
            uptime = time.monotonic() - self._spawned_at
            with self._lock:
                if self._stopping:
                    return
                if self._on_exit is not None:
                    self._on_exit(self, rc)
                if uptime >= self.healthy_after_s:
                    self._consecutive_deaths = 0
                self._consecutive_deaths += 1
                if self._consecutive_deaths >= self.policy.max_attempts:
                    self.failed = True
                    self._proc = None
                    return
                d = self.policy.delay(self._consecutive_deaths - 1)
            if d > 0:
                time.sleep(d)
            with self._lock:
                if self._stopping:
                    return
                # count at respawn START: a restart in progress (the
                # replacement may take seconds to boot) is a restart
                self.restarts += 1
                self._respawn_locked()

    # -- control -----------------------------------------------------------

    def kill(self, sig=signal.SIGKILL):
        """Send ``sig`` to the child (chaos shots use SIGKILL); the
        watcher then restarts it under the policy."""
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    def restart(self, sig=signal.SIGTERM, kill_after_s=30.0):
        """GRACEFUL restart: send ``sig`` (drain) and let the watcher
        respawn the child when it exits — in-flight work finishes, then
        the process is replaced.  A child that ignores the drain signal
        is SIGKILLed after ``kill_after_s`` (the gray-failure case this
        exists for: a wedged replica may be too sick to honor SIGTERM).
        Non-blocking; the escalation runs on a daemon thread."""
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        self.kill(sig)

        def _escalate():
            try:
                proc.wait(kill_after_s)
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                except (ProcessLookupError, OSError):
                    pass

        threading.Thread(target=_escalate, daemon=True,
                         name=f"pss-restart-{self.name}").start()

    def stop(self, sig=signal.SIGTERM, timeout=30.0):
        """Orchestrated shutdown: no restart, ``sig`` (drain) first,
        SIGKILL after ``timeout``.  Returns the child's returncode (None
        if it was never running)."""
        with self._lock:
            self._stopping = True
            proc = self._proc
        if proc is None:
            return None
        if proc.poll() is None:
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if self._watcher is not None and self._watcher is not threading.current_thread():
            self._watcher.join(timeout)
        return proc.returncode

    # -- introspection -----------------------------------------------------

    @property
    def proc(self):
        with self._lock:
            return self._proc

    @property
    def pid(self):
        with self._lock:
            return self._proc.pid if self._proc is not None else None

    def alive(self):
        with self._lock:
            return (not self.failed and self._proc is not None
                    and self._proc.poll() is None)

    def __repr__(self):
        state = ("failed" if self.failed
                 else "alive" if self.alive() else "down")
        return (f"ProcessSupervisor({self.name!r}, {state}, "
                f"restarts={self.restarts})")


def supervised_export(ens, n_obs, out_dir, template, pulsar, *,
                      resume=True, faults=None, retry=True, **export_kw):
    """Run a chunked ensemble export under full supervision.

    A drop-in upgrade of
    :func:`~psrsigsim_torch.io.export.export_ensemble_psrfits` that layers
    on the fault-tolerant run loop (module docstring): per-file sha256
    journaling, hash-verified resume, the finite-mask NaN quarantine with a
    single salted retry, and the chunk journal that makes a SIGKILL at
    any point resumable to bit-identical output.

    Args:
        resume: ``True`` (skip files recorded as done), ``False`` (start
            clean — journal and cursor are reset), or ``"verify"``
            (re-hash every existing file against the journal/manifest
            record and rewrite any that fail — the mode for resuming
            after an unclean death on shared storage).
        faults: optional :class:`~psrsigsim_torch.runtime.faults.FaultPlan`
            (tests only).
        retry: re-run quarantined observations once with a fresh key
            fold; ``False`` records them as bad immediately.
        **export_kw: forwarded to ``export_ensemble_psrfits`` (seed, dms,
            noise_norms, chunk_size, writers, obs_per_file,
            ``integrity=`` — the silent-corruption defense of
            :mod:`psrsigsim_torch.runtime.integrity`, which needs exactly
            this supervised path for its durable event journal — ...).

    Returns:
        :class:`RunResult`.
    """
    from ..io.export import export_ensemble_psrfits
    from .dist import is_leader, is_pod

    if is_pod() and not is_leader():
        # checked before the supervisor opens (and would write) the journal
        raise RuntimeError(
            "pod followers must drive exports with "
            "psrsigsim_torch.io.export.pod_export_follower(); only the "
            "pod leader runs supervised_export")
    verify = resume == "verify"
    sup = RunSupervisor(out_dir, resume=bool(resume), verify=verify,
                        faults=faults, retry=retry)
    try:
        paths = export_ensemble_psrfits(
            ens, n_obs, out_dir, template, pulsar, resume=bool(resume),
            supervisor=sup, faults=faults, **export_kw)
    except BaseException:
        # the journal is already durable (fsync per commit) — just don't
        # leak its fd to drivers that loop over failing runs
        sup.close()
        raise
    return sup.finalize(paths)
