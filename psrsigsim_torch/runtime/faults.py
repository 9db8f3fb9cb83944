"""Deterministic fault injection for the export, supervisor and serving
stack (a copy of psrsigsim_tpu/runtime/faults.py, cut to the points the
port has: the pods' ``pod.kill`` is not among them, and naming it raises
like any unknown point).

Robustness code that is only exercised by real outages is dead code with
a pager attached.  This module gives every failure-handling path in the
run supervisor, the integrity layer, the export writer pool, the serving
cache and the fleet router a *named injection point* that tests arm
explicitly:

========================  ====================================================
point                     where it fires
========================  ====================================================
``writer.crash``          :func:`psrsigsim_torch.io.export._worker_write`,
                          just before writing a matching file — the worker
                          process dies with SIGKILL (what a OOM-killed or
                          preempted writer looks like to the pool).
``shm.attach``            :func:`psrsigsim_torch.io.export._attach_chunk` in
                          a worker — raises ``OSError`` (a vanished/renamed
                          segment), exercising per-job retry without killing
                          the process.
``file.partial``          the fast writer, mid-write — writes a truncated
                          ``.tmp`` then SIGKILLs the writing process, leaving
                          exactly the partial temp file a power cut would.
``nan.obs``               the run supervisor — poisons the configured
                          observations' noise norms to NaN on the FIRST pass
                          only, so the non-finite data flows through the real
                          finite-mask guard and the quarantine/retry
                          machinery.  Config: ``{"indices": [...]}``.
``run.kill``              the run supervisor, immediately after the journal
                          commit of the chunk starting at ``after_start``
                          (or, for packed ``obs_per_file>1`` exports, the
                          group with that index) — SIGKILLs the exporting
                          process itself (the preempted-host case for
                          kill/resume tests).  Config:
                          ``{"after_start": int}``; omit ``after_start`` to
                          kill after the first commit of any kind.
``dataset.kill``          the dataset factory
                          (:meth:`psrsigsim_torch.datasets.DatasetFactory.
                          run`), immediately after the journal commit of
                          the record chunk starting at ``after_start`` —
                          SIGKILLs the corpus-writing process, for the
                          factory's kill/resume byte-identity tests.
                          Config: ``{"after_start": int}``; omit to kill
                          after the first chunk commit.
``mc.kill``               the Monte-Carlo study's sweep
                          (:meth:`psrsigsim_torch.mc.MonteCarloStudy.run`),
                          right after the journal commit of the chunk
                          starting at ``after_start`` (any chunk when
                          omitted) — SIGKILLs the sweeping process, for the
                          study's kill/resume tests.  Config:
                          ``{"after_start": int}``.
``serve.kill``            the serving result cache
                          (:meth:`psrsigsim_torch.serve.ResultCache.put`),
                          immediately after the journal commit of the
                          ``after_puts``-th artifact this process wrote
                          — SIGKILLs the serving process (the preempted-
                          server case: tests/serve_runner.py proves the
                          relaunched server verifies its cache and
                          serves the committed results without device
                          execution).  Config: ``{"after_puts": int}``;
                          omit to kill after the first commit.
``serve.reject``          :meth:`psrsigsim_torch.serve.SimulationService.
                          submit` — the admission check force-rejects
                          the request (with a retry-after) exactly as a
                          saturated queue would, exercising the client-
                          visible backpressure path.  Config: ``times``
                          only.
``replica.kill``          the fleet router
                          (:class:`psrsigsim_torch.serve.FleetRouter`),
                          right BEFORE the ``after_requests``-th
                          response would be produced — SIGKILLs the
                          replica the request routed to (or the one
                          named by ``replica``), so the forward that
                          follows runs into the freshly dead socket:
                          the hardest-ordering mid-traffic death for
                          failover/restart proofs
                          (tests/test_torch_fleet_proofs.py).  Config:
                          ``{"after_requests": int, "replica": int}``;
                          both optional (defaults: first request, the
                          routed replica).
``cache.contend``         :meth:`psrsigsim_torch.serve.ResultCache.put`,
                          between the artifact rename and the journal
                          append — sleeps ``hold_s`` (default 0.05)
                          INSIDE the claim-held/journal-absent window,
                          widening exactly the race the cross-process
                          commit discipline exists for so contention
                          stress tests hit it reliably.  Config:
                          ``{"hold_s": float}``.
``route.blackhole``       the fleet router, before forwarding to the
                          routed replica — raises ``ConnectionError``
                          as if the replica's socket vanished (network
                          partition without a process death),
                          exercising the failover re-route path while
                          the replica itself stays healthy.  Config:
                          ``times`` / ``match`` (token is the replica
                          id).
``replica.slow``          the replica HTTP front end
                          (:mod:`psrsigsim_torch.serve.http`), before a
                          ``/simulate`` request is handled — sleeps
                          ``delay_s`` so the replica is alive-but-slow
                          (the GRAY failure health polling cannot see:
                          ``/healthz`` still answers instantly), which
                          the router's latency circuit breaker must
                          eject.  Config: ``{"delay_s": float}`` plus
                          ``times`` / ``match`` (token is the replica
                          id, so one plan can slow exactly one fleet
                          member).
``cache.enospc``          :meth:`psrsigsim_torch.serve.ResultCache.put`
                          — raises ``OSError(ENOSPC)`` mid-commit, the
                          disk-full case for the shared cache tier.
                          ``at: "artifact"`` (default) fires after the
                          tmp bytes are written but before rename, so
                          the cleanup path MUST unlink the tmp and
                          release the claim; ``at: "journal"`` fires
                          before the journal append, leaving a durable
                          but unindexed artifact (the same benign state
                          a SIGKILL between rename and append leaves).
                          The serving engine degrades to pass-through
                          (result served uncached, loud metric), never
                          a failed request.  Config: ``{"at": str}``
                          plus ``times`` / ``match`` (token is the
                          spec hash).
``device.sdc``            the integrity-armed producers (the export's
                          :meth:`psrsigsim_torch.parallel.FoldEnsemble.
                          iter_chunks`, the study's chunk, the dataset
                          factory's chunk, whose ident is the chunk's
                          first record, and the serving batch, matched
                          on its first request's spec hash) — ONE element of the chunk's
                          device output buffer is perturbed before any
                          digest is computed, so the checksum lattice
                          attests the WRONG bytes (that is what silent
                          device corruption looks like) and only the
                          duplicate-execution audit can catch it.
                          Config: ``{"after_start": int}`` (chunk start)
                          plus ``times``.
``host.corrupt``          the same producers, host side — one element of
                          a FETCHED buffer is flipped before the exporter
                          (or the factory) encodes it (the fetch->encode window), which the
                          checksum lattice's host re-check must catch.
                          Config: ``{"after_start": int}`` / ``match`` /
                          ``times``.
``disk.bitrot``           immediately AFTER a durable commit of export
                          files, of a dataset chunk or of a serving cache
                          artifact (token the spec hash there; else
                          ``start=<first record>``, the byte at that
                          record's slot) — one byte of the committed file is
                          XOR-flipped, after its sha256 became the
                          journal's record: the decay the scrub layer
                          (:mod:`psrsigsim_torch.runtime.integrity`)
                          exists to find.  Config: ``match`` (file
                          basename) / ``times``.
========================  ====================================================

Arming is explicit and local: a :class:`FaultPlan` is built by a test and
passed down via the ``faults=`` parameter; production call sites carry
``plan=None`` and :func:`should_fire` is a single ``is None`` check —
there is no environment variable, global registry, or import-time hook
that could arm injection in production.

Determinism across processes: each point fires a bounded number of times
(``times``, default 1), tracked by ``O_CREAT|O_EXCL`` marker files in the
plan's scratch directory — atomic on POSIX, shared by parent and spawn
workers, and persistent across the respawns/resumes a single test
orchestrates.  A respawned worker therefore does NOT re-fire an exhausted
point, which is what lets a self-healing test converge.
"""

from __future__ import annotations

import os
import signal

__all__ = ["FaultPlan", "should_fire", "crash_process", "POINTS"]

POINTS = ("writer.crash", "shm.attach", "file.partial", "nan.obs",
          "run.kill", "dataset.kill", "mc.kill", "serve.kill",
          "serve.reject", "replica.kill", "cache.contend",
          "route.blackhole", "replica.slow", "cache.enospc",
          "device.sdc", "host.corrupt", "disk.bitrot")


class FaultPlan:
    """A set of armed injection points with cross-process once-semantics.

    Parameters
    ----------
    scratch_dir : str
        Directory for the atomic marker files (must outlive the run;
        tests pass a tmp dir).  Created if missing.
    spec : dict
        ``{point: config}``.  Every config may carry ``match`` (substring
        the call-site token must contain) and ``times`` (shot budget,
        default 1); point-specific keys are documented in the table
        above.  Unknown point names are rejected loudly — a typo must
        not silently disarm a fault test.

    Instances are plain picklable data (they ride to spawn workers inside
    the export writer state).
    """

    def __init__(self, scratch_dir, spec):
        unknown = set(spec) - set(POINTS)
        if unknown:
            raise ValueError(
                f"unknown fault point(s) {sorted(unknown)}; valid points: "
                f"{list(POINTS)}")
        self.scratch_dir = str(scratch_dir)
        self.spec = {k: dict(v) for k, v in spec.items()}
        os.makedirs(self.scratch_dir, exist_ok=True)

    def config(self, point):
        """The raw config dict for ``point`` (None when unarmed)."""
        return self.spec.get(point)

    def fire(self, point, token=""):
        """True exactly ``times`` times per matching (point, plan) —
        atomically across all processes sharing the plan."""
        cfg = self.spec.get(point)
        if cfg is None:
            return False
        match = cfg.get("match")
        if match is not None and match not in str(token):
            return False
        times = int(cfg.get("times", 1))
        stem = point.replace(".", "_")
        for k in range(times):
            marker = os.path.join(self.scratch_dir, f"{stem}.{k}")
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            os.close(fd)
            return True
        return False

    def shots_fired(self, point):
        """How many times ``point`` has fired so far (marker count)."""
        stem = point.replace(".", "_") + "."
        try:
            names = os.listdir(self.scratch_dir)
        except FileNotFoundError:
            return 0
        return sum(1 for n in names if n.startswith(stem))

    def __repr__(self):
        return f"FaultPlan({self.scratch_dir!r}, {self.spec!r})"


def should_fire(plan, point, token=""):
    """None-safe arming check used at every injection point.

    ``plan`` is whatever rode down the call chain (a :class:`FaultPlan`
    or None).  Production paths pass None and pay one identity check.
    """
    return plan is not None and plan.fire(point, token)


def crash_process():
    """Die the way the fault being modeled dies: SIGKILL, no cleanup, no
    Python teardown — ``finally`` blocks and atexit hooks must NOT run,
    that is the point of the test."""
    os.kill(os.getpid(), signal.SIGKILL)
