"""The in-process simulation request engine: dynamic batching with
admission control, deadlines, and batching-invariant results (counterpart:
psrsigsim_tpu/serve/service.py).

``SimulationService`` is the layer between "a concurrent stream of
request dicts" and "padded device batches through staged width buckets":

* **Admission** — a bounded queue with explicit backpressure: a full
  queue (or an armed ``serve.reject`` fault, or a draining server)
  rejects with :class:`RequestRejected` carrying ``retry_after_s`` —
  the client is told to come back, never silently stalled.  Per-request
  deadlines expire queued work cleanly before it wastes device time.
* **Deadline-aware load shedding** — admission also rejects a request
  whose deadline is provably unmeetable: when the remaining budget is
  smaller than the predicted queue wait (queue depth x the observed
  per-request service-time EWMA), the request is shed at submit time
  with a 429 instead of queuing work that can only expire.  The
  ``Retry-After`` hint is LOAD-PROPORTIONAL: the estimated time for the
  current queue to drain at the observed service rate (floored at the
  static ``retry_after_s``), monotone in queue depth — client backoff
  scales with actual congestion instead of a constant.
* **Cache-tier degradation** — an ``OSError`` from a result-cache
  commit (ENOSPC on the shared tier) degrades serving to PASS-THROUGH:
  the computed result is still returned, the failure is counted loudly
  (``cache_put_errors`` / ``cache_degraded`` in ``/metrics``), and the
  flag clears on the next successful commit.  A full disk costs cache
  hits, never requests.
* **Coalescing** — a batcher thread groups compatible requests (same
  geometry hash) arriving within a short window, rounds the group up to
  a bucket width (padded rows repeat the batch's requests and are
  trimmed), and executes ONE staged bucket per batch
  (:class:`~psrsigsim_torch.serve.ProgramRegistry`).  The batcher thread
  is the only thread that launches device work; it runs inside the
  service's device (``torch.cuda.device``), since a new thread starts on
  device 0.  The HTTP and aio threads never touch the device.
* **Batching invariance** — each request's PRNG key derives from
  (seed, canonical-spec hash) on the dedicated ``"serve"`` RNG stage, so
  a result is bit-identical whether the request ran alone, coalesced
  with strangers, or in a different bucket width (the serving analogue
  of the ensemble layer's chunk invariance; pinned by
  tests/test_torch_serve.py).  The keys are derived on the host, as
  uint32 key data, in one batched threefry evaluation per batch.
* **Result cache** — a hit in the content-addressed cache
  (:class:`~psrsigsim_torch.serve.ResultCache`) completes the request at
  submit time without touching the queue or the device.
* **Telemetry** — enqueue/batch/compute/respond stage seconds plus the
  end-to-end ``request`` latency accumulate in a shared
  :class:`~psrsigsim_torch.runtime.StageTimers` (exact p50/p95/p99 over
  the latest 4,096 samples in ``/metrics``).

Under a pod (:mod:`psrsigsim_torch.runtime.dist`) the service is the
group's leader: its buckets span every process of the group
(:class:`~psrsigsim_torch.serve.pod.PodProgramRegistry`, each batch
broadcast to the followers before it runs), while the queue, the cache and
the HTTP front end stay the leader's alone.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..runtime.faults import should_fire
from ..runtime.telemetry import StageTimers
from ..scenarios.registry import EFFECT_ORDER, stack_label
from .cache import ResultCache
from .programs import DEFAULT_WIDTHS, ProgramRegistry
from .spec import (build_geometry, canonicalize, geometry_hash,
                   scenario_param_vector, scenario_stack, spec_hash)

__all__ = ["SimulationService", "RequestRejected", "RequestFailed",
           "SERVE_STAGES", "SERVE_LATENCY_STAGES", "EFFECT_STAGES"]

#: per-effect device-time stages: each batch's compute seconds are
#: attributed to every effect its geometry enables, so ``/metrics``
#: shows where device time goes under a mixed-scenario traffic profile
EFFECT_STAGES = tuple(f"effect:{n}" for n in EFFECT_ORDER)

#: stages the serving engine reports into StageTimers: per-call busy
#: seconds for the engine's four phases plus the e2e request latency
SERVE_STAGES = ("enqueue", "batch", "compute", "respond",
                "request") + EFFECT_STAGES

#: stages of SERVE_STAGES that are NOT exclusive busy time — e2e request
#: latency, and the per-effect attributions (each re-counts compute
#: seconds) — excluded from the snapshot's ``bottleneck`` pick
SERVE_LATENCY_STAGES = ("request",) + EFFECT_STAGES


class RequestRejected(Exception):
    """Admission control said no.  ``retry_after_s`` is the client's
    backoff hint (the HTTP layer maps this to 429/503 + Retry-After)."""

    def __init__(self, reason, retry_after_s=0.5, draining=False):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.draining = bool(draining)
        super().__init__(f"request rejected: {reason} "
                         f"(retry after {retry_after_s:.2f}s)")


class RequestFailed(Exception):
    """A terminal non-success outcome surfaced by :meth:`result`."""

    def __init__(self, status, detail):
        self.status = status
        self.detail = detail
        super().__init__(f"request {status}: {detail}")


class _Request:
    __slots__ = ("id", "canonical", "geom_hash", "status", "error",
                 "result", "cached", "done", "t_submit", "deadline",
                 "callbacks")

    def __init__(self, rid, canonical, geom_hash, deadline):
        self.id = rid
        self.canonical = canonical
        self.geom_hash = geom_hash
        self.status = "queued"
        self.error = None
        self.result = None
        self.cached = False
        self.done = threading.Event()
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.callbacks = []   # fired once, on terminal transition


class SimulationService:
    """Dynamic-batching simulation serving engine (module docstring).

    Parameters
    ----------
    cache_dir : str or None
        Root of the content-addressed result cache (``compile_cache/``
        under it is passed on as the reference's compilation-cache
        directory, which enables nothing here).  None disables the cache
        (every request executes).
    widths : tuple of int
        Admitted bucket widths (batches round up to the smallest fit).
    max_queue : int
        Bound on QUEUED requests; beyond it submits are rejected with a
        retry-after (running/done requests don't count).
    batch_window_s : float
        How long the batcher holds the head request open for strangers
        to coalesce with (the latency cost of throughput).
    verify_cache : bool
        Re-hash every cached artifact against the journal on startup —
        the relaunched-server mode (serve_runner uses it).
    telemetry : StageTimers, optional
        Shared timer object; by default the service owns one.
    faults : FaultPlan, optional
        Arms ``serve.kill`` / ``serve.reject`` (tests only).
    cache_hot_bytes : int, optional
        In-memory hot-tier byte budget forwarded to
        :class:`~psrsigsim_torch.serve.ResultCache` (default: the
        ``PSS_CACHE_HOT_MB`` env, 256 MiB; 0 disables the tier).
    device : optional
        Where the buckets run: the CUDA card by default (raising when
        there is none); ``"cpu"`` runs them on the host, as the tests do.
    integrity : optional
        The silent-corruption defense
        (:mod:`psrsigsim_torch.runtime.integrity`): ``None`` consults
        ``PSS_INTEGRITY`` (unset = off, the zero-cost default).  Armed,
        every executed batch's device output carries a device-computed
        per-row digest re-checked on the host copy before any row is
        cached or served (closing the fetch->respond window), a
        deterministic sample of batches is duplicate-executed and
        compared claim-for-claim (mismatch -> verified re-execution
        heals, or :class:`~psrsigsim_torch.runtime.IntegrityError` fails
        the batch's requests with the evidence), cache commits carry
        the attested ``dig`` in their journal meta, and the sticky
        ``sdc_suspect`` flag surfaces in ``health()`` for the fleet's
        breaker/eject path.  The device digest is
        :func:`~psrsigsim_torch.runtime.integrity.device_digest_rows` of
        the ``(B, Nchan, Nph)`` output, computed where it lies.
    """

    def __init__(self, cache_dir=None, widths=DEFAULT_WIDTHS, max_queue=64,
                 batch_window_s=0.002, retry_after_s=0.5, telemetry=None,
                 faults=None, verify_cache=False, compile_cache_dir=None,
                 max_done=1024, replica_id=None, cache_hot_bytes=None,
                 integrity=None, device=None):
        import os

        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the batcher thread enters this device: name it, since a new
            # thread's current device is 0, not the constructor's
            self.device = torch.device("cuda", torch.cuda.current_device())
        if compile_cache_dir is None and cache_dir is not None:
            compile_cache_dir = os.path.join(str(cache_dir), "compile_cache")
        self.replica_id = replica_id
        self.started_at = time.time()
        from ..runtime.dist import is_pod, pod_channel, pod_info

        self._pod = pod_info()
        if is_pod():
            # pod leader: the buckets span every process of the group; each
            # batch is broadcast to the followers (serve/pod.py) — the
            # HTTP/cache/queue half of the service is the leader's alone
            from .pod import PodProgramRegistry

            self.registry = PodProgramRegistry(
                widths, compile_cache_dir=compile_cache_dir,
                channel=pod_channel(), device=self.device)
        else:
            self.registry = ProgramRegistry(
                widths, compile_cache_dir=compile_cache_dir,
                device=self.device)
        self.cache = (ResultCache(cache_dir, verify=verify_cache,
                                  faults=faults,
                                  hot_max_bytes=cache_hot_bytes)
                      if cache_dir is not None else None)
        self.timers = (telemetry if telemetry is not None
                       else StageTimers(extra_stages=SERVE_STAGES,
                                        latency_stages=SERVE_LATENCY_STAGES))
        from ..runtime.integrity import refuse_on_pod, resolve_integrity

        self.integrity = resolve_integrity(integrity, fingerprint="serve",
                                           faults=faults)
        refuse_on_pod(self.integrity is not None, "serving")
        self.max_queue = int(max_queue)
        self.batch_window_s = float(batch_window_s)
        self.retry_after_s = float(retry_after_s)
        self.max_done = int(max_done)
        self._faults = faults
        # the serving front end (AioHTTPServer registers itself here):
        # health()/metrics() fold its stats() in so the fleet health
        # poll and the autoscaler see connection pressure, not just
        # queue depth
        self.frontend = None
        self._cond = threading.Condition()
        self._queue = deque()
        self._requests = OrderedDict()
        self._draining = False
        self.rejected = 0
        self.expired = 0
        self.shed = 0             # rejected as deadline-unmeetable
        self.cache_hits = 0
        self.served = 0
        self.cache_put_errors = 0  # commits lost to OSError (ENOSPC...)
        self.cache_degraded = False  # pass-through mode (last put failed)
        # observed per-request service time (compute seconds / batch
        # rows), EWMA — the queue-wait predictor behind load shedding
        # and the load-proportional Retry-After hint.  0.0 until the
        # first batch lands (no shedding before there is evidence).
        self._svc_ewma = 0.0
        self._svc_alpha = 0.3
        # per-scenario-stack request counters (admitted submits,
        # including cache hits), keyed by the stack label ("base",
        # "scintillation+rfi", ...) — the /metrics traffic profile
        self.scenario_requests = {}
        self._batcher = threading.Thread(target=self._batch_loop,
                                         daemon=True, name="pss-serve-batch")
        self._batcher.start()

    # -- public API --------------------------------------------------------

    def warmup(self, spec):
        """Stage a geometry before traffic: validate, build the fold
        config, build every bucket width (staged on the device and run
        once).  Returns the geometry hash.  Runs on the caller's thread,
        inside the service's device."""
        canonical = canonicalize(spec)
        gh = geometry_hash(canonical)
        if not self.registry.known(gh):
            cfg, profiles, noise_norm = build_geometry(canonical)
            with self._on_device():
                self.registry.register(gh, cfg, profiles, noise_norm,
                                       warmup=True,
                                       scenario=scenario_stack(canonical),
                                       canonical=canonical)
        return gh

    def _on_device(self):
        """The context that makes the service's card the current device
        (a new thread starts on device 0); nothing to enter on the CPU."""
        import contextlib

        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def submit(self, spec, deadline_s=None):
        """Admit one request; returns ``(request_id, status)`` where
        status is ``"done"`` (cache hit — no queue, no device),
        ``"queued"``, or the status of an identical in-flight request it
        coalesced onto.  Raises :class:`~psrsigsim_torch.serve.SpecError`
        on a bad spec and :class:`RequestRejected` on backpressure."""
        t0 = time.perf_counter()
        canonical = canonicalize(spec)
        rid = spec_hash(canonical)
        gh = geometry_hash(canonical)
        deadline = (t0 + float(deadline_s)
                    if deadline_s is not None else None)
        label = stack_label(canonical.get("scenarios", []))
        with self._cond:
            # traffic profile: every spec-valid submit counts, whatever
            # its outcome (cache hit / coalesced / queued / rejected)
            self.scenario_requests[label] = (
                self.scenario_requests.get(label, 0) + 1)
            coalesced = self._coalesce(rid, deadline)
            if coalesced is not None:
                return rid, coalesced

        cached_arr = self.cache.get(rid) if self.cache is not None else None
        if cached_arr is not None:
            req = _Request(rid, canonical, gh, None)
            req.status = "done"
            req.cached = True
            req.result = cached_arr
            req.done.set()
            with self._cond:
                self._requests[rid] = req
                self.cache_hits += 1
                self._evict_terminal()
            self.timers.add("enqueue", time.perf_counter() - t0)
            self.timers.add("request", time.perf_counter() - t0)
            return rid, "done"

        with self._cond:
            # re-check under the lock: a concurrent identical submit may
            # have enqueued between the first check and here (TOCTOU) —
            # without this, two threads would both enqueue the same
            # content and the batch would execute it twice
            coalesced = self._coalesce(rid, deadline)
            if coalesced is not None:
                return rid, coalesced
            if self._draining:
                self.rejected += 1
                raise RequestRejected("server draining",
                                      self.retry_after_s, draining=True)
            if should_fire(self._faults, "serve.reject", token=rid):
                self.rejected += 1
                raise RequestRejected("injected admission rejection",
                                      self._retry_hint(len(self._queue)))
            depth = len(self._queue)
            if deadline_s is not None:
                # deadline-aware shedding: reject NOW when the remaining
                # budget is smaller than the predicted queue wait.  The
                # EWMA divides batch compute by batch rows, so batching
                # amortization is priced in at the HISTORICAL batch
                # width — the estimate overshoots when coalescing
                # suddenly widens (a shed then hit a request that was
                # probably, not provably, doomed) and undershoots when
                # it narrows (the _expire path still backstops those).
                est_wait = depth * self._svc_ewma
                if deadline_s <= 0 or est_wait > deadline_s:
                    self.shed += 1
                    self.rejected += 1
                    raise RequestRejected(
                        f"deadline {max(deadline_s, 0.0):.3f}s unmeetable: "
                        f"predicted queue wait {est_wait:.3f}s "
                        f"(depth {depth})", self._retry_hint(depth))
            if depth >= self.max_queue:
                self.rejected += 1
                raise RequestRejected(
                    f"queue full ({self.max_queue})",
                    self._retry_hint(depth))
            req = _Request(rid, canonical, gh, deadline)
            self._requests[rid] = req
            self._queue.append(req)
            self.timers.depth("serve_queue", len(self._queue))
            self._cond.notify_all()
        self.timers.add("enqueue", time.perf_counter() - t0)
        return rid, "queued"

    def _retry_hint(self, depth):
        """Load-proportional ``Retry-After``: the estimated seconds for
        the CURRENT queue to drain at the observed per-request service
        rate, floored at the static configured hint — monotone in queue
        depth (pinned by a unit test), so client backoff scales with
        actual congestion instead of a constant.  Before any batch has
        executed (EWMA 0) the static floor applies."""
        return max(self.retry_after_s, depth * self._svc_ewma)

    def _observe_service_time(self, per_request_s):
        """Fold one batch's observed per-request seconds into the
        service-time EWMA (the shed/hint predictor).  Caller need not
        hold the lock."""
        with self._cond:
            if self._svc_ewma == 0.0:
                self._svc_ewma = float(per_request_s)
            else:
                self._svc_ewma = (self._svc_alpha * float(per_request_s)
                                  + (1.0 - self._svc_alpha) * self._svc_ewma)

    def _finish(self, req):
        """Terminal transition: set the done event and fire registered
        completion callbacks exactly once.  The Condition's lock is an
        RLock, so this is safe from call sites already holding it;
        callbacks run on the completing thread (the batcher) and must
        only schedule work, never block."""
        with self._cond:
            req.done.set()
            cbs, req.callbacks = req.callbacks, []
        for fn in cbs:
            try:
                fn()
            except Exception:  # noqa: BLE001 - a bad callback must not
                pass           # poison the batch that completed it

    def on_done(self, rid, fn):
        """Register ``fn()`` to run when request ``rid`` reaches a
        terminal state (done/expired/error).  Fires immediately on the
        caller's thread when the request already completed — or when
        the id is unknown to the bounded status table (its result, if
        any, lives in the cache; the caller resolves via
        :meth:`result`).  This is the aio front end's no-thread-blocked
        wait path."""
        with self._cond:
            req = self._requests.get(rid)
            if req is not None and not req.done.is_set():
                req.callbacks.append(fn)
                return
        fn()

    def _coalesce(self, rid, deadline):
        """Coalesce onto an identical in-flight/completed request
        (content-addressed identity): returns its status, or None when
        there is nothing live to coalesce onto (expired/errored entries
        allow resubmission).  A resubmit carrying an EARLIER deadline
        tightens the pending request's — the strictest client wins,
        instead of the second deadline being silently dropped.  Caller
        holds the lock."""
        req = self._requests.get(rid)
        if req is None or req.status not in ("queued", "running", "done"):
            return None
        if deadline is not None and not req.done.is_set():
            if req.deadline is None or deadline < req.deadline:
                req.deadline = deadline
        return req.status

    def status(self, rid):
        """JSON-ready status for one request id (KeyError when unknown —
        which includes terminal requests evicted from the bounded status
        table whose results live on in the cache)."""
        with self._cond:
            req = self._requests.get(rid)
            if req is None:
                if self.cache is not None and rid in self.cache:
                    return {"id": rid, "status": "done", "cached": True}
                raise KeyError(rid)
            out = {"id": rid, "status": req.status, "cached": req.cached}
            if req.error is not None:
                out["error"] = req.error
            return out

    def result(self, rid, timeout=None):
        """Block for a request's folded-profile artifact
        (``(Nchan, Nph)`` float32).  Raises KeyError (unknown id),
        TimeoutError, or :class:`RequestFailed` (expired/error)."""
        with self._cond:
            req = self._requests.get(rid)
        if req is None:
            if self.cache is not None:
                arr = self.cache.get(rid)
                if arr is not None:
                    return arr
            raise KeyError(rid)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {rid[:12]} still {req.status}")
        if req.status != "done":
            raise RequestFailed(req.status, req.error or req.status)
        if req.result is not None:
            return req.result
        if self.cache is not None:
            arr = self.cache.get(rid)
            if arr is not None:
                return arr
        raise RequestFailed("error", "result artifact unavailable")

    def drain(self, timeout=30.0):
        """Graceful shutdown: stop admitting, let the batcher finish the
        queue, join it.  Returns True when fully drained."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._batcher.join(timeout)
        return not self._batcher.is_alive()

    def close(self, timeout=30.0):
        ok = self.drain(timeout)
        # a pod leader's registry holds followers blocked on its exec
        # stream: the drain above guarantees no more batches, so the clean
        # end of the stream belongs here, for every caller that closes the
        # service
        if hasattr(self.registry, "shutdown_followers"):
            self.registry.shutdown_followers()
        if self.cache is not None:
            self.cache.close()
        return ok

    def health(self):
        """The ``/healthz`` payload, grown for fleet supervision: the
        liveness bit plus the identity and progress counters a fleet
        health-checker routes and restarts on — replica id, uptime,
        device calls, and per-(geometry, width) compile counts (the
        per-replica single-compile guard reads these over HTTP)."""
        with self._cond:
            depth = len(self._queue)
            draining = self._draining
            served = self.served
            shed = self.shed
            degraded = self.cache_degraded
        reg = self.registry.stats()
        fe = self.frontend
        out = {
            "ok": True,
            "replica_id": self.replica_id,
            "uptime_s": round(time.time() - self.started_at, 3),
            "queue_depth": depth,
            # the autoscaler's load signals: depth is meaningless
            # without its bound, and tail latency names overload that
            # queue depth alone hides (slow device, big specs)
            "max_queue": self.max_queue,
            "request_p95_s": round(
                self.timers.percentile("request", 0.95), 6),
            "draining": draining,
            "served": served,
            "shed": shed,
            "cache_degraded": degraded,
            # sticky SDC verdict for the fleet's breaker/eject path: a
            # replica whose device ever disagreed with its own
            # re-execution is suspect hardware — route around it
            "sdc_suspect": (self.integrity.sdc_suspect
                            if self.integrity is not None else False),
            "device_calls": reg["device_calls"],
            "programs": reg["programs"],
            "compile_counts": reg["compile_counts"],
            # each kernel wrapper's launches in this process: a replica
            # is another process, so this is how a fleet's caller reads
            # the kernels its replicas ran
            "kernel_launches": kernel_launches(),
            # the pod group this replica leads (one process when solo):
            # the fleet's group supervision and the smoke's pod leg read it
            "pod": self._pod.describe(),
        }
        if fe is not None:
            # connection pressure for the fleet health poll and the
            # autoscaler's load_signal(): queue depth alone cannot see
            # ten thousand idle-but-open sockets
            fes = fe.stats()
            out["frontend"] = fes
            out["open_connections"] = int(
                fes.get("open_connections", 0))
        return out

    def metrics(self):
        """One JSON-ready dict: stage timers (with latency percentiles),
        queue depth, admission counters, per-bucket program hit counts,
        and cache stats — the ``/metrics`` payload."""
        with self._cond:
            depth = len(self._queue)
            out = {
                "replica_id": self.replica_id,
                "uptime_s": round(time.time() - self.started_at, 3),
                "queue_depth": depth,
                "max_queue": self.max_queue,
                "draining": self._draining,
                "served": self.served,
                "rejected": self.rejected,
                "expired": self.expired,
                "shed": self.shed,
                "cache_hits": self.cache_hits,
                "cache_put_errors": self.cache_put_errors,
                "cache_degraded": self.cache_degraded,
                "service_time_ewma_s": round(self._svc_ewma, 6),
                "retry_after_hint_s": round(
                    self._retry_hint(depth), 6),
                "scenario_requests": dict(self.scenario_requests),
            }
        out["stages"] = self.timers.snapshot()
        out["programs"] = self.registry.stats()
        if self.integrity is not None:
            out["integrity"] = self.integrity.stats()
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self.frontend is not None:
            out["frontend"] = self.frontend.stats()
        return out

    # -- the batcher -------------------------------------------------------

    def _take_batch(self):
        """Wait for work; hold the head request open for the coalescing
        window; return the same-geometry batch (up to the widest bucket)
        or None when draining with an empty queue."""
        max_w = self.registry.widths[-1]
        with self._cond:
            while not self._queue:
                if self._draining:
                    return None
                self._cond.wait(0.05)
            head = self._queue[0]
            gh = head.geom_hash
            while not self._draining:
                same = [r for r in self._queue if r.geom_hash == gh]
                if len(same) >= max_w:
                    break
                remaining = (head.t_submit + self.batch_window_s
                             - time.perf_counter())
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = [r for r in self._queue if r.geom_hash == gh][:max_w]
            for r in batch:
                self._queue.remove(r)
            return batch

    def _expire(self, batch):
        """Drop queued requests whose deadline passed — cleanly, before
        any device time is spent on them."""
        now = time.perf_counter()
        alive = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                r.status = "expired"
                r.error = "deadline exceeded before execution"
                with self._cond:
                    self.expired += 1
                self._finish(r)
            else:
                alive.append(r)
        return alive

    def _execute(self, batch):
        # shared-tier re-check: a peer replica over the same cache dir
        # (or a failover re-route of this very spec) may have committed
        # a batch member's artifact since submit time — serve those rows
        # from the cache and keep device work at-most-once per spec
        # fleet-wide.  get() refreshes from the journal tail on miss, so
        # no restart is needed to see peer commits.
        if self.cache is not None:
            alive = []
            for r in batch:
                arr = self.cache.get(r.id)
                if arr is None:
                    alive.append(r)
                    continue
                r.result = arr
                r.cached = True
                r.status = "done"
                self._finish(r)
                self.timers.add("request",
                                time.perf_counter() - r.t_submit)
                with self._cond:
                    self.cache_hits += 1
                    self.served += 1
            batch = alive
            if not batch:
                with self._cond:
                    self._evict_terminal()
                return

        gh = batch[0].geom_hash
        t0 = time.perf_counter()
        for r in batch:
            r.status = "running"
        if not self.registry.known(gh):
            cfg, profiles, noise_norm = build_geometry(batch[0].canonical)
            self.registry.register(gh, cfg, profiles, noise_norm,
                                   warmup=True,
                                   scenario=scenario_stack(
                                       batch[0].canonical),
                                   canonical=batch[0].canonical)
        _, _, noise_norm = self.registry.geometry(gh)
        stack = self.registry.scenario_of(gh)
        width = self.registry.bucket_width(len(batch))
        idx = [i % len(batch) for i in range(width)]  # pad: wrap rows
        keys = request_keys([r.canonical["seed"] for r in batch],
                            [r.id for r in batch])[idx]
        dms = np.asarray([batch[i].canonical["dm"] for i in idx],
                         np.float32)
        norms = np.asarray(
            [noise_norm * batch[i].canonical["noise_scale"] for i in idx],
            np.float32)
        nulls = np.asarray([batch[i].canonical["null_frac"] for i in idx],
                           np.float32)
        sc = None
        if stack is not None:
            sc = np.asarray(
                [scenario_param_vector(batch[i].canonical) for i in idx],
                np.float32)
        self.timers.add("batch", time.perf_counter() - t0)

        t0 = time.perf_counter()
        dig_row = None
        if self.integrity is None:
            out = self.registry.execute(gh, width, keys, dms, norms, nulls,
                                        sc=sc)
        else:
            out, dig_row = self._execute_checked(gh, width, keys, dms,
                                                 norms, nulls, sc, batch)
        compute_s = time.perf_counter() - t0
        self.timers.add("compute", compute_s)
        self._observe_service_time(compute_s / len(batch))
        if stack is not None:
            # attribute this batch's device time to each enabled effect
            # (overlapping by design — excluded from the bottleneck pick)
            for name in stack.names():
                self.timers.add(f"effect:{name}", compute_s)

        t0 = time.perf_counter()
        now = time.perf_counter()
        for i, r in enumerate(batch):
            arr = np.ascontiguousarray(out[i])
            meta = {"geom": gh[:12]}
            if dig_row is not None:
                # the device-attested claim rides the cache journal's
                # commit record (checked equal to these bytes above)
                meta["dig"] = int(dig_row[i])
            if self.cache is not None:
                try:
                    self.cache.put(r.id, arr, meta=meta)
                    with self._cond:
                        self.cache_degraded = False
                    self.timers.gauge("cache_degraded", 0)
                except OSError:
                    # cache tier full/broken (ENOSPC): degrade to
                    # pass-through — the request still completes with
                    # its computed bytes, only caching is lost.  Loud:
                    # counter + sticky gauge until a commit succeeds.
                    with self._cond:
                        self.cache_put_errors += 1
                        self.cache_degraded = True
                    self.timers.count("cache_put_error")
                    self.timers.gauge("cache_degraded", 1)
            r.result = arr
            r.status = "done"
            self._finish(r)
            self.timers.add("request", now - r.t_submit)
        with self._cond:
            self.served += len(batch)
            self._evict_terminal()
        self.timers.add("respond", time.perf_counter() - t0)

    def _execute_checked(self, gh, width, keys, dms, norms, nulls, sc,
                         batch):
        """Device execution under the integrity lattice + audit
        (:mod:`psrsigsim_torch.runtime.integrity`): the device output's
        per-row digest is computed ON DEVICE, the host copy is
        re-digested and compared before any row can reach the cache or
        a client, and a deterministic sample of batches (keyed by the
        head request's spec hash, so identical traffic audits
        identically) is duplicate-executed and compared
        claim-for-claim.  Disagreements heal through verified
        re-execution — same bucket, same keys, so healed bytes equal a
        clean batch's bit for bit (P7/P10); an unhealable disagreement
        raises :class:`~psrsigsim_torch.runtime.IntegrityError`, failing
        exactly
        this batch's requests with the evidence attached (the batcher's
        existing poisoned-batch path).  Returns ``(host_out,
        per_row_digests)``."""
        from ..runtime.integrity import device_digest_rows, digest_rows

        checker = self.integrity
        token = batch[0].id

        def _exec(audit=False):
            # every run re-executes the same staged bucket on the same
            # inputs (P7/P10), which is exactly the transient-SDC screen
            dev = checker.apply_sdc(
                self.registry.execute_device(gh, width, keys, dms, norms,
                                             nulls, sc=sc), token=token)
            return (lambda: dev.cpu().numpy(),
                    device_digest_rows(dev).cpu().numpy())

        fetch, dig_dev = _exec()
        out, dig, event = checker.verify_chunk(
            dig_dev, checker.corrupt_host(fetch(), token=token), digest_rows,
            _exec, producer="serve", ident=token,
            evidence={"geometry": gh[:12], "spec": token[:12]})
        if event is not None:
            self.timers.count("integrity_healed")
        return out, dig

    def _batch_loop(self):
        with self._on_device():
            self._serve_batches()

    def _serve_batches(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            batch = self._expire(batch)
            if not batch:
                continue
            try:
                self._execute(batch)
            except BaseException as err:  # noqa: BLE001 - batcher must live
                # a poisoned geometry/batch fails ITS requests, never the
                # engine: every later request would otherwise hang forever
                for r in batch:
                    if not r.done.is_set():
                        r.status = "error"
                        r.error = f"{type(err).__name__}: {err}"
                        self._finish(r)

    def _evict_terminal(self):
        """Bound the status table: oldest TERMINAL requests beyond
        ``max_done`` are dropped (their artifacts live on in the cache).
        Caller holds the lock."""
        terminal = [rid for rid, r in self._requests.items()
                    if r.done.is_set()]
        excess = len(terminal) - self.max_done
        for rid in terminal[:max(excess, 0)]:
            del self._requests[rid]


def kernel_launches():
    """Each kernel wrapper's launch count in this process."""
    from ..ops import digest, fold_quantize, rng_hw

    return {"rng_field": rng_hw.rng_field.launches,
            "rng_flat_field": rng_hw.rng_flat_field.launches,
            "fold_quantize": fold_quantize.fold_quantize.launches,
            "packed_digest": digest.packed_digest.launches}


def request_keys(seeds, rids):
    """The requests' PRNG keys, ``(n, 2)`` uint32 key data, in one batched
    evaluation on the host: ``stage_key(key(seed), "serve", h & 0x7FFFFFFF)``
    folded with ``(h >> 31) & 0x7FFFFFFF``, ``h`` the first 64 bits of the
    spec hash — the JAX package's ``_request_key``, bit for bit.  A key is
    a pure function of the canonical spec, which is the whole
    batching-invariance argument."""
    from ..utils.rng import fold_in, stage_key

    h64 = [int(rid[:16], 16) for rid in rids]
    roots = torch.zeros((len(h64), 2), dtype=torch.int64)
    roots[:, 1] = torch.tensor([int(s) & 0xFFFFFFFF for s in seeds],
                               dtype=torch.int64)
    lo = torch.tensor([h & 0x7FFFFFFF for h in h64], dtype=torch.int64)
    hi = torch.tensor([(h >> 31) & 0x7FFFFFFF for h in h64],
                      dtype=torch.int64)
    keys = fold_in(stage_key(roots, "serve", lo), hi)
    return keys.numpy().astype(np.uint32)
