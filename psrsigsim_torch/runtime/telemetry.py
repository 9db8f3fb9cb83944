"""Per-stage telemetry for the streaming export pipeline.

The bulk-export path is a four-stage pipeline — **dispatch** (host-side
program launch + input staging), **fetch** (device->host transfer, on a
dedicated thread), **encode** (host byte assembly: packer slices, SUBINT
record refills, shared-memory copies) and **write** (writev/rename, or
the parent's wait on the writer pool) — with bounded queues between the
stages.  When throughput disappoints, the question is always "which
stage is the bottleneck on THIS host?", and the answer used to require
reverse-engineering bench JSON by hand.

:class:`StageTimers` is the shared accumulator every stage reports into:
monotonic per-stage busy time, call counts, fetched bytes, and bounded-
queue depth samples.  The exporter folds a snapshot into the export
manifest (``pipeline`` key) and ``chip_smoke.py``'s export phase prints
it, so every run names its own bottleneck.  (A copy of
psrsigsim_tpu/runtime/telemetry.py; the live-buffer gauge sums the
``nbytes`` of tensors and arrays instead of jax pytree leaves, the
percentiles are exact and stages nest: psrsigsim_torch/DIVERGENCES.md
P28.)

Spans: ``with timers.span("dispatch", chunk=start):`` times one stage on
the calling thread, and deep code opens a child of whatever span is open
on its thread with the module-level :func:`span` —
``with span("keys"):`` records ``dispatch.keys`` — without a timers
argument threaded through to it; with no span open it does nothing.  A
child's time is also inside its parent's.  Deep code counts events the
same way: :func:`count` bumps a counter of the timers that own the
thread's innermost open span.  While a PyTorch profiler is
active every closed span is also logged with its start and end on
``time.perf_counter_ns`` (the clock a device trace is anchored to), so a
trace's idle gaps can be put down to the host work inside them.

Thread-safety: ``add``/``depth`` are called from the fetch thread and
the main thread concurrently; all mutation is under one lock.  The
object is deliberately NOT picklable state for spawn workers — worker-
side costs surface as the parent's ``write`` wait, which is the number
the pipeline actually pays.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from collections import deque

__all__ = ["StageTimers", "STAGES", "SAMPLES_KEPT", "SPAN_LOG_MAX", "span",
           "count"]

STAGES = ("dispatch", "fetch", "encode", "write")

#: the latest samples of each stage that its percentiles are taken over
SAMPLES_KEPT = 4096
#: the most closed spans the log keeps while a profiler runs (oldest
#: dropped first, counted in ``spans_dropped``)
SPAN_LOG_MAX = 16384

#: the percentiles a snapshot reports for each stage
_PCTS = {"p50": 0.50, "p95": 0.95, "p99": 0.99}

_local = threading.local()   # .stack: the thread's open spans, innermost last


def _profiling():
    """Whether a PyTorch profiler is active (read without importing
    torch: a process that never loaded the profiler is not profiling)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _nearest_rank(ordered, q):
    """The nearest-rank ``q`` quantile (0..1) of a sorted sequence:
    ``numpy.percentile(..., method="inverted_cdf")``; 0.0 when empty."""
    n = len(ordered)
    if not n:
        return 0.0
    return ordered[min(max(math.ceil(q * n) - 1, 0), n - 1)]


class _NoSpan:
    """The span of a thread with no span open: nothing is timed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One open span (see :meth:`StageTimers.span`): ``nbytes`` may be set
    inside it and is reported with its time."""

    __slots__ = ("timers", "stage", "parent", "chunk", "nbytes", "t0")

    def __init__(self, timers, stage, parent, chunk):
        self.timers = timers
        self.stage = stage
        self.parent = parent
        self.chunk = chunk
        self.nbytes = 0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        self.timers._close(self, t1)
        return False


def span(name):
    """A child of the innermost span open on this thread, recorded as
    ``<parent>.<name>`` in that span's timers with its chunk; with no span
    open, a context that does nothing (one thread-local lookup)."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return _NO_SPAN
    p = stack[-1]
    return _Span(p.timers, f"{p.stage}.{name}", p.stage, p.chunk)


def count(name, n=1):
    """Bump counter ``name`` by ``n`` in the timers that own the innermost
    span open on this thread (``<name>_count`` in their snapshots); with
    no span open, nothing (one thread-local lookup)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].timers.count(name, n)


def _nbytes(tree):
    """Payload bytes of a tensor or array, or of a (nested) tuple/list of
    them (``Tensor.nbytes`` and ``ndarray.nbytes`` alike)."""
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(a) for a in tree)
    return int(tree.nbytes)


class StageTimers:
    """Monotonic per-stage busy-time accumulator for one export run.

    ``extra_stages`` declares additional stage names beyond the export
    pipeline's canonical four — the Monte-Carlo study engine reports its
    host-side accumulator merge as ``"reduce"`` — so a consumer with a
    different pipeline shape reuses the same accumulator, snapshot
    format, and bottleneck logic instead of growing a parallel one.

    ``latency_stages`` names stages that record END-TO-END latency
    rather than exclusive busy time (the serving engine's ``"request"``
    stage spans queue wait + batch window + compute, once per request):
    they get the same percentiles but are excluded from the
    ``bottleneck`` pick, which compares exclusive busy totals — an e2e
    stage double-counts every other stage and would always win.  Child
    stages (``<parent>.<child>``, see :func:`span`) are left out of it
    for the same reason: their time is inside their parent's.
    """

    def __init__(self, extra_stages=(), latency_stages=()):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._stages = tuple(STAGES) + tuple(
            s for s in extra_stages if s not in STAGES)
        self._latency_stages = frozenset(latency_stages)
        self._seconds = {k: 0.0 for k in self._stages}
        self._calls = {k: 0 for k in self._stages}
        self._samples = {k: deque(maxlen=SAMPLES_KEPT) for k in self._stages}
        self._stage_bytes = {}  # stage -> payload bytes reported to it
        self._depths = {}  # queue name -> [sum, samples, max]
        self._counters = {}  # name -> int (program builds, cache events...)
        self._gauges = {}  # name -> last-set value (degraded flags, levels)
        self._live_bytes = 0  # dispatched-but-unfetched device bytes
        # closed spans while a profiler runs: [stage, t0_ns, t1_ns,
        # parent stage, chunk]
        self._span_log = deque(maxlen=SPAN_LOG_MAX)
        self._spans_dropped = 0

    def add(self, stage, seconds, nbytes=0):
        """Accumulate ``seconds`` of busy time against ``stage`` (one of
        :data:`STAGES` or a declared extra stage; an undeclared name is
        registered on first use so a shared timer object never throws
        from a reporting thread); ``nbytes`` counts the stage's payload
        bytes — device->host transfers for ``fetch``, committed record
        bytes for the dataset factory's ``write``, ... — accumulated
        per stage (``<stage>_bytes`` in snapshots).  Each call also
        keeps one sample among the stage's latest :data:`SAMPLES_KEPT`,
        over which :meth:`snapshot` reports p50/p95/p99."""
        with self._lock:
            if stage not in self._seconds:
                self._stages = self._stages + (stage,)
                self._seconds[stage] = 0.0
                self._calls[stage] = 0
                self._samples[stage] = deque(maxlen=SAMPLES_KEPT)
            self._seconds[stage] += float(seconds)
            self._calls[stage] += 1
            self._samples[stage].append(float(seconds))
            if nbytes:
                self._stage_bytes[stage] = (
                    self._stage_bytes.get(stage, 0) + int(nbytes))

    def span(self, stage, chunk=None):
        """A context that times ``stage`` on the calling thread and closes
        through :meth:`add` (``nbytes`` set on the span is reported with
        it).  ``chunk`` (a chunk's start index) tags the span and every
        child that :func:`span` opens inside it.  A dotted ``stage`` is a
        child of the part before its last dot."""
        return _Span(self, stage, stage.rpartition(".")[0] or None, chunk)

    def _close(self, sp, t1):
        self.add(sp.stage, (t1 - sp.t0) / 1e9, sp.nbytes)
        if _profiling():
            entry = [sp.stage, sp.t0, t1, sp.parent,
                     None if sp.chunk is None else int(sp.chunk)]
            with self._lock:
                log = self._span_log
                if len(log) == log.maxlen:
                    self._spans_dropped += 1
                log.append(entry)

    def percentile(self, stage, q):
        """Latency percentile ``q`` (0..1) for ``stage``, exact (nearest
        rank) over its latest :data:`SAMPLES_KEPT` samples; 0.0 when the
        stage never reported."""
        with self._lock:
            samples = sorted(self._samples.get(stage, ()))
        return _nearest_rank(samples, q)

    def count(self, name, n=1):
        """Bump a named event counter (e.g. ``program_builds`` from the
        shared program registry): counters ride every snapshot as
        ``<name>_count``, so manifests and bench JSON record how many
        compiles/builds a run actually paid — the compile-count
        telemetry of the shared registry)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counter(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    def track_live(self, tree):
        """Add a just-dispatched chunk's device bytes (a tensor, or a
        tuple/list of them) to the ``live_buffer_bytes`` gauge — the
        measure of dispatched-but-unfetched device memory, shared by every
        chunked producer so the accounting lives in ONE place;
        :meth:`untrack_live` subtracts the same chunk on fetch."""
        self._bump_live(tree, +1)

    def untrack_live(self, tree):
        """Subtract a fetched chunk's device bytes from the
        ``live_buffer_bytes`` gauge (clamped at zero: a producer that
        fetches a chunk it never tracked must not drive the gauge
        negative)."""
        self._bump_live(tree, -1)

    def _bump_live(self, tree, sign):
        n = _nbytes(tree)
        with self._lock:
            self._live_bytes = max(0, self._live_bytes + sign * n)
            self._gauges["live_buffer_bytes"] = self._live_bytes

    def gauge(self, name, value):
        """Set a named point-in-time gauge (e.g. ``cache_degraded`` while
        the serving cache tier is in ENOSPC pass-through, or a fleet's
        ``active_replicas``): unlike counters these carry the CURRENT
        value, not an accumulation, and ride snapshots as
        ``<name>_gauge`` so /metrics and bench JSON see state, not just
        history."""
        with self._lock:
            self._gauges[name] = value

    def set_gauges(self, values):
        """Set several gauges under ONE lock acquisition — the serving
        front end's periodic tick (open connections, event-loop lag,
        pending write bytes) exports its gauges in a batch so a
        hot event loop pays one lock round-trip per tick, not one per
        gauge."""
        with self._lock:
            self._gauges.update(values)

    def gauge_value(self, name, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def depth(self, name, value):
        """Record one bounded-queue depth sample (e.g. the fetched-chunk
        queue right before the consumer pops it: 0 means the consumer
        starved, full means the consumer is the bottleneck)."""
        with self._lock:
            rec = self._depths.setdefault(name, [0, 0, 0])
            rec[0] += int(value)
            rec[1] += 1
            rec[2] = max(rec[2], int(value))

    def snapshot(self):
        """One JSON-ready dict: per-stage seconds/counts, fetched bytes,
        queue-depth stats, wall time, and the named bottleneck stage (the
        stage with the most accumulated busy time — in an ideally
        overlapped pipeline its time approaches the wall time and every
        other stage hides under it).  Spans logged while a profiler ran
        ride it as ``spans`` (oldest first) with ``spans_dropped``; with
        none logged neither key is there."""
        samples = {}
        with self._lock:
            out = {}
            for k in self._stages:
                out[f"{k}_s"] = round(self._seconds[k], 6)
                out[f"{k}_calls"] = self._calls[k]
                if self._calls[k]:
                    # per-call latency percentiles over the latest samples
                    # (/metrics and bench JSON report p50/p95/p99 per
                    # stage), sorted once the lock is released
                    samples[k] = list(self._samples[k])
                    for tag in _PCTS:
                        out[f"{k}_{tag}_s"] = None
            for name, n in sorted(self._stage_bytes.items()):
                out[f"{name}_bytes"] = n
            out["wall_s"] = round(time.perf_counter() - self._t0, 6)
            for name, n in sorted(self._counters.items()):
                out[f"{name}_count"] = n
            for name, v in sorted(self._gauges.items()):
                out[f"{name}_gauge"] = v
            for name, (tot, n, mx) in sorted(self._depths.items()):
                out[f"{name}_depth_max"] = mx
                out[f"{name}_depth_mean"] = round(tot / max(n, 1), 3)
            if self._span_log:
                out["spans"] = [list(e) for e in self._span_log]
                out["spans_dropped"] = self._spans_dropped
            busy = [k for k in self._stages
                    if k not in self._latency_stages and "." not in k] \
                or list(self._stages)
            out["bottleneck"] = max(busy, key=lambda k: self._seconds[k])
        for k, vals in samples.items():
            vals.sort()
            for tag, q in _PCTS.items():
                out[f"{k}_{tag}_s"] = round(_nearest_rank(vals, q), 6)
        return out
