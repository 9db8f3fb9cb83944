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
``nbytes`` of tensors and arrays instead of jax pytree leaves.)

Thread-safety: ``add``/``depth`` are called from the fetch thread and
the main thread concurrently; all mutation is under one lock.  The
object is deliberately NOT picklable state for spawn workers — worker-
side costs surface as the parent's ``write`` wait, which is the number
the pipeline actually pays.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = ["StageTimers", "STAGES", "LATENCY_LOG10_LO", "LATENCY_LOG10_HI",
           "LATENCY_NBINS", "latency_bin_index", "latency_bin_edges"]

STAGES = ("dispatch", "fetch", "encode", "write")

# Bounded per-stage latency histogram: fixed equal bins over
# log10(seconds) in [LATENCY_LOG10_LO, LATENCY_LOG10_HI), out-of-range
# samples clamped into the edge bins — the host-side mirror of
# ``ops/stats.fixed_histogram`` semantics (equal bins, clamp-not-drop),
# applied to log-latency so microsecond encode calls and multi-second
# device dispatches share one fixed-size table.  10 bins per decade from
# 1 us to 100 s: memory is ``nbins`` ints per stage, forever bounded.
LATENCY_LOG10_LO = -6.0
LATENCY_LOG10_HI = 2.0
LATENCY_NBINS = 80


def latency_bin_index(seconds):
    """The histogram bin a latency sample lands in (clamped into the edge
    bins exactly like ``fixed_histogram`` clamps its tails)."""
    s = max(float(seconds), 1e-30)
    span = LATENCY_LOG10_HI - LATENCY_LOG10_LO
    idx = int(math.floor(
        (math.log10(s) - LATENCY_LOG10_LO) / span * LATENCY_NBINS))
    return min(max(idx, 0), LATENCY_NBINS - 1)


def latency_bin_edges():
    """Bin UPPER edges in SECONDS (len ``LATENCY_NBINS``): bin ``i``
    spans ``[edges[i-1], edges[i])`` (lower edge of bin 0 is
    ``10**LATENCY_LOG10_LO``), with out-of-range samples clamped into
    bins 0 and ``LATENCY_NBINS - 1``."""
    span = LATENCY_LOG10_HI - LATENCY_LOG10_LO
    return [10.0 ** (LATENCY_LOG10_LO + (i + 1) * span / LATENCY_NBINS)
            for i in range(LATENCY_NBINS)]


def _hist_percentile(counts, q):
    """Percentile estimate from the fixed-bin histogram: the UPPER edge
    (in seconds) of the bin where the cumulative count crosses ``q`` —
    conservative (never under-reports) and exact to one bin width
    (~26% in time, 10 bins/decade)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    edges = latency_bin_edges()
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return edges[i]
    return edges[-1]


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
    they get the same histograms/percentiles but are excluded from the
    ``bottleneck`` pick, which compares exclusive busy totals — an e2e
    stage double-counts every other stage and would always win.
    """

    def __init__(self, extra_stages=(), latency_stages=()):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._stages = tuple(STAGES) + tuple(
            s for s in extra_stages if s not in STAGES)
        self._latency_stages = frozenset(latency_stages)
        self._seconds = {k: 0.0 for k in self._stages}
        self._calls = {k: 0 for k in self._stages}
        self._hist = {k: [0] * LATENCY_NBINS for k in self._stages}
        self._bytes_fetched = 0
        self._stage_bytes = {}  # stage -> payload bytes reported to it
        self._depths = {}  # queue name -> [sum, samples, max]
        self._counters = {}  # name -> int (program builds, cache events...)
        self._gauges = {}  # name -> last-set value (degraded flags, levels)
        self._live_bytes = 0  # dispatched-but-unfetched device bytes

    def add(self, stage, seconds, nbytes=0):
        """Accumulate ``seconds`` of busy time against ``stage`` (one of
        :data:`STAGES` or a declared extra stage; an undeclared name is
        registered on first use so a shared timer object never throws
        from a reporting thread); ``nbytes`` counts the stage's payload
        bytes — device->host transfers for ``fetch``, committed record
        bytes for the dataset factory's ``write``, ... — accumulated
        per stage (``<stage>_bytes`` in snapshots; the legacy
        ``bytes_fetched`` total keeps summing every report, which
        matches its historical value because only ``fetch`` reported
        bytes before per-stage accounting existed).  Each call also
        lands one sample in the stage's bounded latency histogram, from
        which :meth:`snapshot` reports p50/p95/p99."""
        with self._lock:
            if stage not in self._seconds:
                self._stages = self._stages + (stage,)
                self._seconds[stage] = 0.0
                self._calls[stage] = 0
                self._hist[stage] = [0] * LATENCY_NBINS
            self._seconds[stage] += float(seconds)
            self._calls[stage] += 1
            self._hist[stage][latency_bin_index(seconds)] += 1
            if nbytes:
                self._stage_bytes[stage] = (
                    self._stage_bytes.get(stage, 0) + int(nbytes))
                if stage == "fetch":
                    self._bytes_fetched += int(nbytes)

    def histogram(self, stage):
        """A copy of one stage's latency-histogram counts (len
        :data:`LATENCY_NBINS`; bin semantics in :func:`latency_bin_index`)."""
        with self._lock:
            return list(self._hist.get(stage, [0] * LATENCY_NBINS))

    def percentile(self, stage, q):
        """Latency percentile ``q`` (0..1) for ``stage``, estimated from
        the bounded histogram (conservative: the crossing bin's upper
        edge; 0.0 when the stage never reported)."""
        with self._lock:
            return _hist_percentile(self._hist.get(stage, ()), q)

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
        other stage hides under it)."""
        with self._lock:
            out = {}
            for k in self._stages:
                out[f"{k}_s"] = round(self._seconds[k], 6)
                out[f"{k}_calls"] = self._calls[k]
                if self._calls[k]:
                    # per-call latency percentiles from the bounded
                    # histogram (/metrics and bench JSON report
                    # p50/p95/p99 per stage)
                    for tag, q in (("p50", 0.50), ("p95", 0.95),
                                   ("p99", 0.99)):
                        out[f"{k}_{tag}_s"] = round(
                            _hist_percentile(self._hist[k], q), 6)
            out["bytes_fetched"] = self._bytes_fetched
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
            busy = [k for k in self._stages
                    if k not in self._latency_stages] or list(self._stages)
            out["bottleneck"] = max(busy, key=lambda k: self._seconds[k])
            return out
