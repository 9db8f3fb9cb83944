"""What the per-layer readers take from the program's own spans
(``StageTimers`` in ``psrsigsim_torch/runtime/telemetry.py``): a child
stage's milliseconds a chunk, and the device's idle time while the host was
inside given spans, from the span log the program keeps while a device
trace runs.  A program without such spans gives None, never an error."""

from benchmark.harness import _merge


def child_ms(run, child, parent):
    """Milliseconds of stage ``child`` a call of ``parent`` (``child``'s
    seconds over ``parent``'s calls) from the record's timers; None when
    either is missing."""
    t = run.record.get("timers") or {}
    calls = t.get(f"{parent}_calls", 0)
    if not calls or f"{child}_s" not in t:
        return None
    return 1e3 * t[f"{child}_s"] / calls


def logged_spans(run, stages):
    """``[[t0, t1]]``, merged, on the device trace's clock: the logged
    spans of ``stages``, shifted by the trace's offset as the harness
    shifts its own spans and clipped to the traced window; None without a
    trace or a log, or when the log dropped spans."""
    trace = run.trace
    t = run.record.get("timers") or {}
    if trace is None or not run.window_s or "spans" not in t \
            or t.get("spans_dropped", 0):
        return None
    lo = int(trace.t0 * 1e9)
    hi = lo + int(run.window_s * 1e9)
    off = trace.offset_ns
    return _merge([(max(a, lo) + off, min(b, hi) + off)
                   for stage, a, b, _, _ in t["spans"]
                   if stage in stages and min(b, hi) > max(a, lo)])


def idle_ns(spans, busy):
    """Nanoseconds of ``spans`` that no interval of ``busy`` covers (both
    sorted lists of disjoint ``[t0, t1]``)."""
    total, j = 0, 0
    for a, b in spans:
        free = b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            free -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        total += free
    return total


def idle_share_under(run, stages):
    """The share (%) of the traced window in which no device operation ran
    while the host was inside a span of ``stages``; None where
    :func:`logged_spans` finds nothing to read."""
    spans = logged_spans(run, stages)
    if spans is None:
        return None
    busy = _merge([(s, s + d) for _, s, d in run.trace.events])
    return 100.0 * idle_ns(spans, busy) / (run.window_s * 1e9)
