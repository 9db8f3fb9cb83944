"""``stream.dispatch_ms``: host milliseconds an ``iter_chunks`` chunk takes
to dispatch (host keys, staging, launches), from the program's own
``StageTimers`` ``dispatch`` stage over the window."""


def read(run):
    t = run.record.get("timers") or {}
    calls = t.get("dispatch_calls", 0)
    if not calls:
        return None
    return 1e3 * t["dispatch_s"] / calls
