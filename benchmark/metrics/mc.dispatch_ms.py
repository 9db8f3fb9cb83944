"""``mc.dispatch_ms``: host milliseconds a study chunk takes to dispatch
(its trial keys and prior draws on the host, then the launches), from the
study's ``StageTimers`` ``dispatch`` stage over the window."""


def read(run):
    t = run.record.get("timers") or {}
    calls = t.get("dispatch_calls", 0)
    if not calls:
        return None
    return 1e3 * t["dispatch_s"] / calls
