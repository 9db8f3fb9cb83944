"""``stream.fetch_ms``: host milliseconds an ``iter_chunks`` chunk's fetch
takes (queueing the copies on the copy stream into pinned memory, then
waiting for them), from the program's ``StageTimers`` ``fetch`` stage."""


def read(run):
    t = run.record.get("timers") or {}
    calls = t.get("fetch_calls", 0)
    if not calls:
        return None
    return 1e3 * t["fetch_s"] / calls
