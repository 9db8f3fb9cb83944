"""``device.idle_fields.exact``: the share of the traced window in which no
kernel, copy or fill ran on the card while the host was inside
``dispatch.fields``, drawing a chunk's exact chi-square fields (the
alpha checks there read the card), from the span log the program keeps
while the trace runs.  None for a program that has no such span."""

from benchmark.spans import idle_share_under


def read(run):
    if not (run.record.get("timers") or {}).get("dispatch.fields_calls"):
        return None
    return idle_share_under(run, ("dispatch.fields",))
