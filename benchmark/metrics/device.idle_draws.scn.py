"""``device.idle_draws.scn``: the share of the traced window in which no
kernel, copy or fill ran on the card while the host was inside
``dispatch.scenario``, drawing a chunk's scenario factors, from the span
log the program keeps while the trace runs (the scenario cell).  None for
a program that has no such span."""

from benchmark.spans import idle_share_under


def read(run):
    if not (run.record.get("timers") or {}).get("dispatch.scenario_calls"):
        return None
    return idle_share_under(run, ("dispatch.scenario",))
