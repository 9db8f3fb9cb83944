"""``scn.scint_ms``: host milliseconds a chunk spends on the scintillation
draws (scintle cells, their keys, the exponential gains), from the
program's ``dispatch.scenario.scintillation`` span over its ``dispatch``
calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.scenario.scintillation", "dispatch")
