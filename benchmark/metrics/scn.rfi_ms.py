"""``scn.rfi_ms``: host milliseconds a chunk spends on the RFI draws (burst
and tone selections, their energies, the truth mask), from the program's
``dispatch.scenario.rfi`` span over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.scenario.rfi", "dispatch")
