"""``scn.energy_ms``: host milliseconds a chunk spends on the single-pulse
energy draws, from the program's ``dispatch.scenario.single_pulse`` span
over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.scenario.single_pulse", "dispatch")
