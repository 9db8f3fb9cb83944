"""``scn.draws_ms``: host milliseconds an ``iter_chunks`` chunk spends
drawing its scenario factors (scintle gains, RFI levels and mask, pulse
energies) from its keys, from the program's ``dispatch.scenario`` span
over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.scenario", "dispatch")
