"""``exact.fields_ms``: host milliseconds an ``iter_chunks`` chunk spends
in its exact chi-square fields (the blocked keys, the alpha checks that
read the card, K9's launches), from the program's ``dispatch.fields``
span over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.fields", "dispatch")
