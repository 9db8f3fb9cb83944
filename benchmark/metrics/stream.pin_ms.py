"""``stream.pin_ms``: host milliseconds an ``iter_chunks`` chunk spends
allocating the pinned host buffers its copies land in, from the program's
``fetch.pin`` span over its ``fetch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "fetch.pin", "fetch")
