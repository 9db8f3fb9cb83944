"""``mc.fetch_wait_ms``: host milliseconds a study chunk's fetch waits for
that chunk's own launches to finish on the card, from the program's
``fetch.wait`` span over its ``fetch`` calls; the rest of ``fetch`` is the
copies, which also wait for the chunk launched behind it."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "fetch.wait", "fetch")
