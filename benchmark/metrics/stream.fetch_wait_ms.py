"""``stream.fetch_wait_ms``: host milliseconds an ``iter_chunks`` chunk's
fetch waits for its device-to-host copies to land in the pinned buffers,
from the program's ``fetch.wait`` span over its ``fetch`` calls; set
against ``stream.dispatch_ms`` it says whether the link or the host's
dispatch sets the stream's pace."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "fetch.wait", "fetch")
