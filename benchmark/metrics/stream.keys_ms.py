"""``stream.keys_ms``: host milliseconds an ``iter_chunks`` chunk spends
deriving its keys on the host (the observation keys, the pulse and noise
stage keys, the kernel's seed words), from the program's ``dispatch.keys``
span over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.keys", "dispatch")
