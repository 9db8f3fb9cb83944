"""``mc.keys_ms``: host milliseconds a study chunk spends deriving its trial
keys and the pulse and noise stage keys on the host, from the program's
``dispatch.keys`` span over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.keys", "dispatch")
