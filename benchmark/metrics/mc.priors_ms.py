"""``mc.priors_ms``: host milliseconds a study chunk spends drawing its
trials' parameters from the priors on the host, from the program's
``dispatch.priors`` span over its ``dispatch`` calls."""

from benchmark.spans import child_ms


def read(run):
    return child_ms(run, "dispatch.priors", "dispatch")
