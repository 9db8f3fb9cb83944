"""``device.idle_keys.trials``: the share of the traced window in which no
kernel, copy or fill ran on the card while the study's host thread was
inside ``dispatch.keys`` or ``dispatch.priors``, from the span log the
program keeps while the trace runs (the trials cell)."""

from benchmark.spans import idle_share_under


def read(run):
    return idle_share_under(run, ("dispatch.keys", "dispatch.priors"))
