"""``device.idle.epochs``: the share of the traced window in which no kernel,
copy or fill ran on the card (the multi-pulsar cell)."""


def read(run):
    if not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
