"""``msp.body_ms``: device milliseconds of a ``MultiPulsarFoldEnsemble.run``
call outside K1' (the hetero fold body's shifts, FFTs, products and
copies), from the traced window's device events."""


def read(run):
    if run.trace is None or not run.record.get("calls"):
        return None
    other = sum(d for n, _, d in run.trace.events
                if "rng_field_kernel" not in n)
    return other / 1e6 / run.record["calls"]
