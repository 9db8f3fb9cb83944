"""``exact.body_ms``: device milliseconds of an ``iter_chunks`` chunk on
the exact branch outside K9 and the device-to-host copies (the blocked
keys, the envelope shift, the fold's products, the quantizer and the
packing), from the traced window's device events over the chunks that
reached the consumer."""


def read(run):
    if run.trace is None or not run.record.get("chunks"):
        return None
    if not run.trace.kernels("gamma_field"):
        return None
    other = sum(d for n, _, d in run.trace.events
                if "gamma_field" not in n and "DtoH" not in n)
    return other / 1e6 / run.record["chunks"]
