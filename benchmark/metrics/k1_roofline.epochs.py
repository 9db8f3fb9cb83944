"""``k1_roofline.epochs``: K1' (``ops.rng_hw``, ``chi2_sel`` rows) in the
multi-pulsar ensemble as a share of its bound: the bound of a call's
launches (each bucket's and epoch chunk's two fields, from the output's
shape) over the kernel's device time per call in the traced window."""

from benchmark.rooflines import k1_field


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernels("rng_field_kernel")
    launches = run.record.get("k1_launches_per_call") or []
    if not times or not launches:
        return None
    bound = sum(k1_field(*shape)[0] for shape in launches)
    return 100.0 * bound * (len(times) / len(launches)) / sum(times)
