"""``k3_roofline``: K3' (``ops.fold_quantize``) as a share of its bound,
from the kernel's device time in the traced window: the bound of one
chunk's work (rooflines.k3_fold_quantize) over its mean time per launch."""

from benchmark.rooflines import k3_fold_quantize


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernels("fold_quantize")
    if not times:
        return None
    nchan, nsub, nph = run.record["geometry"]
    bound, _ = k3_fold_quantize(run.record["chunk_obs"], nchan, nsub, nph)
    return 100.0 * bound * len(times) / sum(times)
