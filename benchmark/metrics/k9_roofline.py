"""``k9_roofline``: K9 (``ops.gamma``, the exact branch's gamma draws) as a
share of its bound, from the kernel's device time in the traced window:
the bound of one launch, one chunk's pulse or noise field
(rooflines_gamma.k9_chunk), over its mean time per launch.  Every launch
is a full chunk's: ``iter_chunks`` runs an ensemble's last chunk at the
full width too (its indices wrap and the tail is trimmed on the host)."""

from benchmark.rooflines_gamma import k9_chunk


def read(run):
    if run.trace is None or "nfold" not in run.record:
        return None
    times = run.trace.kernels("gamma_field")
    if not times:
        return None
    nchan, nsub, nph = run.record["geometry"]
    bound, _ = k9_chunk(run.record["chunk_obs"], nchan, nsub * nph,
                        run.record["nfold"])
    return 100.0 * bound * len(times) / sum(times)
