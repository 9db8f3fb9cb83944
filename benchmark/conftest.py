"""The exact cell at a size a test holds, for the tests that run every
cell of ``BENCHMARK.json`` (``tests/test_benchmark_reference.py``): its
configuration and parameter overrides, and the timed path its broken runs
break, which is the stream's (``FoldEnsemble._quantized_packed``, whose
unfused body this cell takes)."""

from benchmark.tests import test_benchmark_reference as _reference

EXACT_CELL = "j1713-l64-exact.stream"
# 8 channels of 256 bins, 4 subints of 0.1 s (Nfold 20): one RNG block
EXACT_TINY = (dict(nchan=8, sample_rate_mhz=0.0512, tobs_s=0.4),
              dict(n_obs=24, chunk_size=8, warmup_chunks=1, check_obs=6,
                   check_every=1))

_reference.TINY.setdefault(EXACT_CELL, EXACT_TINY)

_patch = _reference._patch


def _patch_exact(monkeypatch, name, fault):
    _patch(monkeypatch, "j1713-l64.stream" if name == EXACT_CELL else name,
           fault)


_reference._patch = _patch_exact
