"""The scenario cell at a size a test holds, for the tests that run every
cell of ``BENCHMARK.json`` (``test_benchmark_reference.py``): its
configuration and parameter overrides, and the timed path its broken runs
break, which is the stream's (``FoldEnsemble._quantized_packed``)."""

from benchmark.tests import test_benchmark_reference as _reference

SCENARIO_CELL = "j1713-l64-scn.stream"

_reference.TINY.setdefault(SCENARIO_CELL, (
    dict(nchan=8, sample_rate_mhz=0.0512, tobs_s=120.0),
    dict(n_obs=40, chunk_size=16, warmup_chunks=1, check_obs=6,
         check_every=1)))

_patch = _reference._patch


def _patch_scenario(monkeypatch, name, fault):
    _patch(monkeypatch, "j1713-l64.stream" if name == SCENARIO_CELL
           else name, fault)


_reference._patch = _patch_scenario
