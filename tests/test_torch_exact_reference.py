"""The port's exact chi-square branch against the benchmark's plain gamma
reference (``benchmark/reference/gamma.py``), on the CPU at a small
geometry: BASELINE config 1's J1713+0747 in 0.1 s subints (Nfold 20, both
fields drawn as ``2 * gamma(key, 10)``) cut to 16 channels, 4 subints and
256 bins.

* the exact-gamma kernel's plain version (``gamma_field`` on CPU tensors)
  against the reference, row for row;
* a quantized ``FoldEnsemble.iter_chunks`` against the reference's
  observations, through the exact cell's own comparison: codes, DAT_SCL
  and DAT_OFFS within the cell's limits;
* the two controls of the cell, not correct: the reference in bfloat16 in
  the program's place, and the program with the exact branch left out
  (Wilson-Hilferty at df 20);
* the branch's spans and counters: ``dispatch.fields`` and
  ``dispatch.quantize`` under ``dispatch``, ``gamma.rows`` and
  ``gamma.draws``, ``gamma.host_alpha`` once a launch and no
  ``gamma.host_checks`` (α is a host number), a full chunk's rows in an
  ensemble's tail chunk, none of them on the fused route or off the
  branch, and the same bytes with and without timers;
* on the card (``cuda``-marked): the same counters, and the branch's
  ``run_quantized`` clean under sync-debug "error"."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, objects  # noqa: E402
from benchmark.drivers import exact  # noqa: E402
from benchmark.reference import fold as RF  # noqa: E402
from benchmark.reference import gamma as RG  # noqa: E402
from benchmark.reference import keys as RK  # noqa: E402
from benchmark.reference import observations as RO  # noqa: E402

SEED = 2**31 - 911
N_OBS = 3
# A draw of the program and the reference's: the normal's erfinv differs
# by tens of float32 ulps (XLA's polynomial against torch's), which the
# draw d * (1 + c x)^3 carries at a third of its size (1.2e-5 at most over
# 21 million draws at alpha 10)
DRAW_RTOL = 5e-5
# Codes: a draw within its rounding of a code boundary rounds the other
# way, and the reference's float64 shift of the portrait against the
# program's float32 one: one LSB, two for a sample both touch
CODE_LSB = 2


@pytest.fixture(scope="module")
def config():
    with open(ROOT / "benchmark" / "configs" / "j1713-l64-exact.json") as f:
        c = json.load(f)
    return dict(c, nchan=16, sample_rate_mhz=0.0512, tobs_s=0.4)


def _keys(seed, rows):
    return RK.fold_in(RK.key(seed)[None, :].expand(rows, 2),
                      torch.arange(rows))


@pytest.mark.parametrize("alpha", [1.5, 10.0, 24.5])
def test_gamma_rows_match_the_reference(alpha):
    """Row for row: every draw within ``DRAW_RTOL`` of the reference's, or
    of the other outcome the reference gives where a decision lies within
    rounding of its threshold."""
    from psrsigsim_torch.ops.gamma import gamma_field

    keys = _keys(SEED + int(alpha * 2), 16)
    a = torch.full((16,), alpha, dtype=torch.float32)
    got = gamma_field(keys, a, 4096, scale=2.0).reshape(-1)
    ref = RG.gamma_rows(keys, alpha, 4096)
    want = ref.values.reshape(-1)
    close = (got - want).abs() <= DRAW_RTOL * want
    other = torch.zeros_like(close)
    other[ref.alt_at] = (got[ref.alt_at] - ref.alt).abs() <= DRAW_RTOL * ref.alt
    assert bool((close | other).all()), int((~(close | other)).sum())
    # a flip is rare: a few in a million draws
    assert int((other & ~close).sum()) <= 2


def _run(config, timers=None, n_obs=N_OBS, seed=SEED, chunk_size=None):
    ens = objects.fold_ensemble(config, "cpu")
    out = []
    for start, (data, scl, offs) in ens.iter_chunks(
            n_obs, chunk_size=chunk_size or n_obs, seed=seed, quantized=True,
            byte_order="big", timers=timers):
        for i in range(data.shape[0]):
            out.append((seed, start + i, data[i].view(">i2").astype(np.int16),
                        scl[i].copy(), offs[i].copy()))
    return ens, out


def _compare(config, got):
    cell = exact.Cell(config, {}, harness.Context("cpu", 0))
    geom = RO.single_pulsar(config, objects.profile_data(config))
    return {n: (v, lim) for n, v, lim in cell.compare(geom, got)}


def test_iter_chunks_matches_the_reference(config):
    ens, got = _run(config)
    assert ens.cfg.nfold == pytest.approx(20.0)
    checks = _compare(config, got)
    assert set(checks) == set(exact.LIMITS)
    assert all(v <= lim for v, lim in checks.values()), checks
    assert checks["code_max_diff"][0] <= CODE_LSB


def test_the_bfloat16_control_is_not_correct(config):
    geom = RO.single_pulsar(config, objects.profile_data(config))
    got = []
    for i in range(N_OBS):
        k = RK.stage_key(RK.key(SEED), "user", i)
        x = RG.observation(geom, k, "cpu", torch.bfloat16).x
        got.append((SEED, i) + tuple(t.numpy() for t in RF.quantize(
            x, geom.nsub, geom.nph)))
    checks = _compare(config, got)
    assert any(v > lim for v, lim in checks.values()), checks


def test_wilson_hilferty_in_place_of_the_branch_is_not_correct(
        config, monkeypatch):
    """The program with the exact branch left out draws Wilson-Hilferty
    from the same blocked keys at df 20: not correct."""
    from psrsigsim_torch.ops import stats

    monkeypatch.setattr(stats, "_gamma_routed", lambda df: False)
    _, got = _run(config)
    checks = _compare(config, got)
    assert any(v > lim for v, lim in checks.values()), checks


def test_the_branch_counts_its_rows_and_nests_its_spans(config):
    from psrsigsim_torch.runtime import StageTimers

    timers = StageTimers()
    ens, got = _run(config, timers, n_obs=2)
    snap = timers.snapshot()
    blocks = -(-ens.cfg.nsub * ens.cfg.nph // 4096)
    rows = 2 * 2 * config["nchan"] * blocks
    assert snap["gamma.rows_count"] == rows
    assert snap["gamma.draws_count"] == rows * 4096
    # alpha a host number: checked, and its constants computed, on the
    # host once a launch; no check reads a card
    assert snap["gamma.host_alpha_count"] == 2 * snap["dispatch_calls"]
    assert "gamma.host_checks_count" not in snap
    assert snap["dispatch.fields_calls"] == 2 * snap["dispatch_calls"] == 2
    assert snap["dispatch.quantize_calls"] == snap["dispatch_calls"]
    for child in ("dispatch.fields", "dispatch.quantize"):
        assert 0 < snap[f"{child}_s"] <= snap["dispatch_s"]
    assert snap["bottleneck"] in ("dispatch", "fetch")
    # no timers, the same bytes
    _, plain = _run(config, None, n_obs=2)
    for a, b in zip(got, plain):
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)


def _card_ensemble(config):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return objects.fold_ensemble(config, "cuda")


@pytest.mark.cuda
def test_the_branch_reads_no_alpha_back_on_the_card(config):
    """On the card, as on the host: every K9 launch's alpha is checked on
    the host (two a chunk), none reads the card."""
    from psrsigsim_torch.ops.gamma import gamma_field
    from psrsigsim_torch.runtime import StageTimers

    ens = _card_ensemble(config)
    timers = StageTimers()
    before = gamma_field.launches
    for _ in ens.iter_chunks(4, chunk_size=2, seed=SEED, quantized=True,
                             byte_order="big", timers=timers):
        pass
    snap = timers.snapshot()
    assert snap["dispatch_calls"] == 2
    assert gamma_field.launches - before == 2 * snap["dispatch_calls"]
    assert snap["gamma.host_alpha_count"] == 2 * snap["dispatch_calls"]
    assert "gamma.host_checks_count" not in snap


@pytest.mark.cuda
def test_the_branch_runs_without_a_sync_on_the_card(config):
    """The exact branch's steady ``run_quantized`` at Nfold 20 runs under
    sync-debug "error": no host read stands between its launches."""
    from psrsigsim_torch.analysis.trace_check import run_ensemble_trace_check

    ens = _card_ensemble(config)
    assert ens.cfg.nfold == pytest.approx(20.0)
    (res,) = run_ensemble_trace_check(ens, 2)
    assert res.status == "ok"


def test_a_tail_chunk_draws_a_full_chunk(config):
    """The last chunk of an ensemble that is no multiple of the chunk size
    still draws ``chunk_size`` observations' rows (its indices wrap and
    the tail is trimmed), so every K9 launch of a cell is a full chunk's,
    as ``k9_roofline`` bounds it."""
    from psrsigsim_torch.runtime import StageTimers

    timers = StageTimers()
    ens, got = _run(config, timers, n_obs=3, chunk_size=2)
    snap = timers.snapshot()
    assert [i for _, i, *_ in got] == [0, 1, 2]
    blocks = -(-ens.cfg.nsub * ens.cfg.nph // 4096)
    assert snap["dispatch_calls"] == 2
    assert snap["gamma.rows_count"] == 2 * 2 * 2 * config["nchan"] * blocks


@pytest.mark.parametrize("route", ["fused", "off-branch"])
def test_no_gamma_rows_or_field_spans_off_the_branch(config, monkeypatch,
                                                     route):
    """A chunk of 60 s subints (Nfold 12,000, Wilson-Hilferty) counts no
    gamma rows and opens no ``fields`` span; on the fused route (its
    kernel's plain version on the host) no ``quantize`` span either."""
    from psrsigsim_torch.parallel import ensemble
    from psrsigsim_torch.runtime import StageTimers

    config = dict(config, sublen_s=60.0, tobs_s=240.0)
    if route == "fused":
        monkeypatch.setenv("PSS_SAMPLER", "hw")
        monkeypatch.setattr(ensemble, "fused_route",
                            lambda cfg, device, null_frac=None: True)
    timers = StageTimers()
    _run(config, timers, n_obs=2)
    snap = timers.snapshot()
    assert snap["dispatch_calls"] == 1
    assert not any(k.startswith(("gamma.", "dispatch.fields"))
                   for k in snap)
    assert ("dispatch.quantize_calls" in snap) == (route == "off-branch")
