"""The exact cell against its plain gamma reference, on the host at a tiny
size: a sound run reads every check and is correct; the reference in
bfloat16 put in the program's place, and the program with the exact
branch left out (Wilson-Hilferty at df 20), are not; neither is a run
whose fields are broken underneath (one draw of every row altered, two
channels' blocks of the pulse field swapped).  Then the cell's readers on
synthetic records (None without their span, counter or trace) and K9's
bound for one chunk at the cell's full size, as PERF.md gives it."""

import importlib
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, rooflines_gamma
from benchmark.conftest import EXACT_CELL as CELL, EXACT_TINY

ROOT = Path(__file__).resolve().parents[2]
CONFIG, PARAMS = EXACT_TINY


def _run(seed=2**31 + 2468):
    return harness.run_cell(CELL, seed, 1.0, False, device="cpu",
                            require_cuda=False, config_override=CONFIG,
                            params_override=PARAMS)


def test_a_sound_run_reads_every_check():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"code_max_diff", "code_diff_pct",
                                "scl_max_rel", "offs_max_steps"}
    assert r["checks"]["code_max_diff"]["value"] <= 2.0


def test_the_cell_refuses_an_environment_switch(monkeypatch):
    monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    with pytest.raises(RuntimeError, match="PSS_EXACT_CHI2"):
        _run()


def test_the_bfloat16_control_is_not_correct():
    spec = harness.load_spec(ROOT)
    _, cell, _, config = harness.find_cell(spec, CELL, ROOT)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    c = driver.Cell(dict(config, **CONFIG), dict(cell["params"], **PARAMS),
                    harness.Context("cpu", 13))
    c.setup()
    c.window(0.5)
    c.free()
    checks = c.control(torch.bfloat16)
    assert any(v > lim for _, v, lim in checks), checks


def _wilson_hilferty(monkeypatch):
    from psrsigsim_torch.ops import stats

    monkeypatch.setattr(stats, "_gamma_routed", lambda df: False)


def _one_draw_a_row(monkeypatch):
    from psrsigsim_torch.ops import gamma

    real = gamma.gamma_field

    def altered(*a, **k):
        out = real(*a, **k)
        out[:, 7] *= 1.5
        return out

    monkeypatch.setattr(gamma, "gamma_field", altered)


def _swapped_blocks(monkeypatch):
    from psrsigsim_torch.ops import stats

    real = stats._block_keys
    calls = [0]

    def swapped(*a, **k):
        kb, off = real(*a, **k)
        calls[0] += 1
        if calls[0] % 2:     # the pulse field, drawn first
            kb = kb.clone()
            kb[..., [0, 1], :, :] = kb[..., [1, 0], :, :]
        return kb, off

    monkeypatch.setattr(stats, "_block_keys", swapped)


@pytest.mark.parametrize("fault", [_wilson_hilferty, _one_draw_a_row,
                                   _swapped_blocks],
                         ids=["wilson-hilferty", "one-draw-a-row",
                              "swapped-blocks"])
def test_a_broken_field_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


TIMERS = {"dispatch_s": 1.0, "dispatch_calls": 10,
          "dispatch.fields_s": 0.6, "dispatch.fields_calls": 20,
          "dispatch.quantize_s": 0.1, "dispatch.quantize_calls": 10}


def test_the_fields_read_their_seconds_over_the_dispatches():
    read = harness.load_reader("exact.fields_ms", ROOT)
    assert read(SimpleNamespace(record={"timers": TIMERS})) == \
        pytest.approx(60.0)
    old = {k: v for k, v in TIMERS.items() if "." not in k}
    assert read(SimpleNamespace(record={"timers": old})) is None


def _trace(events):
    return SimpleNamespace(t0=1.0, offset_ns=0, events=events,
                           kernels=lambda needle: [d / 1e9 for n, _, d
                                                   in events if needle in n])


MS = 1_000_000
EVENTS = [("gamma_field_kernel", 1_000 * MS, 10 * MS),
          ("gamma_field_kernel", 1_020 * MS, 10 * MS),
          ("Memcpy DtoH (Device -> Pinned)", 1_040 * MS, 12 * MS),
          ("elementwise_kernel", 1_060 * MS, 6 * MS)]
RECORD = {"geometry": (64, 20, 2048), "chunk_obs": 128, "nfold": 20.0,
          "chunks": 2}


def test_k9_reads_its_bound_over_its_launches():
    read = harness.load_reader("k9_roofline", ROOT)
    bound, _ = rooflines_gamma.k9_chunk(128, 64, 40960, 20.0)
    run = SimpleNamespace(record=RECORD, trace=_trace(EVENTS))
    assert read(run) == pytest.approx(100.0 * bound / 0.010)
    no_k9 = SimpleNamespace(record=RECORD, trace=_trace(EVENTS[2:]))
    assert read(no_k9) is None
    assert read(SimpleNamespace(record=RECORD, trace=None)) is None


def test_the_body_reads_device_time_outside_k9_and_the_copies():
    read = harness.load_reader("exact.body_ms", ROOT)
    run = SimpleNamespace(record=RECORD, trace=_trace(EVENTS))
    assert read(run) == pytest.approx(3.0)
    # a cell whose chunks launch no K9 (the fused route) reads None
    fused = SimpleNamespace(record=RECORD, trace=_trace(EVENTS[2:]))
    assert read(fused) is None
    assert read(SimpleNamespace(record=RECORD, trace=None)) is None


def test_idle_under_the_fields_reads_none_without_the_span_or_a_trace():
    read = harness.load_reader("device.idle_fields.exact", ROOT)
    trace = _trace([("k", 1_000 * MS, 100 * MS)])
    log = [["dispatch", 1_100 * MS, 1_900 * MS, None, 0],
           ["dispatch.fields", 1_200 * MS, 1_700 * MS, "dispatch", 0]]

    def run(timers, with_trace=True):
        return SimpleNamespace(
            record={"timers": dict(timers, spans=log, spans_dropped=0)},
            trace=trace if with_trace else None, busy_s=0.1, window_s=1.0)

    assert read(run(TIMERS)) == pytest.approx(50.0)
    assert read(run(TIMERS, with_trace=False)) is None
    old = {k: v for k, v in TIMERS.items() if "." not in k}
    assert read(run(old)) is None


def test_k9_bound_for_one_chunk():
    """The numbers PERF.md gives for one chunk's field at the cell's size
    (128 observations x 64 channels x 10 blocks of 4096, alpha 10)."""
    outer, inner = rooflines_gamma.passes(10.0)
    assert outer == pytest.approx(1.0029423, abs=1e-7)
    assert inner == pytest.approx(outer, rel=1e-15)
    ops, calls = rooflines_gamma.ops_per_draw(10.0)
    assert calls == pytest.approx(7.0176541, abs=1e-6)
    assert ops["int32"] == pytest.approx(293.7415, abs=1e-3)
    assert ops["fp32"] == pytest.approx(635.6448, abs=1e-3)
    seconds, by = rooflines_gamma.k9_chunk(128, 64, 40960, 20.0)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(6.3755, abs=1e-4)
