"""The scenario cell against its plain reference, on the host at a tiny
size: the reference in bfloat16 put in the program's place (the control)
is not correct, and neither is a run whose scenario draws are broken
underneath (gains left at 1, RFI levels left unscaled by the noise level,
an effect drawn on another effect's key stage).  Then the readers of the
cell's spans, on a synthetic record: each effect's milliseconds a chunk
inside the draws', and None for a program without the spans.

On the host the program runs its kernels' plain versions (``PSS_SAMPLER=
hw``: the card's random stream drawn with PyTorch ops)."""

import dataclasses
import importlib
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "j1713-l64-scn.stream"
CONFIG = dict(nchan=8, sample_rate_mhz=0.0512, tobs_s=120.0)
PARAMS = dict(n_obs=40, chunk_size=16, warmup_chunks=1, check_obs=6,
              check_every=1)


@pytest.fixture(autouse=True)
def _host_kernels(monkeypatch):
    monkeypatch.setenv("PSS_SAMPLER", "hw")


def _run():
    return harness.run_cell(CELL, 2**31 + 4321, 1.5, False, device="cpu",
                            require_cuda=False, config_override=CONFIG,
                            params_override=PARAMS)


def test_a_sound_run_reads_every_check():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"code_max_diff", "code_diff_pct",
                                "scl_max_rel", "offs_max_steps",
                                "rfi_mask_diff"}
    assert r["checks"]["rfi_mask_diff"]["value"] == 0.0


def test_the_control_is_not_correct():
    spec = harness.load_spec(ROOT)
    _, cell, _, config = harness.find_cell(spec, CELL, ROOT)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    c = driver.Cell(dict(config, **CONFIG), dict(cell["params"], **PARAMS),
                    harness.Context("cpu", 11))
    c.setup()
    c.window(1.0)
    c.free()
    checks = c.control(torch.bfloat16)
    assert any(v > lim for _, v, lim in checks), checks


def _unit_gains(monkeypatch):
    from psrsigsim_torch.scenarios import registry

    real = registry.scint_gain
    monkeypatch.setattr(registry, "scint_gain",
                        lambda *a, **k: torch.ones_like(real(*a, **k)))


def _unscaled_levels(monkeypatch):
    from psrsigsim_torch.parallel import ensemble

    monkeypatch.setattr(ensemble, "noise_level",
                        lambda cfg, norms: torch.ones_like(norms))


def _swapped_stage(monkeypatch):
    from psrsigsim_torch.scenarios import registry

    rfi = registry.EFFECTS["rfi"]
    monkeypatch.setitem(registry.EFFECTS, "rfi",
                        dataclasses.replace(rfi, stage="transient"))


@pytest.mark.parametrize("fault", [_unit_gains, _unscaled_levels,
                                   _swapped_stage],
                         ids=["unit-gains", "unscaled-levels",
                              "swapped-stage"])
def test_a_broken_draw_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


TIMERS = {"dispatch_s": 1.0, "dispatch_calls": 10,
          "dispatch.scenario_s": 0.8, "dispatch.scenario_calls": 10,
          "dispatch.scenario.scintillation_s": 0.5,
          "dispatch.scenario.rfi_s": 0.2,
          "dispatch.scenario.single_pulse_s": 0.05}


@pytest.mark.parametrize("name, want", [
    ("scn.draws_ms", 80.0), ("scn.scint_ms", 50.0), ("scn.rfi_ms", 20.0),
    ("scn.energy_ms", 5.0)])
def test_the_draws_read_their_seconds_over_the_dispatches(name, want):
    read = harness.load_reader(name, ROOT)
    assert read(SimpleNamespace(record={"timers": TIMERS})) == \
        pytest.approx(want)
    old = {k: v for k, v in TIMERS.items() if "." not in k}
    assert read(SimpleNamespace(record={"timers": old})) is None


def test_idle_under_the_draws_reads_none_without_the_span_or_a_trace():
    """A program without the ``dispatch.scenario`` span reads None, not 0,
    even where its span log holds other spans."""
    read = harness.load_reader("device.idle_draws.scn", ROOT)
    ms = 1_000_000
    trace = SimpleNamespace(t0=1.0, offset_ns=0,
                            events=[("k", 1_000 * ms, 100 * ms)])
    log = [["dispatch", 1_100 * ms, 1_900 * ms, None, 0],
           ["dispatch.scenario", 1_200 * ms, 1_700 * ms, "dispatch", 0]]

    def run(timers, with_trace=True):
        return SimpleNamespace(
            record={"timers": dict(timers, spans=log, spans_dropped=0)},
            trace=trace if with_trace else None, busy_s=0.1, window_s=1.0)

    assert read(run(TIMERS)) == pytest.approx(50.0)
    assert read(run(TIMERS, with_trace=False)) is None
    old = {k: v for k, v in TIMERS.items() if "." not in k}
    assert read(run(old)) is None
