"""The plain reference against the program, on the host at tiny sizes, for
each entry point a cell drives: a whole run (set-up, window, check) comes
out correct; the reference in a lower precision put in the program's
place (the control) comes out not correct; and so does a run whose timed
path is broken underneath (an answer altered where it is produced, half of
a batch left out, a step that hands back its previous state).

On the host the program runs its kernels' plain versions (``PSS_SAMPLER=
hw``: the card's random stream drawn with PyTorch ops), so the codes and
blocks are those of the card's kernels."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

# (config override, params override) of each cell at a size a test holds
TINY = {
    "j1713-l64.stream": (
        dict(nchan=8, sample_rate_mhz=0.0512, tobs_s=120.0),
        dict(n_obs=40, chunk_size=16, warmup_chunks=1, check_obs=6,
             check_every=1)),
    "msp128-l64.epochs": (
        dict(nchan=8, n_pulsars=4),
        dict(epochs_per_call=4, warmup_calls=1, check_obs=8,
             check_every=1)),
    "j1713-l64.mc": (
        dict(nchan=8, sample_rate_mhz=0.0512, tobs_s=120.0),
        dict(n_trials=64, chunk_size=16, check_trials=16)),
}
CELLS = [w["name"] for w in harness.load_spec(ROOT)["workloads"]]


@pytest.fixture(autouse=True)
def _host_kernels(monkeypatch):
    monkeypatch.setenv("PSS_SAMPLER", "hw")


def _run(name, seconds=1.5):
    cfg, params = TINY[name]
    return harness.run_cell(name, 2**31 + 12345, seconds, False,
                            device="cpu", require_cuda=False,
                            config_override=cfg, params_override=params)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    import importlib

    cfg, params = TINY[name]
    spec = harness.load_spec(ROOT)
    _, cell, _, config = harness.find_cell(spec, name, ROOT)
    config = dict(config, **cfg)
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    ctx = harness.Context("cpu", 7)
    c = driver.Cell(config, dict(cell["params"], **params), ctx)
    c.setup()
    c.window(1.0)
    c.free()
    checks = c.control(torch.bfloat16)
    assert any(v > lim for _, v, lim in checks), checks


def _alter(x):
    x = x.clone() if isinstance(x, torch.Tensor) else np.array(x)
    at = (slice(None),) + (0,) * (x.ndim - 1)
    if x.dtype in (torch.int16, np.int16):
        x[at] = x[at] // 2 - 16000
    else:
        x[at] = x[at] * 1.5
    return x


def _half(x):
    x = x.clone() if isinstance(x, torch.Tensor) else np.array(x)
    h = x.shape[0] // 2
    x[h:2 * h] = x[:h]
    return x


def _faulted(fn, fault):
    """``fn`` with its output broken by ``fault``; "stale" hands back the
    previous output of the same shape (a step that leaves its state
    unchanged)."""
    last = {}

    def wrapped(*a, **k):
        out = fn(*a, **k)
        first = out[0] if isinstance(out, tuple) else out
        if fault == "stale":
            # the previous output of this shape, where there is one
            shape = tuple(first.shape)
            broken = last.get(shape, first)
            last[shape] = first
        else:
            broken = {"altered": _alter, "half": _half}[fault](first)
        return (broken,) + out[1:] if isinstance(out, tuple) else broken

    return wrapped


def _patch(monkeypatch, name, fault):
    if name == "j1713-l64.stream":
        from psrsigsim_torch.parallel import FoldEnsemble as cls
        attr = "_quantized_packed"
    elif name == "msp128-l64.epochs":
        from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble as cls
        attr = "_run_mesh"
    else:
        from psrsigsim_torch.mc import MonteCarloStudy as cls
        attr = "_chunk_program"
    monkeypatch.setattr(cls, attr, _faulted(getattr(cls, attr), fault))


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _patch(monkeypatch, name, fault)
    r = _run(name)
    assert not r["correct"], r["checks"]
