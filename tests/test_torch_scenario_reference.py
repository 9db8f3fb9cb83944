"""The port's scenario engine against the benchmark's plain reference
(``benchmark/reference/scenario.py``), on the CPU at a small geometry:
BASELINE config 1's J1713+0747 cut to 16 channels, 4 subints of 60 s and
64 bins, 4 observations.

* ``scenarios.scenario_rows`` against the reference's factors, for each
  effect alone and the three together, with per-observation knob arrays:
  scintle cell ids and RFI masks exactly, gains, RFI levels and energies
  within a stated rtol;
* the scintle cell ids of the whole L band over a range of scintillation
  bandwidths and timescales, exactly;
* a quantized ``FoldEnsemble.iter_chunks(rfi_mask=True)`` against the
  reference's observation: masks exactly, codes within a stated LSB.

The program runs its kernels' plain versions on the card's random stream
(``PSS_SAMPLER=hw``), which the reference draws too."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import objects  # noqa: E402
from benchmark.drivers.scenario import scenario_ensemble  # noqa: E402
from benchmark.reference import fold as RF  # noqa: E402
from benchmark.reference import keys as RK  # noqa: E402
from benchmark.reference import observations as RO  # noqa: E402
from benchmark.reference import scenario as RS  # noqa: E402

SEED = 2**31 - 77
N_OBS = 4
ALL = ["scintillation", "rfi", "single_pulse:lognormal"]
STACKS = [["scintillation"], ["rfi"], ["single_pulse:lognormal"], ALL]

# Gains: 1 + m (e - 1) with e = -log1p(-u); the program rounds e (XLA's
# float32 log1p polynomial, within 2 ulp), e - 1 and a fused multiply-add
# to float32, the reference rounds once.  The sum with 1 puts the error in
# units of 1's ulp, so it is taken relative to max(g, 1): a few float32
# ulps (1.1e-7 at most over 64 observations of the whole band).
GAIN_RTOL = 1e-6
# RFI levels: snr · e, a sum and the scaling by the noise level, each
# rounded to float32 in the program, whose noise scale is also a float32
# rounding of the reference's float64 one: a few ulps (1.6e-7 at most
# over 64 observations of the whole band).
LEVEL_RTOL = 1e-6
# Energies: exp(sigma z - sigma^2/2) through XLA's float32 erfinv and exp
# polynomials; an absolute error of a few 1e-7 in the exponent (|z| up to
# 5.3) is a relative one in the energy (3.8e-6 at most over 64
# observations of the whole band).
ENERGY_RTOL = 1e-5
# Codes: the reference shifts the portrait in float64 and rounds each
# factor once, the program shifts in float32 and rounds every step, so a
# sample that lies within an ulp of a code boundary can round the other
# way: one LSB.
CODE_LSB = 1


@pytest.fixture(autouse=True)
def _hw_stream(monkeypatch):
    monkeypatch.setenv("PSS_SAMPLER", "hw")


@pytest.fixture(scope="module")
def config():
    with open(ROOT / "benchmark" / "configs" / "j1713-l64-scn.json") as f:
        c = json.load(f)
    return dict(c, nchan=16, sample_rate_mhz=0.0128, tobs_s=240.0)


def _knobs(config, effects):
    """The configuration's shared knobs and a per-observation array for one
    knob of each effect."""
    rng = np.random.default_rng(5)
    sp = dict(config["scenario_params"])
    sp["scint_mod"] = rng.uniform(0.2, 1.0, N_OBS)
    sp["rfi_imp_prob"] = rng.uniform(0.0, 0.5, N_OBS)
    sp["sp_sigma"] = rng.uniform(0.2, 1.0, N_OBS)
    names = {"scintillation": ("scint_",), "rfi": ("rfi_",),
             "single_pulse": ("sp_",)}
    keep = tuple(p for e in effects for p in names[e.partition(":")[0]])
    return {k: v for k, v in sp.items() if k.startswith(keep)}


def _at(sp, i):
    return {k: (v[i] if np.ndim(v) else v) for k, v in sp.items()}


def _ensemble(config, effects):
    return scenario_ensemble(dict(config, scenario=effects), "cpu")


def _obs_key(i):
    return RK.stage_key(RK.key(SEED), "user", i)


def _close(got, want, rtol, floor=1e-30):
    """``|got - want| <= rtol · max(|want|, floor)`` everywhere."""
    got = got.to(torch.float64)
    err = ((got - want).abs() / want.abs().clamp_min(floor)).max()
    assert float(err) <= rtol, float(err)


@pytest.mark.parametrize("effects", STACKS, ids=lambda e: "+".join(e))
def test_scenario_rows_match_the_reference(config, effects):
    from psrsigsim_torch.scenarios import scenario_rows
    from psrsigsim_torch.simulate.pipeline import noise_level
    from psrsigsim_torch.utils import rng

    ens = _ensemble(config, effects)
    sp = _knobs(config, effects)
    keys = rng.stage_key(rng.key(SEED, "cpu"), "user", torch.arange(N_OBS))
    norms = torch.full((N_OBS,), ens.noise_norm, dtype=torch.float32)
    params = {k: torch.as_tensor(np.asarray(v, np.float32))
              for k, v in sp.items()}
    rows = scenario_rows(keys, effects, params, ens.cfg,
                         noise_level(ens.cfg, norms))
    geom = RO.single_pulsar(config, objects.profile_data(config))
    df = float(np.float32(geom.nfold))
    for i in range(N_OBS):
        ref = RS.factors(_obs_key(i), effects, _at(sp, i), freqs=geom.freqs,
                         nsub=geom.nsub, fcent_mhz=config["fcent_mhz"],
                         bw_mhz=config["bw_mhz"],
                         sublen_s=config["sublen_s"],
                         noise_level=df * geom.norm)
        for name in ("gain", "energy", "level", "mask"):
            assert (getattr(rows, name) is None) == (getattr(ref, name)
                                                     is None), name
        if ref.gain is not None:
            _close(rows.gain[i], ref.gain, GAIN_RTOL, floor=1.0)
        if ref.energy is not None:
            _close(rows.energy[i], ref.energy, ENERGY_RTOL)
        if ref.mask is not None:
            assert torch.equal(rows.mask[i], ref.mask)
            # a level is zero exactly where the mask is clear
            assert torch.equal(rows.level[i] > 0, ref.level > 0)
            hit = ref.mask
            if hit.any():
                _close(rows.level[i][hit], ref.level[hit], LEVEL_RTOL)


@pytest.mark.parametrize("dnu, dt", [(0.05, 2.0), (1.0, 30.0), (50.0, 60.0),
                                     (500.0, 2000.0)])
def test_scintle_cells_match_the_reference(dnu, dt):
    from psrsigsim_torch.ops.scenario import scint_cells

    fcent, bw, nchan, nsub, sublen = 1380.0, 400.0, 64, 20, 60.0
    freqs = RF.channel_freqs(fcent, bw, nchan)
    got_f, got_t = scint_cells(freqs, nsub, dnu, dt, fcent, sublen,
                               fcent - bw / 2)
    want_f, want_t = RS.scint_cells(freqs, nsub, dnu, dt, fcent, bw, sublen)
    assert torch.equal(got_f, want_f) and torch.equal(got_t, want_t)


@pytest.mark.parametrize("effects", STACKS, ids=lambda e: "+".join(e))
def test_iter_chunks_matches_the_reference(config, effects):
    ens = _ensemble(config, effects)
    sp = _knobs(config, effects)
    rfi = "rfi" in effects
    got = {}
    for start, block in ens.iter_chunks(N_OBS, chunk_size=2, seed=SEED,
                                        quantized=True, byte_order="big",
                                        rfi_mask=rfi, scenario_params=sp):
        for j in range(block[0].shape[0]):
            got[start + j] = tuple(a[j] for a in block)
    assert sorted(got) == list(range(N_OBS))
    geom = RO.single_pulsar(config, objects.profile_data(config))
    for i, block in got.items():
        codes, scl, offs, mask = RS.observation(
            geom, _obs_key(i), effects, _at(sp, i),
            fcent_mhz=config["fcent_mhz"], bw_mhz=config["bw_mhz"],
            sublen_s=config["sublen_s"], device="cpu")
        d = (torch.from_numpy(block[0].view(">i2").astype(np.int32))
             - codes.to(torch.int32)).abs()
        assert int(d.max()) <= CODE_LSB
        # DAT_SCL and DAT_OFFS follow the row's extremes: a few ulps of the
        # scale, and an offset within a code step
        s = torch.from_numpy(np.asarray(block[1], np.float32))
        o = torch.from_numpy(np.asarray(block[2], np.float32))
        assert float(((s - scl).abs() / scl).max()) <= 1e-5
        assert float(((o - offs).abs() / scl).max()) <= 1.0
        if rfi:
            assert np.array_equal(block[3], mask.numpy())
