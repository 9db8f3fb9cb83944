"""The port's ``Simulation`` façade against the JAX package's, on the CPU.

Tutorial 5's configuration (16 channels, 4 x 0.5 s subints of 1024 bins)
goes through both packages' ``Simulation``; the port runs on
``device="cpu"``.  Tolerances and why:

* ``simulate()`` (with and without ``tau_d``): the object-oriented flow of
  tests/test_torch_oo.py — shifted data within rtol 1e-5 with a floor of
  1e-5 of the peak (the two FFT libraries round differently).
* ``save_simulation`` to PSRFITS and to pdv text, given the same signal
  data: the same host code on the same floats — files byte-identical.
* ``to_ensemble`` and ``export_ensemble``: the port against itself — the
  façade's ensemble equals a hand-built ``FoldEnsemble`` bit for bit, and
  its exports equal a direct ``supervised_export`` /
  ``export_ensemble_psrfits`` of that ensemble byte for byte, with and
  without a scenario stack.
* the constructors and builders mirror tests/test_simulate.py's.

Reference values come from a child process (this file run as a script)
that applies the JAX-version shim the reference needs; the shim never
touches the pytest worker.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TEMPLATE = os.path.join(ROOT, "data", "B1855+09.L-wide.PUPPI.11y.x.sum.sm")

# docs/tutorial_5_simulate.md's parameters
PARS = {
    "fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 0.2048, "Nchan": 16,
    "fold": True, "sublen": 0.5, "tobs": 2.0, "period": 0.005,
    "Smean": 0.05, "profiles": [0.5, 0.05, 1.0], "name": "J0000+0000",
    "dm": 15.99, "specidx": 0.0, "tscope_name": "demo", "aperture": 100.0,
    "area": 5500.0, "Tsys": 35.0, "system_name": "demo_sys",
    "rcvr_fcent": 1400.0, "rcvr_bw": 400.0, "rcvr_name": "Lband",
    "backend_samprate": 12.5, "backend_name": "demo_backend", "seed": 11,
    "tempfile": TEMPLATE,
}
# tests/test_simulate.py's SIMDICT
SIMDICT = {
    "fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 1.5625 * 2048 * 1e-3,
    "dtype": np.float32, "Npols": 1, "Nchan": 8, "sublen": 0.5, "fold": True,
    "period": 0.005, "Smean": 0.05, "profiles": [0.5, 0.05, 1.0],
    "tobs": 2.0, "name": "J0000+0000", "dm": 10.0, "tau_d": None,
    "tau_d_ref_f": None, "aperture": 100.0, "area": 5500.0, "Tsys": 35.0,
    "tscope_name": "TestScope", "system_name": "TestSys", "rcvr_fcent": 1400,
    "rcvr_bw": 400, "rcvr_name": "TestRCVR", "backend_samprate": 12.5,
    "backend_name": "TestBack", "tempfile": None, "seed": 42,
}
SCATTER = {"tau_d": 5e-5, "tau_d_ref_f": 1400.0}


def _child(out_dir):
    """Reference values and files from the JAX package (a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    from psrsigsim_tpu.simulate import Simulation
    from psrsigsim_tpu.utils import set_seed

    os.chdir(out_dir)
    res = {}
    set_seed(0)
    sim = Simulation(psrdict=PARS)
    sim.simulate()
    res["data"] = np.asarray(sim.signal.data)
    res["delay"] = np.asarray(sim.signal.delay.to("ms").value)
    sim.save_simulation(outfile="demo.fits", out_format="psrfits")
    sim.save_simulation(outfile="demo.pdv", out_format="pdv")
    set_seed(0)
    sim = Simulation(psrdict=dict(PARS, **SCATTER))
    sim.simulate()
    res["data_scatter"] = np.asarray(sim.signal.data)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_simulate")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        res = dict(z)
    res["dir"] = str(out)
    return res


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv("PSS_SAMPLER", raising=False)
    monkeypatch.delenv("PSS_EXACT_CHI2", raising=False)


def _sim(pars=PARS, **kw):
    from psrsigsim_torch.simulate import Simulation

    return Simulation(psrdict=pars, device="cpu", **kw)


def _simulated(pars=PARS):
    from psrsigsim_torch.utils import set_seed

    set_seed(0)
    sim = _sim(pars)
    sim.simulate()
    return sim


def _shifted_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# -- the chain against the JAX package ---------------------------------------


def test_simulate_matches_reference(ref):
    sim = _simulated()
    data = sim.signal.data
    assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
    assert data.shape == (16, 4 * 1024)
    _shifted_close(data.numpy(), ref["data"])
    np.testing.assert_array_equal(sim.signal.delay.to("ms").value, ref["delay"])
    assert sim.signal._dispersed


def test_simulate_with_scattering_matches_reference(ref):
    sim = _simulated(dict(PARS, **SCATTER))
    _shifted_close(sim.signal.data.numpy(), ref["data_scatter"])


@pytest.mark.parametrize("fmt", ["psrfits", "pdv"])
def test_save_simulation_byte_identical(ref, tmp_path, monkeypatch, fmt):
    """Given the reference's signal data, the port's files are the JAX
    package's, byte for byte."""
    sim = _simulated()
    sim.signal.data = torch.from_numpy(ref["data"])
    monkeypatch.chdir(tmp_path)
    if fmt == "psrfits":
        sim.save_simulation(outfile="demo.fits", out_format="psrfits")
        names = ["demo.fits", "simpar.par"]
    else:
        sim.save_simulation(outfile="demo.pdv", out_format="pdv")
        names = sorted(os.path.basename(p) for p in glob.glob("demo.pdv_*.txt"))
        assert names == sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(ref["dir"], "demo.pdv_*.txt")))
    for n in names:
        assert _read(tmp_path / n) == _read(os.path.join(ref["dir"], n)), n


def test_save_simulation_errors():
    sim = _simulated()
    with pytest.raises(RuntimeError):
        sim.save_simulation(out_format="nope")
    sim._tempfile = None
    with pytest.raises(RuntimeError):
        sim.save_simulation(out_format="psrfits")


# -- the bridges to the ensemble ----------------------------------------------


def _hand_built():
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.pulsar import GaussPortrait, Pulsar
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.utils import make_quant

    sig = FilterBankSignal(1400.0, 400.0, Nsubband=16, sample_rate=0.2048,
                           fold=True, sublen=0.5, device="cpu")
    sig._tobs = make_quant(2.0, "s")
    sig._dm = make_quant(15.99, "pc/cm^3")
    psr = Pulsar(0.005, 0.05, GaussPortrait(peak=0.5, width=0.05, amp=1.0),
                 name="J0000+0000", seed=11)
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="demo")
    tel.add_system("demo_sys", Receiver(fcent=1400.0, bandwidth=400.0,
                                        name="Lband"),
                   Backend(samprate=12.5, name="demo_backend"))
    return FoldEnsemble(sig, psr, tel, "demo_sys", device="cpu")


def test_to_ensemble_scenario_equals_hand_built(tmp_path):
    """to_ensemble(scenario=) builds the hand-built scenario ensemble, and
    export_ensemble(scenario=, scenario_params=) exports it."""
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.runtime import supervised_export

    stack = ["rfi", "single_pulse:powerlaw"]
    sp = {"rfi_imp_prob": np.array([0.9, 0.1, 0.5], np.float32),
          "sp_alpha": 3.0}
    ens = _sim().to_ensemble(scenario=stack)
    hand = _hand_built()
    hand = FoldEnsemble.from_config(hand.cfg, hand._profiles_np,
                                    hand.noise_norm, dm=hand.dm, device="cpu",
                                    scenario=stack)
    assert ens.scenario.labels() == ["rfi", "single_pulse:powerlaw"]
    got = ens.run_quantized(3, seed=0, return_rfi=True, scenario_params=sp)
    want = hand.run_quantized(3, seed=0, return_rfi=True, scenario_params=sp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[3].any()
    kw = dict(seed=0, chunk_size=2, writers=1, scenario_params=sp)
    res = _sim().export_ensemble(3, str(tmp_path / "a"), scenario=stack, **kw)
    direct = supervised_export(ens, 3, str(tmp_path / "b"), TEMPLATE,
                               ens.pulsar, **kw)
    for p, q in zip(res.paths, direct.paths):
        assert _read(p) == _read(q)


def test_to_ensemble_equals_hand_built():
    sim = _sim()
    ens = sim.to_ensemble()
    assert ens.device.type == "cpu" and ens.ephemeris_source is None
    hand = _hand_built()
    assert ens.cfg == hand.cfg and ens.noise_norm == hand.noise_norm
    for a, b in zip(ens.run_quantized(3, seed=0), hand.run_quantized(3, seed=0)):
        assert torch.equal(a, b)
    assert torch.equal(ens.run(2, seed=1), hand.run(2, seed=1))


@pytest.mark.parametrize("supervised", [True, False])
def test_export_ensemble_equals_direct_export(tmp_path, supervised):
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.runtime import supervised_export

    kw = dict(seed=0, chunk_size=2, writers=1)
    res = _sim().export_ensemble(3, str(tmp_path / "a"), supervised=supervised,
                                 **kw)
    ens = _hand_built()
    direct = supervised_export if supervised else export_ensemble_psrfits
    want = direct(ens, 3, str(tmp_path / "b"), TEMPLATE, ens.pulsar, **kw)
    paths = res.paths if supervised else res
    want = want.paths if supervised else want
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in want] and len(paths) == 3
    for p, q in zip(paths, want):
        assert _read(p) == _read(q)
    if supervised:
        assert res.quarantined == [] and os.path.exists(
            tmp_path / "a" / "run_journal.jsonl")


def test_export_ensemble_needs_a_template(tmp_path):
    with pytest.raises(RuntimeError):
        _sim(dict(PARS, tempfile=None)).export_ensemble(2, str(tmp_path))


def test_ephemeris_is_stamped_and_reapplied(tmp_path, monkeypatch):
    """``ephemeris=`` sets the process-global kernel at construction, the
    façade's ensemble carries it, and the exporter re-applies it when
    another Simulation changed the switch in between (the JAX package's
    tests/test_export.py::TestExportEphemerisReapply)."""
    from psrsigsim_torch.io import ephem, export_ensemble_psrfits, spk
    from psrsigsim_torch.parallel import FoldEnsemble

    monkeypatch.setattr(spk, "SPKKernel", lambda path: object())
    d = dict(SIMDICT, Nchan=4, tobs=1.0)
    try:
        ens = _sim(d, ephemeris="a.bsp").to_ensemble()
        assert ens.ephemeris_source == "a.bsp"
        with pytest.warns(ephem.EphemerisChangeWarning):
            _sim(d, ephemeris="b.bsp")
        assert ephem._EPHEM_SOURCE == "b.bsp"
        monkeypatch.setattr(FoldEnsemble, "iter_chunks",
                            lambda self, *a, **k: iter(()))
        export_ensemble_psrfits(ens, 2, str(tmp_path / "e"), TEMPLATE,
                                ens.pulsar, seed=0, writers=1)
        assert ephem._EPHEM_SOURCE == "a.bsp"
    finally:
        ephem.set_ephemeris(None)


def test_later_slices_raise(tmp_path):
    """mesh= (ported: tests/test_torch_mesh.py) takes a Mesh; anything
    else raises TypeError, a real one runs."""
    from psrsigsim_torch.parallel import make_mesh

    sim = _sim()
    with pytest.raises(TypeError, match="Mesh"):
        sim.to_ensemble(mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        sim.export_ensemble(2, str(tmp_path), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        sim.run_mc_study({}, 4, mesh=object())
    m = make_mesh((2, 1), ["cpu"] * 2)
    assert sim.to_ensemble(mesh=m).run(3).shape[0] == 3
    assert sim.run_mc_study({}, 4, mesh=m).metrics.shape[0] == 4


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from psrsigsim_torch.simulate import Simulation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = Simulation(psrdict=PARS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.simulate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(psrdict=PARS).to_ensemble()


# -- constructors and builders (tests/test_simulate.py) -------------------------


def test_kwargs_ctor():
    from psrsigsim_torch.simulate import Simulation

    s = Simulation(fcent=1400, bandwidth=400, Nchan=16, period=0.005,
                   Smean=0.01, tobs=1.0, dm=5.0)
    assert (s.fcent, s.bw, s.Nchan, s.dm) == (1400, 400, 16, 5.0)


def test_dict_ctor_and_override():
    from psrsigsim_torch.simulate import Simulation

    s = Simulation(psrdict=SIMDICT)
    assert s.fcent == 1400.0 and s.period == 0.005
    assert s.tscope_name == "TestScope"
    assert Simulation(fcent=999.0, psrdict=SIMDICT).fcent == 1400.0


def test_parfile_ctor():
    from psrsigsim_torch.data import data_path
    from psrsigsim_torch.simulate import Simulation

    s = Simulation(parfile=data_path("J1713+0747_NANOGrav_11yv1.gls.par"))
    assert s.name == "J1713+0747"
    assert abs(1.0 / s.period - 218.81) < 0.01
    assert abs(s.dm - 15.917) < 0.01
    with pytest.raises(FileNotFoundError):
        Simulation(parfile="fake.par")


def test_init_signal():
    s = _sim(SIMDICT)
    s.init_signal()
    assert s.signal.Nchan == 8 and s.signal.fold is True
    assert s.signal.device == torch.device("cpu")


def test_init_signal_from_template():
    s = _sim(dict(SIMDICT, tempfile=TEMPLATE))
    s.init_signal(from_template=True)
    assert s.signal.sigtype == "FilterBankSignal"
    assert s.signal.device == torch.device("cpu")


@pytest.mark.parametrize("kind", ["triple", "array", "instance", "none",
                                  "too_few", "callable"])
def test_init_profile(kind, capsys):
    from psrsigsim_torch.pulsar import DataProfile, GaussPortrait

    port = GaussPortrait(peak=0.3)
    ph = np.arange(64) / 64
    profiles = {"triple": [0.5, 0.05, 1.0],
                "array": np.exp(-0.5 * ((ph - 0.5) / 0.05) ** 2),
                "instance": port, "none": None, "too_few": [0.5, 0.05],
                "callable": lambda x: x}[kind]
    s = _sim(dict(SIMDICT, profiles=profiles))
    if kind == "too_few":
        with pytest.raises(RuntimeError):
            s.init_profile()
        return
    if kind == "callable":
        with pytest.raises(NotImplementedError):
            s.init_profile()
        return
    s.init_profile()
    if kind == "triple":
        assert isinstance(s.profiles, GaussPortrait) and s.profiles.peak == 0.5
    elif kind == "array":
        assert isinstance(s.profiles, DataProfile)
    elif kind == "instance":
        assert s.profiles is port
    else:
        assert isinstance(s.profiles, GaussPortrait)
        assert "defaulting to Gaussian" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["custom", "GBT", "Arecibo", "lists",
                                  "mismatched"])
def test_init_telescope(kind):
    d = dict(SIMDICT)
    if kind in ("GBT", "Arecibo"):
        d.update(tscope_name=kind, rcvr_fcent=None)
    elif kind == "lists":
        d.update(system_name=["a", "b"], rcvr_fcent=[800, 1400],
                 rcvr_bw=[200, 400], rcvr_name=["r1", "r2"],
                 backend_samprate=[3.125, 12.5], backend_name=["b1", "b2"])
    elif kind == "mismatched":
        d.update(system_name=["a"], rcvr_fcent=[800, 1400], rcvr_bw=[200, 400],
                 rcvr_name=["r1", "r2"], backend_samprate=[3.125, 12.5],
                 backend_name=["b1", "b2"])
    s = _sim(d)
    if kind == "mismatched":
        with pytest.raises(RuntimeError):
            s.init_telescope()
        return
    s.init_telescope()
    want = {"custom": {"TestSys"}, "GBT": {"Lband_GUPPI", "820_GUPPI"},
            "Arecibo": {"430_PUPPI", "Lband_PUPPI"}, "lists": {"a", "b"}}[kind]
    assert want <= set(s.tscope.systems)


def test_init_all_stamps_the_signal():
    s = _sim(SIMDICT).init_all()
    assert s.signal.tobs.to("s").value == 2.0
    assert s.signal.dm.value == 10.0
    assert s.signal.data is None


if __name__ == "__main__":
    _child(sys.argv[1])
