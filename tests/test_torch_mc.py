"""The port's Monte-Carlo study engine (``psrsigsim_torch.mc``) against the
JAX package's, and against itself, on the CPU.

tests/test_mc.py's geometries: ``SIM_CONFIG`` (4 channels, 2 x 0.5 s
subints of 1024 bins) and ``SIM_SMALL`` (2 channels, 512 bins).
Tolerances and why:

* against the JAX package (threefry sampler, the reference's only one off
  a TPU):
  - sampled parameters bit for bit (jax's threefry keys and draws, with
    the fused multiply-adds XLA compiles), ``LogUniform`` within 2 ulp
    (torch's ``exp``); the ``fingerprint()`` dict equal, its
    ``profiles_sha256`` included;
  - a dm-only trial block within rtol 1e-5, floor 1e-5 of the peak (the
    two FFT libraries of the Fourier shift differ by ulps; the noise
    fields are bit-equal), and the port's own trial block bit-equal to
    its ``fold_pipeline``;
  - a study with scenario priors (scintillation, RFI, log-normal pulse
    energies): parameters bit for bit, fingerprint equal (its
    ``scenarios`` and ``scenario_defaults`` stamps included), rows within
    FFTFIT's tolerance;
  - whole-study metric rows within FFTFIT's tolerance (tests/
    test_torch_toa.py): residual metrics within 2e-6 turns, sigma and
    fitted amplitude within rtol 1e-4; histogram counts equal except
    where a metric lies within that tolerance of a bin edge — such flips
    are counted and each one checked;
* the port against itself (the card's ``hw`` stream, through the
  sampler kernel's plain version): summary, fingerprint and rows
  bit-identical across chunk sizes {32, 128, 512}; interrupted, resumed,
  SIGKILLed-and-resumed and integrity-healed sweeps byte-identical to a
  clean one; ``export_psrfits`` byte-identical to a direct export.

Reference values come from a child process (this file run as a script)
that applies the JAX-version shims R1 and R2 with one XLA CPU device; the
shims never touch the pytest worker.  A sweep that must die by SIGKILL is
this file run as a script with the port.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

pytestmark = pytest.mark.faults

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from test_torch_toa import child_env, shims  # noqa: E402

TEMPLATE = os.path.join(ROOT, "data", "B1855+09.L-wide.PUPPI.11y.x.sum.sm")
SIM_CONFIG = {
    "fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 0.2048,
    "Nchan": 4, "sublen": 0.5, "fold": True, "period": 0.005,
    "Smean": 0.05, "profiles": [0.5, 0.05, 1.0], "tobs": 1.0,
    "name": "J0000+0000", "dm": 10.0, "aperture": 100.0,
    "area": 5500.0, "Tsys": 35.0, "tscope_name": "T",
    "system_name": "S", "rcvr_fcent": 1400, "rcvr_bw": 400,
    "rcvr_name": "R", "backend_samprate": 12.5, "backend_name": "B",
}
SIM_SMALL = dict(SIM_CONFIG, Nchan=2, sample_rate=0.1024)
DM_NS = {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0},
         "noise_scale": {"dist": "loguniform", "lo": 0.5, "hi": 2.0}}
KNOBS = {"dm": {"dist": "normal", "mean": 12.0, "sigma": 2.0},
         "tau_d_ms": {"dist": "loguniform", "lo": 1e-4, "hi": 1e-2},
         "width": {"dist": "grid", "values": [0.03, 0.05, 0.07]},
         "amp": {"dist": "choice", "values": [0.5, 1.0, 2.0],
                 "probs": [0.2, 0.3, 0.5]},
         "noise_scale": {"dist": "choice", "values": [0.5, 1.0, 2.0]},
         "null_frac": {"dist": "uniform", "lo": 0.0, "hi": 0.5}}
SCEN = {"scint_mod": {"dist": "uniform", "lo": 0.2, "hi": 1.0},
        "scint_dt_d_s": {"dist": "uniform", "lo": 0.2, "hi": 2.0},
        "rfi_imp_prob": {"dist": "uniform", "lo": 0.0, "hi": 0.6},
        "sp_sigma": {"dist": "uniform", "lo": 0.1, "hi": 1.0},
        "dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}}
N_SCEN = 8
N_REF, CHUNK_REF = 24, 8
N_KNOBS = 8
SEED = 3


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.mc import Fixed, MonteCarloStudy
    from psrsigsim_tpu.simulate import Simulation
    from psrsigsim_tpu.utils.rng import stage_key

    def study(priors, seed=SEED):
        return MonteCarloStudy.from_simulation(
            Simulation(psrdict=dict(SIM_CONFIG)), priors, seed=seed)

    res, meta = {}, {}
    s = study(DM_NS)
    r = s.run(N_REF, chunk_size=CHUNK_REF)
    res["metrics"], res["hist"] = r.metrics, r.hist
    res["mn"], res["mx"] = r.minmax
    res["params"] = s.sampled_params(N_REF)
    meta["fingerprint"] = s.fingerprint(N_REF)
    meta["metric_names"] = list(s.metric_names)
    k = study(KNOBS)
    res["knob_metrics"] = k.run(N_KNOBS, chunk_size=N_KNOBS).metrics
    res["knob_params"] = k.sampled_params(N_KNOBS)
    meta["knob_names"] = list(k.metric_names)
    sc = study(SCEN)
    res["scen_metrics"] = sc.run(N_SCEN, chunk_size=N_SCEN).metrics
    res["scen_params"] = sc.sampled_params(N_SCEN)
    meta["scen_fingerprint"] = sc.fingerprint(N_SCEN)
    # one dm-only trial block, jitted as the chunk program runs it
    b = study({"dm": Fixed(12.5)}, seed=7)
    cfg = b.cfg
    key = stage_key(jax.random.key(7), "user", 3)
    freqs = jnp.asarray(cfg.meta.dat_freq_mhz(), jnp.float32)
    chan_ids = jnp.arange(cfg.meta.nchan)
    prof = jnp.asarray(b._profiles_np)
    res["block"] = np.asarray(jax.jit(lambda kk: b._trial_block(
        kk, jnp.int32(3), prof, freqs, chan_ids)[0])(key))
    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mc")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        res = dict(z)
    with open(out / "meta.json") as fh:
        res.update(json.load(fh))
    return res


# -- the port -------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def hw(monkeypatch):
    """The card's stream (the sampler kernel's plain version on the CPU)."""
    monkeypatch.setenv("PSS_SAMPLER", "hw")


def _study(priors, seed=SEED, config=SIM_CONFIG, **kw):
    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.simulate import Simulation

    return MonteCarloStudy.from_simulation(
        Simulation(psrdict=dict(config), device="cpu"), priors, seed=seed,
        **kw)


@pytest.fixture(scope="module")
def study_dm():
    return _study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}})


@pytest.fixture(scope="module")
def study_dm_ns():
    return _study(DM_NS)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_artifact(a, b, names=("study_result.json", "trials.npy")):
    for name in names:
        assert _read(os.path.join(a, name)) == _read(os.path.join(b, name)), \
            name


def _rows_close(got, want, names):
    """Metric rows within FFTFIT's tolerance; returns the per-metric
    tolerance used (absolute for residuals, relative otherwise)."""
    assert got.shape == want.shape and got.dtype == np.float32
    tol = {}
    for j, name in enumerate(names):
        if name in ("toa_err", "toa_rms"):
            np.testing.assert_allclose(got[:, j], want[:, j], rtol=0,
                                       atol=2e-6, err_msg=name)
            tol[name] = ("abs", 2e-6)
        elif name in ("toa_sigma", "fit_amp"):
            np.testing.assert_allclose(got[:, j], want[:, j], rtol=1e-4,
                                       err_msg=name)
            tol[name] = ("rel", 1e-4)
    return tol


# -- against the JAX package -------------------------------------------------------


def test_fingerprint_matches_reference(ref, study_dm_ns):
    fp = study_dm_ns.fingerprint(N_REF)
    assert fp == ref["fingerprint"]
    assert fp["config"]["profiles_sha256"] == \
        ref["fingerprint"]["config"]["profiles_sha256"]


def test_sampled_params_match_reference(ref, study_dm_ns):
    got = study_dm_ns.sampled_params(N_REF)
    np.testing.assert_array_equal(got[:, 0], ref["params"][:, 0])   # dm
    ulps = np.abs(got[:, 1].view(np.int32).astype(np.int64)
                  - ref["params"][:, 1].view(np.int32))
    assert ulps.max() <= 2   # LogUniform: torch's exp


def test_every_prior_kind_matches_reference(ref):
    study = _study(KNOBS)
    assert list(study.metric_names) == ref["knob_names"]
    got, want = study.sampled_params(N_KNOBS), ref["knob_params"]
    for j, name in enumerate(study.param_names):
        if name == "tau_d_ms":
            ulps = np.abs(got[:, j].view(np.int32).astype(np.int64)
                          - want[:, j].view(np.int32))
            assert ulps.max() <= 2
        else:
            np.testing.assert_array_equal(got[:, j], want[:, j], err_msg=name)


def test_trial_block_matches_reference_and_fold_pipeline(ref):
    """A dm-only trial is the fold pipeline: the JAX package's trial block
    within the FFT tolerance, the port's fold_pipeline bit for bit."""
    from psrsigsim_torch.simulate import fold_pipeline
    from psrsigsim_torch.utils import key, stage_key

    study = _study({"dm": {"dist": "fixed", "value": 12.5}}, seed=7)
    keys = stage_key(key(7, "cpu"), "user", torch.tensor([3]))
    p = study._sample_params(keys, np.array([3]))
    block = study._trial_block(keys, p)[0]
    want = ref["block"]
    assert block.shape == (1,) + want.shape
    np.testing.assert_allclose(block[0].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    direct = fold_pipeline(keys, 12.5, study.noise_norm, study._profiles,
                           study.cfg, freqs=study._freqs,
                           chan_ids=study._chan_ids)
    assert torch.equal(block, direct)


def test_study_rows_match_reference(ref, study_dm_ns):
    res = study_dm_ns.run(N_REF, chunk_size=CHUNK_REF)
    names = list(study_dm_ns.metric_names)
    assert names == ref["metric_names"]
    got, want = res.metrics, ref["metrics"]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    tol = _rows_close(got, want, names)
    # histogram counts: equal except for trials whose metric lies within
    # the tolerance of a bin edge on one side and past it on the other
    flips = 0
    for j, name in enumerate(names):
        lo, hi = res.hist_ranges[name]
        edges = np.linspace(lo, hi, res.hist.shape[1] + 1)
        bins = lambda v: np.clip(np.floor((v - lo) / (hi - lo)  # noqa: E731
                                          * res.hist.shape[1]),
                                 0, res.hist.shape[1] - 1)
        moved = np.nonzero(bins(got[:, j]) != bins(want[:, j]))[0]
        for i in moved:
            kind, t = tol.get(name, ("abs", 0.0))
            t = t * abs(want[i, j]) if kind == "rel" else t
            assert np.abs(edges - want[i, j]).min() <= t, (name, i)
        flips += moved.size
        assert abs(int(res.hist[j].sum()) - int(ref["hist"][j].sum())) == 0
    diff = np.abs(res.hist - ref["hist"]).sum() // 2
    assert diff <= flips
    np.testing.assert_array_equal(res.minmax[0][:1], ref["mn"][:1])
    np.testing.assert_array_equal(res.minmax[1][:1], ref["mx"][:1])


def test_scenario_priors_match_reference(ref):
    """Scenario knobs are priors: the stack they imply, the sampled
    parameters bit for bit, the fingerprint and the trial rows."""
    study = _study(SCEN)
    assert study._scenario.labels() == ["scintillation", "rfi",
                                        "single_pulse"]
    assert study.fingerprint(N_SCEN) == ref["scen_fingerprint"]
    got = study.sampled_params(N_SCEN)
    np.testing.assert_array_equal(got, ref["scen_params"])
    res = study.run(N_SCEN, chunk_size=N_SCEN)
    names = list(study.metric_names)
    np.testing.assert_array_equal(res.metrics[:, :5],
                                  ref["scen_metrics"][:, :5])
    _rows_close(res.metrics, ref["scen_metrics"], names)
    # the rows are chunk-size invariant with scenario effects too
    again = study.run(N_SCEN, chunk_size=3)
    np.testing.assert_array_equal(again.metrics, res.metrics)


def test_knob_study_rows_match_reference(ref):
    """tau_d_ms scattering delays, the per-trial Gaussian portrait of
    width/amp, null_frac's live mask and a Choice noise scale."""
    study = _study(KNOBS)
    res = study.run(N_KNOBS, chunk_size=N_KNOBS)
    assert res.metrics.shape == (N_KNOBS, 6 + 4)
    assert np.isfinite(res.metrics).all()
    got, want = res.metrics, ref["knob_metrics"]
    names = list(study.metric_names)
    for j, name in enumerate(study.param_names):
        if name != "tau_d_ms":
            np.testing.assert_array_equal(got[:, j], want[:, j], err_msg=name)
    _rows_close(got, want, names)


# -- construction -----------------------------------------------------------------


def test_unknown_knob_and_unported_options_raise(study_dm):
    from psrsigsim_torch.mc import MonteCarloStudy

    with pytest.raises(ValueError, match="unknown study knob"):
        _study({"bogus_knob": {"dist": "fixed", "value": 1.0}})
    # two single-pulse mode selectors name no one mode
    with pytest.raises(ValueError, match="ambiguous"):
        _study({"sp_sigma": {"dist": "fixed", "value": 0.5},
                "sp_amp": {"dist": "fixed", "value": 2.0}})
    from psrsigsim_torch.parallel import make_mesh

    # mesh= takes a Mesh (tests/test_torch_mesh.py holds the rows across
    # mesh shapes)
    with pytest.raises(TypeError, match="Mesh"):
        MonteCarloStudy(study_dm.cfg, study_dm._profiles_np,
                        study_dm.noise_norm, {}, mesh=object(), device="cpu")
    from psrsigsim_torch.simulate import Simulation

    sim = Simulation(psrdict=dict(SIM_CONFIG), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        sim.run_mc_study({}, 4, mesh=object())
    res = sim.run_mc_study({}, 4, mesh=make_mesh((2, 1), ["cpu"] * 2))
    assert res.metrics.shape[0] == 4


def test_exact_fft_config_rejected(study_dm):
    import dataclasses

    from psrsigsim_torch.mc import MonteCarloStudy

    cfg_fft = dataclasses.replace(study_dm.cfg, shift_mode="fft")
    with pytest.raises(ValueError, match="envelope"):
        MonteCarloStudy(cfg_fft, study_dm._profiles_np, study_dm.noise_norm,
                        {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}},
                        device="cpu")


def test_knobs_keep_the_reference_order():
    from psrsigsim_torch.mc import KNOBS as knobs

    assert knobs[:6] == ("dm", "tau_d_ms", "width", "amp", "noise_scale",
                         "null_frac")
    assert len(knobs) == 16 and knobs[-1] == "sp_amp"


def test_entry_points_need_a_device_without_cuda(monkeypatch, study_dm,
                                                 tmp_path):
    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.mc.__main__ import main
    from psrsigsim_torch.simulate import Simulation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MonteCarloStudy(study_dm.cfg, study_dm._profiles_np,
                        study_dm.noise_norm, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(psrdict=dict(SIM_CONFIG)).run_mc_study({}, 4)
    spec = _write_spec(tmp_path, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([spec, "--quiet"])


# -- the port against itself ------------------------------------------------------


def test_chunk_size_invariance_32_128_512(tmp_path, hw):
    """Summary, artifact fingerprint, rows and histograms bit-identical for
    trial chunks of 32, 128 and 512 (the fold and every sum run in a fixed
    order, whatever the chunk's width)."""
    study = _study(DM_NS, config=SIM_SMALL, seed=5)
    outs = []
    for cs in (32, 128, 512):
        res = study.run(512, chunk_size=cs, out_dir=str(tmp_path / f"c{cs}"))
        outs.append((json.dumps(res.summary(), sort_keys=True),
                     res.fingerprint, res.metrics, res.hist))
    for summary, fp, metrics, hist in outs[1:]:
        assert summary == outs[0][0]
        assert fp == outs[0][1]
        assert np.array_equal(metrics, outs[0][2])
        assert np.array_equal(hist, outs[0][3])
    assert (outs[0][3].sum(axis=1) == 512).all()


def test_sampled_params_match_metric_columns(study_dm_ns, hw):
    res = study_dm_ns.run(24, chunk_size=8)
    assert np.array_equal(study_dm_ns.sampled_params(24), res.metrics[:, :2])


def test_metrics_are_physical(hw):
    """Residuals scatter around zero within the reported sigma, which
    tracks the noise scale."""
    study = _study({"noise_scale": {"dist": "grid", "values": [0.5, 2.0]}})
    res = study.run(32, chunk_size=16)
    err, sig = res.column("toa_err"), res.column("toa_sigma")
    assert abs(err.mean()) < 4 * sig.mean() / np.sqrt(err.size)
    ns = res.column("noise_scale")
    assert sig[ns > 1.0].mean() > sig[ns < 1.0].mean()


def test_interrupt_resume_byte_identical(tmp_path, study_dm, hw):
    full = study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "a"))
    assert study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "b"),
                        _stop_after_chunks=1) is None
    resumed = study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "b"))
    assert resumed.fingerprint == full.fingerprint
    _same_artifact(tmp_path / "a", tmp_path / "b")
    # resuming across another chunk size
    study_dm.run(40, chunk_size=8, out_dir=str(tmp_path / "c"),
                 _stop_after_chunks=2)
    resumed = study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "c"))
    assert resumed.fingerprint == full.fingerprint


def test_torn_journal_tail_is_survived(tmp_path, study_dm, hw):
    full = study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "a"))
    out = str(tmp_path / "d")
    study_dm.run(40, chunk_size=16, out_dir=out, _stop_after_chunks=1)
    with open(os.path.join(out, "mc_journal.jsonl"), "a") as f:
        f.write('{"e": "chunk", "start": 16, "cou')  # torn mid-write
    resumed = study_dm.run(40, chunk_size=16, out_dir=out)
    assert resumed.fingerprint == full.fingerprint


def test_manifest_guards_against_different_study(tmp_path, study_dm, hw):
    from psrsigsim_torch.mc import StudyManifestError

    out = str(tmp_path / "a")
    study_dm.run(16, chunk_size=8, out_dir=out)
    with pytest.raises(StudyManifestError, match="seed"):
        _study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}},
               seed=4).run(16, chunk_size=8, out_dir=out)
    with pytest.raises(StudyManifestError, match="priors"):
        _study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 21.0}}).run(
            16, chunk_size=8, out_dir=out)
    # resume=False overwrites
    _study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}}, seed=4).run(
        16, chunk_size=8, out_dir=out, resume=False)


def test_result_load_roundtrip_and_queries(tmp_path, study_dm, hw):
    from psrsigsim_torch.mc import StudyResult

    res = study_dm.run(40, chunk_size=16, out_dir=str(tmp_path / "a"))
    back = StudyResult.load(str(tmp_path / "a"))
    assert back.fingerprint == res.fingerprint
    assert np.array_equal(back.metrics, res.metrics)
    assert np.array_equal(back.hist, res.hist)
    med = res.percentile("toa_err", 50)
    vals, cdf = res.ecdf("toa_err")
    assert vals[0] <= med <= vals[-1] and cdf[-1] == 1.0
    cond = res.conditional("dm", "toa_sigma", bins=4)
    assert cond["count"].sum() == 40
    edges = res.hist_edges("dm")
    assert (edges[0], edges[-1]) == res.hist_ranges["dm"]
    summ = res.summary()
    assert summ["per_metric"]["fit_amp"]["hist"]["counts"][-1] == 40


def test_telemetry_lands_on_manifest(tmp_path, study_dm, hw):
    from psrsigsim_torch.runtime import StageTimers

    tel = StageTimers(extra_stages=("reduce",))
    progress = []
    study_dm.run(16, chunk_size=8, out_dir=str(tmp_path / "a"),
                 telemetry=tel, progress=lambda d, t: progress.append((d, t)))
    with open(tmp_path / "a" / "study_manifest.json") as f:
        man = json.load(f)
    for stage in ("dispatch", "fetch", "reduce", "write"):
        assert man["pipeline"][f"{stage}_calls"] > 0
    # the host keys and prior draws of every chunk, inside its dispatch
    pipe = man["pipeline"]
    for child in ("dispatch.keys", "dispatch.priors"):
        assert pipe[f"{child}_calls"] >= pipe["dispatch_calls"] == 2
    assert pipe["dispatch.keys_s"] + pipe["dispatch.priors_s"] \
        <= pipe["dispatch_s"]
    assert "spans" not in pipe
    assert man["artifact_sha256"] and progress == [(8, 16), (16, 16)]


def _port_kill(out, scratch):
    """A sweep that dies by SIGKILL after chunk 0's journal commit (run as
    a script: ``--port-kill OUT SCRATCH``)."""
    from psrsigsim_torch.runtime import FaultPlan

    _study(DM_NS).run(24, chunk_size=8, out_dir=out,
                      faults=FaultPlan(scratch,
                                       {"mc.kill": {"after_start": 0}}))


def test_sigkill_mid_sweep_resumes_byte_identical(tmp_path, study_dm_ns, hw):
    clean = str(tmp_path / "clean")
    full = study_dm_ns.run(24, chunk_size=8, out_dir=clean)
    killed = str(tmp_path / "killed")
    env = dict(os.environ, PSS_SAMPLER="hw",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--port-kill", killed, str(tmp_path / "plan")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode in (-9, 137), proc.stderr[-3000:]
    with open(os.path.join(killed, "mc_journal.jsonl")) as fh:
        assert [json.loads(line)["start"] for line in fh] == [0]
    assert not glob.glob(os.path.join(killed, "study_result.json"))
    resumed = study_dm_ns.run(24, chunk_size=8, out_dir=killed)
    assert resumed.fingerprint == full.fingerprint
    _same_artifact(clean, killed, ("study_result.json", "trials.npy",
                                   "trials.f32", "mc_journal.jsonl"))


def test_integrity_heals_host_and_device_corruption(tmp_path, study_dm, hw):
    from psrsigsim_torch.runtime import FaultPlan, IntegrityChecker

    clean = str(tmp_path / "clean")
    study_dm.run(32, chunk_size=16, out_dir=clean)
    integ = str(tmp_path / "integ")
    ck = IntegrityChecker(audit_frac=1.0)
    study_dm.run(32, chunk_size=16, out_dir=integ, integrity=ck,
                 faults=FaultPlan(str(tmp_path / "plan"),
                                  {"host.corrupt": {"after_start": 0},
                                   "device.sdc": {"after_start": 16}}))
    st = ck.stats()
    assert (st["checksum_mismatches"], st["audit_mismatches"],
            st["healed_chunks"], st["permanent_failures"]) == (1, 1, 2, 0)
    _same_artifact(clean, integ, ("study_result.json", "trials.npy",
                                  "trials.f32"))
    with open(os.path.join(integ, "mc_journal.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [(r["kind"], r["start"]) for r in recs if r["e"] == "integrity"] \
        == [("checksum", 0), ("audit", 16)]
    assert all("dig" in r for r in recs if r["e"] == "chunk")
    with open(os.path.join(integ, "study_manifest.json")) as fh:
        assert json.load(fh)["integrity"] == st


def test_disk_bitrot_scrubbed_and_resume_heals(tmp_path, study_dm, hw):
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.runtime.integrity import scrub_mc_dir

    clean = str(tmp_path / "clean")
    study_dm.run(32, chunk_size=16, out_dir=clean)
    out = str(tmp_path / "rot")
    study_dm.run(32, chunk_size=16, out_dir=out,
                 faults=FaultPlan(str(tmp_path / "plan"),
                                  {"disk.bitrot": {"match": "start=16"}}))
    assert scrub_mc_dir(clean)["bad"] == []
    rep = scrub_mc_dir(out)
    assert rep["bad"] == [16] and rep["scrubbed"] == 1
    study_dm.run(32, chunk_size=16, out_dir=out)
    assert scrub_mc_dir(out)["bad"] == []
    _same_artifact(clean, out, ("study_result.json", "trials.npy",
                                "trials.f32"))


def test_device_digest_rows_equals_the_host_twin():
    from psrsigsim_torch.runtime.integrity import device_digest_rows, digest_rows

    rng = np.random.default_rng(0)
    rows = rng.normal(size=(37, 6)).astype(np.float32)
    rows[3, 2] = np.nan
    got = device_digest_rows(torch.from_numpy(rows))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  digest_rows(rows))
    ints = rng.integers(-2**15, 2**15, size=(5, 9)).astype(np.int16)
    np.testing.assert_array_equal(
        device_digest_rows(torch.from_numpy(ints), salt=7).numpy(),
        digest_rows(ints, salt=7))


# -- bridges and the CLI --------------------------------------------------------------


def test_ensemble_to_mc_study_and_folded_profiles(study_dm, hw):
    from psrsigsim_torch.simulate import Simulation, fold_subints

    ens = Simulation(psrdict=dict(SIM_CONFIG), device="cpu").to_ensemble()
    study = ens.to_mc_study({"dm": {"dist": "uniform", "lo": 5.0,
                                    "hi": 20.0}}, seed=SEED)
    assert study.device == ens.device
    a = study.run(8, chunk_size=8)
    b = study_dm.run(8, chunk_size=8)
    assert np.array_equal(a.metrics, b.metrics)
    block = ens.run(3, seed=1)
    folded = ens.folded_profiles(block)
    assert folded.shape == (3, 4, ens.cfg.nph)
    assert torch.equal(folded, fold_subints(block, ens.cfg.nsub, ens.cfg.nph))
    torch.testing.assert_close(
        folded, block.reshape(3, 4, ens.cfg.nsub, ens.cfg.nph).sum(2),
        rtol=1e-6, atol=1e-3)


def test_simulation_run_mc_study(tmp_path, study_dm, hw):
    from psrsigsim_torch.simulate import Simulation

    sim = Simulation(psrdict=dict(SIM_CONFIG), device="cpu")
    res = sim.run_mc_study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}},
                           16, seed=SEED, out_dir=str(tmp_path / "a"),
                           chunk_size=8)
    assert res.n_trials == 16 and res.fingerprint
    assert np.array_equal(res.metrics, study_dm.run(16, chunk_size=16).metrics)


def test_export_psrfits_matches_direct_ensemble_export(tmp_path, study_dm_ns,
                                                       hw):
    """A dm + noise_scale study's PSRFITS export is byte-identical to the
    ensemble's export with the sampled DMs and float32 noise norms — the
    trials ARE the observations."""
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.simulate import Simulation

    study = study_dm_ns
    d1, d2 = str(tmp_path / "study"), str(tmp_path / "direct")
    paths1 = study.export_psrfits(4, d1, TEMPLATE, supervised=False,
                                  writers=1, chunk_size=2)
    params = study.sampled_params(4)
    dms = np.asarray(params[:, 0], np.float64)
    norms = np.asarray(np.float32(study.noise_norm) * params[:, 1], np.float64)
    ens = Simulation(psrdict=dict(SIM_CONFIG), device="cpu").to_ensemble()
    paths2 = export_ensemble_psrfits(ens, 4, d2, TEMPLATE, ens.pulsar,
                                     seed=SEED, dms=dms, noise_norms=norms,
                                     writers=1, chunk_size=2)
    assert len(paths1) == 4
    for a, b in zip(sorted(paths1), sorted(paths2)):
        assert _read(a) == _read(b)
    with open(os.path.join(d1, "export_manifest.json")) as f:
        assert "mc_study" in json.load(f)
    res = study.export_psrfits(4, str(tmp_path / "sup"), TEMPLATE,
                               writers=1, chunk_size=2)
    assert [_read(p) for p in res.paths] == [_read(p) for p in sorted(paths1)]


def test_export_psrfits_choice_dms_packed(tmp_path, hw):
    """Choice DMs exported four observations per file: the same groups and
    bytes as the direct ensemble export of the same DMs."""
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.io.export import _GroupPacker
    from psrsigsim_torch.simulate import Simulation

    study = _study({"dm": {"dist": "choice", "values": [9.0, 14.0]}})
    d1, d2 = str(tmp_path / "study_p"), str(tmp_path / "direct_p")
    paths1 = study.export_psrfits(8, d1, TEMPLATE, supervised=False,
                                  writers=1, chunk_size=4, obs_per_file=4)
    dms = np.asarray(study.sampled_params(8)[:, 0], np.float64)
    assert len(paths1) == _GroupPacker(8, 4, dms=dms).n_groups < 8
    ens = Simulation(psrdict=dict(SIM_CONFIG), device="cpu").to_ensemble()
    paths2 = export_ensemble_psrfits(ens, 8, d2, TEMPLATE, ens.pulsar,
                                     seed=study.seed, dms=dms, writers=1,
                                     chunk_size=4, obs_per_file=4)
    assert [os.path.basename(p) for p in paths1] == \
        [os.path.basename(p) for p in paths2]
    for a, b in zip(paths1, paths2):
        assert _read(a) == _read(b)


def test_export_psrfits_rejects_profile_priors_and_bare_studies(tmp_path,
                                                                study_dm):
    from psrsigsim_torch.mc import MonteCarloStudy

    study = _study({"width": {"dist": "uniform", "lo": 0.02, "hi": 0.08}})
    with pytest.raises(NotImplementedError, match="width"):
        study.export_psrfits(2, str(tmp_path / "x"), TEMPLATE)
    bare = MonteCarloStudy(study_dm.cfg, study_dm._profiles_np,
                           study_dm.noise_norm, {}, device="cpu")
    with pytest.raises(RuntimeError, match="from_simulation"):
        bare.export_psrfits(2, str(tmp_path / "y"), TEMPLATE)


def _write_spec(tmp_path, out_dir):
    lines = ["[simulation]"]
    for k, v in SIM_CONFIG.items():
        if isinstance(v, str):
            lines.append(f'{k} = "{v}"')
        elif isinstance(v, bool):
            lines.append(f"{k} = {str(v).lower()}")
        else:
            lines.append(f"{k} = {v}")
    lines += ["[study]", "n_trials = 16", "seed = 2", "chunk_size = 8",
              f'out_dir = "{out_dir}"', "[priors.dm]", 'dist = "uniform"',
              "lo = 8.0", "hi = 16.0"]
    path = str(tmp_path / "study.toml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_toml_min_parser():
    from psrsigsim_torch.mc.__main__ import parse_toml_min

    spec = parse_toml_min(
        '# comment\n[a]\nx = 1\ny = 2.5\nz = "s"\nflag = true\n'
        'arr = [1.0, 2.0]  # trailing\n[b.c]\nk = -3\n')
    assert spec == {"a": {"x": 1, "y": 2.5, "z": "s", "flag": True,
                          "arr": [1.0, 2.0]}, "b": {"c": {"k": -3}}}
    with pytest.raises(ValueError):
        parse_toml_min("[[array.of.tables]]\n")
    with pytest.raises(ValueError):
        parse_toml_min("key value\n")


def test_cli_runs_a_spec_on_the_cpu(tmp_path, capsys, hw):
    from psrsigsim_torch.mc import StudyResult
    from psrsigsim_torch.mc.__main__ import load_spec, main

    out_dir = str(tmp_path / "out")
    spec = _write_spec(tmp_path, out_dir)
    assert load_spec(spec)["study"]["n_trials"] == 16
    assert main([spec, "--quiet", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "mc_study" and line["n_trials"] == 16
    assert line["params"] == ["dm"]
    back = StudyResult.load(out_dir)
    assert line["artifact_sha256"] == back.fingerprint
    study = _study({"dm": {"dist": "uniform", "lo": 8.0, "hi": 16.0}}, seed=2)
    assert np.array_equal(back.metrics, study.run(16, chunk_size=16).metrics)


def test_the_study_never_imports_jax(tmp_path):
    """A study runs, exports and goes through the CLI with jax and the JAX
    package blocked."""
    code = f"""
import importlib.abc, sys, json
sys.path.insert(0, {ROOT!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'psrsigsim_tpu'):
            raise ImportError('blocked import of ' + name)
sys.meta_path.insert(0, Block())
from psrsigsim_torch.mc import MonteCarloStudy, StudyResult
from psrsigsim_torch.mc.__main__ import main
from psrsigsim_torch.runtime.integrity import scrub_mc_dir
from psrsigsim_torch.simulate import Simulation
cfg = {SIM_SMALL!r}
res = Simulation(psrdict=cfg, device='cpu').run_mc_study(
    {DM_NS!r}, 4, seed=1, out_dir='out', chunk_size=2, integrity=True)
assert res.metrics.shape == (4, 6) and scrub_mc_dir('out')['bad'] == []
assert StudyResult.load('out').fingerprint == res.fingerprint
assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'psrsigsim_tpu')
               for k in sys.modules)
print('clean')
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PSS_SAMPLER"] = "hw"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


@pytest.mark.cuda
def test_study_on_the_card_matches_the_host(study_dm_ns):
    """On the card: the sampler kernel draws the fields, the rows equal a
    host run on the kernel's plain version within FFTFIT's tolerance and
    the parameters bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sampler kernel has no CPU mode")
    from psrsigsim_torch.ops import rng_hw

    card = _study(DM_NS, device="cuda")
    rng_hw.rng_field.launches = 0
    res = card.run(16, chunk_size=8)
    assert rng_hw.rng_field.launches == 4
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        host = study_dm_ns.run(16, chunk_size=8)
    finally:
        os.environ.pop("PSS_SAMPLER")
    np.testing.assert_array_equal(res.metrics[:, :2], host.metrics[:, :2])
    _rows_close(res.metrics, host.metrics, list(card.metric_names))


if __name__ == "__main__":
    if sys.argv[1] == "--port-kill":
        _port_kill(sys.argv[2], sys.argv[3])
    else:
        _child(sys.argv[1])
