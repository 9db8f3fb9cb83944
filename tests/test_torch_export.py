"""The port's PSRFITS export against the JAX package's, on the CPU.

Same objects, seeds and quantized triples go through both packages
(small geometry: 4 channels, 1024 bins, 2 x 0.5 s subints, the repo's
B1855+09 template).  Tolerances and why:

* the writers (``PSRFITS.save(quantized=)``, the fast prototype writer,
  packed groups, per-observation DMs): the same host numpy arithmetic on
  the same triple — files byte-identical.
* end to end (the port's export against the reference export of the same
  seed, threefry sampler): every byte outside SUBINT ``DATA``/``DAT_SCL``/
  ``DAT_OFFS`` equal; ``DATA`` within 1 LSB on at most 1% of entries and
  ``DAT_SCL``/``DAT_OFFS`` within rtol 1e-5, the ensemble bound of
  tests/test_torch_pipeline.py (the two FFT libraries differ by ulps).
* the port against itself across pipeline depths, chunk sizes, writer
  counts and resume: byte-identical.
* a scenario export (scintillation, RFI and FRB energies with
  per-observation parameters) against the reference's: the files within the
  end-to-end bound above, the manifest's ``scenario`` and
  ``scenario_params_sha256`` fingerprint fields equal.

Reference files come from a child process (this file run as a script)
that applies the JAX-version shim the reference's traced-DM path needs;
the shim never touches the pytest worker.
"""

import copy
import importlib
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TEMPLATE = os.path.join(ROOT, "data", "B1855+09.L-wide.PUPPI.11y.x.sum.sm")
N_OBS = 5
SEED = 4


def _geometry(pkg):
    """The export geometry of tests/test_export.py from either package:
    4 channels over 400 MHz at 1400 MHz, 0.2048 MHz sampling (1024 bins of
    a 5 ms pulsar), 2 x 0.5 s subints, DM 10."""
    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                             fold=True, sublen=0.5)
    psr = P.Pulsar(0.005, 0.05, P.GaussProfile(peak=0.5, width=0.05, amp=1.0),
                   name="J0000+0000", seed=8)
    sig._tobs = U.make_quant(1.0, "s")
    sig._dm = U.make_quant(10.0, "pc/cm^3")
    tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="T")
    tel.add_system("S", T.Receiver(fcent=1400, bandwidth=400, name="R"),
                   T.Backend(samprate=12.5, name="B"))
    return sig, psr, tel, "S"


def _triples(nsub, nchan, nbin):
    """Quantized triples made with numpy from a seed: int16 codes over the
    full range, positive scales, signed offsets."""
    r = np.random.default_rng(2024)
    out = []
    for rows in (nsub, nsub, nsub, 3 * nsub, 3 * nsub, 2 * nsub):
        out.append((r.integers(-32767, 32768, (rows, nchan, nbin)).astype(np.int16),
                    r.uniform(1e-3, 5.0, (rows, nchan)).astype(np.float32),
                    r.normal(100.0, 30.0, (rows, nchan)).astype(np.float32)))
    return out


# (file, writer, triple index, DM): the full assembly once, then the fast
# writer's prototype and refills, for one DM, a per-observation DM, packed
# groups of three observations and a short final group of two
WRITES = [
    ("full_save", "save", 0, None),
    ("full_save_dm", "save", 1, 12.5),
    ("fast_proto", "fast", 0, None),
    ("fast_refill", "fast", 1, None),
    ("fast_dm_proto", "fast", 1, 12.5),
    ("fast_dm_refill", "fast", 2, 12.5),
    ("packed_proto", "fast", 3, None),
    ("packed_refill", "fast", 4, None),
    ("packed_short", "fast", 5, None),
]


def _write_cases(pkg, out):
    """Write every file of :data:`WRITES` with ``pkg``'s writers."""
    build = importlib.import_module(pkg + ".simulate").build_fold_config
    io = importlib.import_module(pkg + ".io")
    export = importlib.import_module(pkg + ".io.export")
    U = importlib.import_module(pkg + ".utils")
    sig, psr, tel, system = _geometry(pkg)
    cfg, _, _ = build(sig, psr, tel, system)
    tmpl = io.FitsFile.read(TEMPLATE)
    parfile = os.path.join(out, "J0000+0000_sim.par")
    U.make_par(sig, psr, outpar=parfile)
    triples = _triples(cfg.nsub, cfg.meta.nchan, cfg.nph)
    state = {"sig": copy.copy(sig), "pulsar": psr, "template": tmpl,
             "parfile": parfile, "MJD_start": 56000.0, "ref_MJD": 56000.0,
             "ephemeris_source": None, "hash_files": False, "faults": None,
             "timers": None}
    for name, how, k, dm in WRITES:
        path = os.path.join(out, name + ".fits")
        d, s, o = triples[k]
        triple = (d.astype(">i2"), s, o)
        if how == "save":
            one = copy.copy(sig)
            if dm is not None:
                one._dm = U.make_quant(dm, "pc/cm^3")
            pfit = io.PSRFITS(path=path, template=tmpl, obs_mode="PSR")
            pfit.get_signal_params(signal=one)
            pfit.save(one, psr, parfile=parfile, MJD_start=56000.0,
                      ref_MJD=56000.0, quantized=triple, verbose=False)
        else:
            export._write_obs(state, path, triple, dm)


def _ref_ensemble(pkg, device=None, scenario=None):
    sig, psr, tel, system = _geometry(pkg)
    par = importlib.import_module(pkg + ".parallel")
    kw = {} if scenario is None else {"scenario": scenario}
    if device is None:
        return par.FoldEnsemble(sig, psr, tel, system, **kw)
    return par.FoldEnsemble(sig, psr, tel, system, device=device, **kw)


END_TO_END = {"per_file": dict(obs_per_file=1),
              "packed": dict(obs_per_file=2)}
# the scenario export both packages run: its stack and per-observation
# parameters (registry defaults fill the rest)
SCENARIO = ["scintillation", "rfi", "single_pulse:frb"]
SCENARIO_PARAMS = {
    "scint_dnu_d_mhz": np.array([20.0, 60.0, 150.0, 35.0, 90.0], np.float32),
    "scint_dt_d_s": 0.3,
    "rfi_imp_prob": np.array([0.5, 0.0, 0.9, 0.3, 0.6], np.float32),
    "rfi_nb_prob": 0.3, "sp_amp": np.array([4.0, 8.0, 1.0, 2.0, 16.0],
                                           np.float32)}


def _child(out):
    """Reference files from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    from psrsigsim_tpu.io import export_ensemble_psrfits

    os.makedirs(os.path.join(out, "writes"))
    _write_cases("psrsigsim_tpu", os.path.join(out, "writes"))
    ens = _ref_ensemble("psrsigsim_tpu")
    for name, kw in END_TO_END.items():
        export_ensemble_psrfits(ens, N_OBS, os.path.join(out, name), TEMPLATE,
                                ens.pulsar, seed=SEED, chunk_size=2, writers=1,
                                pipeline_depth=0, **kw)
    ens = _ref_ensemble("psrsigsim_tpu", scenario=SCENARIO)
    export_ensemble_psrfits(ens, N_OBS, os.path.join(out, "scenario"),
                            TEMPLATE, ens.pulsar, seed=SEED, chunk_size=2,
                            writers=1, pipeline_depth=0,
                            scenario_params=SCENARIO_PARAMS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_export") / "ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.fixture(autouse=True)
def _threefry(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def port_writes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_export_writes"))
    _write_cases("psrsigsim_torch", out)
    return out


@pytest.fixture(scope="module")
def ens():
    return _ref_ensemble("psrsigsim_torch", device="cpu")


def _export(ens, out, **kw):
    from psrsigsim_torch.io import export_ensemble_psrfits

    args = dict(seed=SEED, chunk_size=2, writers=1)
    args.update(kw)
    return export_ensemble_psrfits(ens, args.pop("n_obs", N_OBS), out,
                                   TEMPLATE, ens.pulsar, **args)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _fits_names(out):
    return sorted(n for n in os.listdir(out) if n.endswith(".fits"))


@pytest.mark.parametrize("name", [w[0] for w in WRITES])
def test_writers_byte_identical_to_reference(ref, port_writes, name):
    """(a), (b): the same triple through the reference's writer and the
    port's gives the same file, byte for byte."""
    want = _read(os.path.join(ref, "writes", name + ".fits"))
    got = _read(os.path.join(port_writes, name + ".fits"))
    assert len(got) == len(want)
    assert got == want


_PAYLOAD = ("DATA", "DAT_SCL", "DAT_OFFS")


def _payload_flips(got_path, want_path):
    """One port file against the reference's: every byte outside SUBINT
    ``DATA``/``DAT_SCL``/``DAT_OFFS`` equal, ``DATA`` within 1 LSB,
    ``DAT_SCL``/``DAT_OFFS`` within rtol 1e-5.  Returns ``(codes that
    differ, codes)`` for the caller's 1% bound."""
    from psrsigsim_torch.io import FitsFile

    n = os.path.basename(got_path)
    got = FitsFile.read(got_path)
    want = FitsFile.read(want_path)
    assert [h.name for h in got.hdus] == [h.name for h in want.hdus]
    flips = total = 0
    for g, w in zip(got.hdus, want.hdus):
        assert g.header.serialize() == w.header.serialize(), (n, g.name)
        if g.data is None:
            assert w.data is None
            continue
        assert g.data.dtype == w.data.dtype
        if g.name != "SUBINT":
            assert np.ascontiguousarray(g.data).tobytes() == \
                np.ascontiguousarray(w.data).tobytes(), (n, g.name)
            continue
        for field in g.data.dtype.names:
            if field not in _PAYLOAD:
                assert g.data[field].tobytes() == w.data[field].tobytes(), \
                    (n, field)
        diff = (g.data["DATA"].astype(np.int32)
                - w.data["DATA"].astype(np.int32))
        assert np.abs(diff).max() <= 1, n
        flips += int((diff != 0).sum())
        total += diff.size
        for field in ("DAT_SCL", "DAT_OFFS"):
            np.testing.assert_allclose(g.data[field], w.data[field],
                                       rtol=1e-5)
    return flips, total


@pytest.mark.parametrize("layout", list(END_TO_END))
def test_export_matches_reference_end_to_end(ref, ens, tmp_path, layout):
    """(c): the port's export of the same seed against the reference's."""
    out = str(tmp_path / layout)
    _export(ens, out, **END_TO_END[layout])
    names = _fits_names(out)
    assert names == _fits_names(os.path.join(ref, layout))
    assert len(names) == (N_OBS if layout == "per_file" else 3)
    flips = total = 0
    for n in names:
        f, t = _payload_flips(os.path.join(out, n),
                              os.path.join(ref, layout, n))
        flips += f
        total += t
    assert flips <= 1e-2 * total


@pytest.fixture(scope="module")
def baseline(ens, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_export_base"))
    _export(ens, out, pipeline_depth=0, chunk_size=2)
    return out


def _same_files(a, b):
    assert _fits_names(a) == _fits_names(b)
    for n in _fits_names(a):
        assert _read(os.path.join(a, n)) == _read(os.path.join(b, n)), n


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("chunk", [2, 3])
def test_export_invariant_to_depth_and_chunk(ens, baseline, tmp_path, depth,
                                             chunk):
    """(d): the same bytes at every pipeline depth and chunk size."""
    out = str(tmp_path / "x")
    _export(ens, out, pipeline_depth=depth, chunk_size=chunk)
    _same_files(out, baseline)


def test_export_writer_pool_equals_serial(ens, baseline, tmp_path):
    """(d): a pool of two spawn writers writes the serial writer's bytes,
    per file and packed."""
    out = str(tmp_path / "pool")
    _export(ens, out, writers=2, pipeline_depth=2, chunk_size=3)
    _same_files(out, baseline)
    serial = str(tmp_path / "packed_serial")
    pooled = str(tmp_path / "packed_pool")
    _export(ens, serial, obs_per_file=2)
    _export(ens, pooled, obs_per_file=2, writers=2)
    _same_files(pooled, serial)


POOL_FAULTS = {
    # a worker SIGKILLed mid-batch: the pool respawns and resubmits
    "crash_respawn": ({"writer.crash": {"match": "obs_00000", "times": 1}},
                      "writer pool died"),
    # three deaths in a row: the rest is written in-process
    "crash_degrade": ({"writer.crash": {"match": "obs_00000", "times": 3}},
                      "degrading to the in-process serial writer"),
    # a failed shared-memory attach: the one batch is retried
    "shm_attach": ({"shm.attach": {"times": 1}}, "writer job batch failed"),
}


@pytest.mark.parametrize("fault", list(POOL_FAULTS))
def test_writer_pool_heals_and_writes_the_same_bytes(ens, baseline, tmp_path,
                                                     fault):
    """The pool outlives its workers: after a crash, repeated crashes or a
    failed attach the export warns, finishes and writes the serial bytes."""
    import warnings

    from psrsigsim_torch.runtime import FaultPlan

    spec, warning = POOL_FAULTS[fault]
    plan = FaultPlan(str(tmp_path / "plan"), spec)
    out = str(tmp_path / "out")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _export(ens, out, writers=2, chunk_size=3, faults=plan)
    point = next(iter(spec))
    assert plan.shots_fired(point) == spec[point]["times"]
    assert any(warning in str(w.message) for w in caught)
    _same_files(out, baseline)
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]


def _count_chunks(monkeypatch, ens):
    calls = []
    real = type(ens)._quantized_packed

    def counted(self, keys, *a, **k):
        calls.append(int(keys.shape[0]))
        return real(self, keys, *a, **k)

    monkeypatch.setattr(type(ens), "_quantized_packed", counted)
    return calls


@pytest.mark.parametrize("layout", list(END_TO_END))
def test_resume_rewrites_only_missing_files(ens, baseline, tmp_path,
                                            monkeypatch, layout):
    """(e): deleted files come back byte-identical; the others are not
    rewritten, and only the chunks holding a missing file are computed."""
    out = str(tmp_path / "r")
    kw = END_TO_END[layout]
    paths = _export(ens, out, **kw)
    first = {p: _read(p) for p in paths}
    victim = paths[-1]
    os.unlink(victim)
    stamps = {p: os.stat(p).st_mtime_ns for p in paths if p != victim}
    calls = _count_chunks(monkeypatch, ens)
    again = _export(ens, out, **kw)
    assert again == paths
    # chunk size 2 over 5 observations: only the last chunk holds the
    # missing file
    assert calls == [2]
    for p in paths:
        assert _read(p) == first[p]
        if p != victim:
            assert os.stat(p).st_mtime_ns == stamps[p]
    if layout == "per_file":
        _same_files(out, baseline)
    del calls[:]
    _export(ens, out, **kw)
    assert calls == []  # nothing missing: no chunk is computed
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]


@pytest.mark.parametrize("change", ["seed", "template_sha256"])
def test_resume_refuses_a_different_export(ens, tmp_path, change):
    """(e): resuming with another seed or template raises, naming the
    field; resume=False starts over."""
    from psrsigsim_torch.io import ExportManifestError

    out = str(tmp_path / "m")
    _export(ens, out, n_obs=2)
    kw = {}
    if change == "seed":
        kw["seed"] = SEED + 1
    else:
        tmpl = str(tmp_path / "edited.sm")
        shutil.copy(TEMPLATE, tmpl)
        from psrsigsim_torch.io import FitsFile

        f = FitsFile.read(tmpl)
        f["PRIMARY"].header["OBSERVER"] = "someone else"
        f.write(tmpl)
        kw["template"] = tmpl
    with pytest.raises(ExportManifestError) as err:
        _export_with(ens, out, n_obs=2, **kw)
    assert set(err.value.mismatches) == {change}
    assert change in str(err.value)
    _export_with(ens, out, n_obs=2, resume=False, **kw)


def _export_with(ens, out, template=TEMPLATE, **kw):
    from psrsigsim_torch.io import export_ensemble_psrfits

    args = dict(seed=SEED, chunk_size=2, writers=1)
    args.update(kw)
    return export_ensemble_psrfits(ens, args.pop("n_obs"), out, template,
                                   ens.pulsar, **args)


@pytest.mark.parametrize("option", ["pod"])
def test_unported_options_raise(ens, tmp_path, option):
    """(f): a pod follower's export mirror outside a pod raises instead of
    being ignored (the pod itself: tests/test_torch_pod_groups.py)."""
    from psrsigsim_torch.io.export import pod_export_follower

    out = str(tmp_path / "u")
    with pytest.raises(RuntimeError, match="requires an initialized pod"):
        pod_export_follower(ens, N_OBS, out, seed=SEED)
    assert not os.path.exists(out)


def _manifest(out):
    import json

    with open(os.path.join(out, "export_manifest.json")) as fh:
        return json.load(fh)


def test_scenario_export_matches_reference(ref, tmp_path):
    """A scenario export of the same seed and parameters: the files within
    the end-to-end bound, the manifest's scenario fingerprint equal."""
    scen = _ref_ensemble("psrsigsim_torch", device="cpu", scenario=SCENARIO)
    out = str(tmp_path / "scenario")
    _export(scen, out, scenario_params=SCENARIO_PARAMS)
    want = os.path.join(ref, "scenario")
    assert _fits_names(out) == _fits_names(want)
    flips = total = 0
    for n in _fits_names(out):
        f, t = _payload_flips(os.path.join(out, n), os.path.join(want, n))
        flips += f
        total += t
    assert flips <= 1e-2 * total
    mg, mw = _manifest(out), _manifest(want)
    assert mg["scenario"] == mw["scenario"] == \
        "scintillation+rfi+single_pulse:frb"
    for field in ("scenario_params_sha256", "n_obs", "seed", "dms_sha256",
                  "template_sha256"):
        assert mg[field] == mw[field], field


def test_scenario_export_fingerprint_guards_resume(ens, tmp_path):
    """Resuming a scenario export with other parameters is refused; the
    registry default passed explicitly hashes like omitting it; a
    scenario-free ensemble refuses scenario parameters."""
    from psrsigsim_torch.io import ExportManifestError

    scen = _ref_ensemble("psrsigsim_torch", device="cpu", scenario=["rfi"])
    out = str(tmp_path / "s")
    _export(scen, out, n_obs=2, scenario_params={"rfi_imp_prob": 0.5})
    _export(scen, out, n_obs=2, scenario_params={"rfi_imp_prob": 0.5,
                                                 "rfi_nb_snr": 3.0})
    with pytest.raises(ExportManifestError, match="scenario_params_sha256"):
        _export(scen, out, n_obs=2, scenario_params={"rfi_imp_prob": 0.4})
    with pytest.raises(ValueError, match="without a scenario"):
        _export(ens, str(tmp_path / "free"), n_obs=2,
                scenario_params={"rfi_imp_prob": 0.5})
    assert _manifest(out)["scenario"] == "rfi"


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise AssertionError(f"pickled writer state holds {module}.{name}")
        return super().find_class(module, name)


def test_writer_state_holds_no_tensor(ens, tmp_path, monkeypatch):
    """(g): what the spawn writers unpickle holds no tensor (a worker must
    never touch the card)."""
    import io

    from psrsigsim_torch.io import export

    payloads = []

    class Capture:
        def __init__(self, n, payload, *a, **k):
            payloads.append(payload)
            raise RuntimeError("captured")

    monkeypatch.setattr(export, "_WriterPool", Capture)
    with pytest.warns(RuntimeWarning, match="writer pool unavailable"):
        _export(ens, str(tmp_path / "g"), n_obs=2, writers=4)
    assert len(payloads) == 1
    state = _NoTorch(io.BytesIO(payloads[0])).load()
    assert {"sig", "pulsar", "template", "parfile"} <= set(state)
    assert "timers" not in state


def test_writer_process_never_imports_torch(ens, tmp_path, monkeypatch):
    """A spawn writer starts from the pickled state in shared memory and
    writes a file without importing torch: its start-up stays a fraction of
    a second, and nothing in it can reach the card."""
    from psrsigsim_torch.io import export

    payloads = []

    class Capture:
        def __init__(self, n, payload, *a, **k):
            payloads.append(payload)
            raise RuntimeError("captured")

    monkeypatch.setattr(export, "_WriterPool", Capture)
    with pytest.warns(RuntimeWarning, match="writer pool unavailable"):
        _export(ens, str(tmp_path / "w"), n_obs=2, writers=4)
    blob = str(tmp_path / "state.pkl")
    with open(blob, "wb") as f:
        f.write(payloads[0])
    cfg = ens.cfg
    code = f"""
import sys
import numpy as np
from multiprocessing import shared_memory
from psrsigsim_torch.io import export
payload = open({blob!r}, 'rb').read()
shm = shared_memory.SharedMemory(create=True, size=len(payload))
shm.buf[:len(payload)] = payload
try:
    export._writer_init(shm.name, len(payload))
finally:
    shm.close()
    shm.unlink()
r = np.random.default_rng(0)
shape = ({cfg.nsub}, {cfg.meta.nchan})
triple = (r.integers(-9, 9, shape + ({cfg.nph},)).astype('>i2'),
          np.ones(shape, np.float32), np.zeros(shape, np.float32))
for name in ('a.fits', 'b.fits'):  # the full assembly, then the fast writer
    export._write_obs(export._worker_state, {str(tmp_path)!r} + '/' + name,
                      triple, None)
assert 'torch' not in sys.modules, 'a writer imported torch'
print('clean')
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("clean")
    assert os.path.getsize(str(tmp_path / "b.fits")) == \
        os.path.getsize(str(tmp_path / "a.fits"))


@pytest.mark.cuda
def test_export_on_card_equals_run_quantized(tmp_path):
    """One small export on the card: the files hold run_quantized's
    triples bit for bit, through the copy stream and the fetch thread,
    with one fused-kernel launch per chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.io import FitsFile
    from psrsigsim_torch.ops import fold_quantize as fq

    card = _ref_ensemble("psrsigsim_torch", device="cuda")
    fq.fold_quantize.launches = 0
    paths = _export(card, str(tmp_path / "card"), chunk_size=2,
                    pipeline_depth=2, writers=1)
    assert fq.fold_quantize.launches == 3
    d, s, o = (t.cpu().numpy() for t in card.run_quantized(N_OBS, seed=SEED))
    for i, p in enumerate(paths):
        sub = FitsFile.read(p)["SUBINT"].data
        np.testing.assert_array_equal(sub["DATA"][:, 0], d[i])
        np.testing.assert_array_equal(sub["DAT_SCL"], s[i])
        np.testing.assert_array_equal(sub["DAT_OFFS"], o[i])


if __name__ == "__main__":
    _child(sys.argv[1])
