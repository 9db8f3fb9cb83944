"""The port's supervised export against the JAX package's, on the CPU.

Small geometry of tests/test_torch_export.py (4 channels, 1024 bins,
2 x 0.5 s subints, the B1855+09 template), 5 observations in chunks of 2,
one in-process writer, the threefry sampler.  Tolerances and why:

* salted keys (``FoldEnsemble._prep_chunk(fold_salt=)``): the same jax
  threefry words — bit for bit.
* ``run_quantized_at(idx)`` against the port's own main pass: bit for bit
  (chunk invariance: keys come from global ids).
* ``run_quantized_at(idx, fold_salt=s)`` and the finite mask against the
  JAX package's: codes within 1 LSB on at most 1% of entries, DAT_SCL and
  DAT_OFFS within rtol 1e-5 (the export's end-to-end bound of
  tests/test_torch_export.py: the two FFT
  libraries differ by ulps); the finite mask equal.
* the supervised export against the JAX package's, same seed, for a clean
  run, ``nan.obs`` with one observation per file and in a packed group
  (``obs_per_file=3``), and ``retry=False``: files within that bound;
  the journal's records (event kinds, observation ids, groups, order)
  equal apart from sha256 values; the manifest's ``quarantined`` and the
  run result's retried/recovered lists equal.
* the supervised export of a scenario ensemble (scintillation, RFI and FRB
  energies; tests/test_torch_export.py's stack and parameters), clean, with
  ``nan.obs`` and with ``retry=False``: files within that bound; the
  journal's ``rfi`` / ``rfi_retry`` records (observations and contaminated
  cell counts) and the manifest's ``"rfi"`` block equal, exactly.
* the port against itself (supervised vs unsupervised, SIGKILL then
  ``resume=True`` / ``resume="verify"`` — with a scenario too, whose RFI
  records survive the kill — ``file.partial`` then verify, verify of a
  corrupted file, the writer pool): byte for byte.

Reference results come from a child process (this file run as a script)
that applies the JAX-version shim (R1) the reference ensemble needs, with
one XLA CPU device so its chunking is the port's.  A process that must die
(``run.kill``, ``file.partial``) is this file run as a script with the
port.
"""

import json
import os
import shutil
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

N_OBS = 5
CHUNK = 2
SEED = 4
# supervised exports run by both packages: name -> (export kwargs, fault
# spec, retry)
EXPORTS = {
    "clean": ({}, None, True),
    "nan": ({}, {"nan.obs": {"indices": [1, 3]}}, True),
    "packed": (dict(obs_per_file=3), {"nan.obs": {"indices": [1]}}, True),
    "noretry": ({}, {"nan.obs": {"indices": [1]}}, False),
}
# supervised exports of the scenario ensemble run by both packages
SCEN_EXPORTS = {
    "scen_clean": (None, True),
    "scen_nan": ({"nan.obs": {"indices": [1, 3]}}, True),
    "scen_noretry": ({"nan.obs": {"indices": [2]}}, False),
}
SALTS = (None, 5, 0x7E7247)
RETRY_IDX = [1, 3]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY"):
        env.pop(k, None)
    env.update(extra)
    return env


def _result(res):
    return {"quarantined": res.quarantined, "retried": res.retried,
            "recovered": res.recovered, "n_paths": len(res.paths)}


def _child(out):
    """Reference results from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    import jax

    from psrsigsim_tpu.runtime import FaultPlan, supervised_export
    from test_torch_export import TEMPLATE, _ref_ensemble

    ens = _ref_ensemble("psrsigsim_tpu")
    res = {}
    idx = np.arange(N_OBS)
    for salt in SALTS:
        keys = ens._prep_chunk(idx, SEED, None, None, fold_salt=salt)[0]
        res[f"keys_{salt}"] = np.asarray(jax.random.key_data(keys))
    d, s, o, f = ens.run_quantized_at(RETRY_IDX, seed=SEED, fold_salt=0x7E7247)
    res["salted"] = [np.asarray(a) for a in (d, s, o, f)]
    norms = np.full(3, ens.noise_norm)
    norms[1] = np.nan
    res["nan_finite"] = np.asarray(
        ens.run_quantized_at([0, 1, 2], seed=SEED, noise_norms=norms)[3])
    np.savez(os.path.join(out, "ref.npz"),
             **{k: v for k, v in res.items() if k != "salted"},
             **{f"salted_{i}": a for i, a in enumerate(res["salted"])})
    results = {}
    for name, (kw, spec, retry) in EXPORTS.items():
        plan = None
        if spec is not None:
            plan = FaultPlan(os.path.join(out, name + "_plan"), spec)
        r = supervised_export(ens, N_OBS, os.path.join(out, name), TEMPLATE,
                              ens.pulsar, seed=SEED, chunk_size=CHUNK,
                              writers=1, faults=plan, retry=retry, **kw)
        results[name] = _result(r)
    from test_torch_export import SCENARIO, SCENARIO_PARAMS

    scen = _ref_ensemble("psrsigsim_tpu", scenario=SCENARIO)
    for name, (spec, retry) in SCEN_EXPORTS.items():
        plan = None
        if spec is not None:
            plan = FaultPlan(os.path.join(out, name + "_plan"), spec)
        r = supervised_export(scen, N_OBS, os.path.join(out, name), TEMPLATE,
                              scen.pulsar, seed=SEED, chunk_size=CHUNK,
                              writers=1, faults=plan, retry=retry,
                              scenario_params=SCENARIO_PARAMS)
        results[name] = _result(r)
    with open(os.path.join(out, "results.json"), "w") as fh:
        json.dump(results, fh)


def _port_child(out, plan_json, resume):
    """A port export that is meant to die (run in a child process)."""
    from psrsigsim_torch.runtime import FaultPlan
    from test_torch_export import SCENARIO, SCENARIO_PARAMS, _ref_ensemble

    with open(plan_json) as fh:
        spec = json.load(fh)
    kw = {}
    if spec.get("scenario"):
        ens = _ref_ensemble("psrsigsim_torch", device="cpu",
                            scenario=SCENARIO)
        kw["scenario_params"] = SCENARIO_PARAMS
    else:
        ens = _ref_ensemble("psrsigsim_torch", device="cpu")
    _supervised(ens, out, faults=FaultPlan(spec["scratch_dir"], spec["spec"]),
                resume=resume, **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_supervisor") / "ref")
    os.makedirs(out)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(os.path.join(out, "ref.npz")) as z:
        arrays = dict(z)
    with open(os.path.join(out, "results.json")) as fh:
        results = json.load(fh)
    return out, arrays, results


@pytest.fixture(autouse=True)
def _threefry(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def ens():
    from test_torch_export import _ref_ensemble

    return _ref_ensemble("psrsigsim_torch", device="cpu")


def _supervised(ens, out, **kw):
    from psrsigsim_torch.runtime import supervised_export
    from test_torch_export import TEMPLATE

    args = dict(seed=SEED, chunk_size=CHUNK, writers=1)
    args.update(kw)
    return supervised_export(ens, N_OBS, out, TEMPLATE, ens.pulsar, **args)


def _fits(out):
    return sorted(n for n in os.listdir(out) if n.endswith(".fits"))


def _bytes(out):
    res = {}
    for n in _fits(out):
        with open(os.path.join(out, n), "rb") as fh:
            res[n] = fh.read()
    return res


def _journal(out):
    with open(os.path.join(out, "run_journal.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _manifest(out):
    with open(os.path.join(out, "export_manifest.json")) as fh:
        return json.load(fh)


def _without_hashes(records):
    return [{k: (sorted(v) if k == "files" else v) for k, v in r.items()}
            for r in records]


def _codes_close(got, want):
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-2


# -- keys and the retry primitive ---------------------------------------------


@pytest.mark.parametrize("salt", SALTS)
def test_salted_keys_equal_reference(ref, ens, salt):
    keys, _, _ = ens._prep_chunk(np.arange(N_OBS), SEED, None, None,
                                 fold_salt=salt)
    np.testing.assert_array_equal(keys.numpy(),
                                  ref[1][f"keys_{salt}"].astype(np.int64))


def test_run_quantized_at_equals_the_main_pass(ens):
    """The retry primitive with no salt reproduces the main pass bit for
    bit, in the order given (what keeps rewrites byte-identical)."""
    d0, s0, o0 = ens.run_quantized(N_OBS, seed=SEED)
    d1, s1, o1, f1 = ens.run_quantized_at([3, 1, 4], seed=SEED)
    assert bool(f1.all())
    for k, i in enumerate((3, 1, 4)):
        assert torch.equal(d1[k], d0[i])
        assert torch.equal(s1[k], s0[i]) and torch.equal(o1[k], o0[i])
    with pytest.raises(ValueError):
        ens.run_quantized_at([], seed=SEED)


def test_salted_run_matches_reference(ref, ens):
    d, s, o, f = (a.numpy() for a in ens.run_quantized_at(
        RETRY_IDX, seed=SEED, fold_salt=0x7E7247))
    want = [ref[1][f"salted_{i}"] for i in range(4)]
    _codes_close(d, want[0])
    np.testing.assert_allclose(s, want[1], rtol=1e-5)
    np.testing.assert_allclose(o, want[2], rtol=1e-5)
    np.testing.assert_array_equal(f, want[3])
    plain = ens.run_quantized_at(RETRY_IDX, seed=SEED)[0].numpy()
    assert not np.array_equal(plain, d)   # a fresh stream


def test_nan_norm_flags_exactly_that_observation(ref, ens):
    norms = np.full(3, ens.noise_norm)
    norms[1] = np.nan
    finite = ens.run_quantized_at([0, 1, 2], seed=SEED,
                                  noise_norms=norms)[3].numpy()
    np.testing.assert_array_equal(finite, ref[1]["nan_finite"])
    assert finite[0].all() and finite[2].all() and not finite[1].any()


def test_digest_rides_run_quantized_at(ens):
    from psrsigsim_torch.runtime.integrity import triple_digest_rows

    d, s, o, _, dig = ens.run_quantized_at([2, 0], seed=SEED,
                                           byte_order="big",
                                           return_digest=True)
    np.testing.assert_array_equal(
        triple_digest_rows(d.numpy(), s.numpy(), o.numpy()),
        dig.numpy().view(np.uint32))


# -- the supervised export against the JAX package's --------------------------


@pytest.fixture(scope="module")
def port_exports(ens, tmp_path_factory):
    from psrsigsim_torch.runtime import FaultPlan

    base = tmp_path_factory.mktemp("port_supervised")
    results = {}
    for name, (kw, spec, retry) in EXPORTS.items():
        plan = None
        if spec is not None:
            plan = FaultPlan(str(base / (name + "_plan")), spec)
        r = _supervised(ens, str(base / name), faults=plan, retry=retry, **kw)
        results[name] = _result(r)
    return str(base), results


@pytest.mark.parametrize("name", list(EXPORTS))
def test_supervised_export_matches_reference(ref, port_exports, name):
    from test_torch_export import _payload_flips

    ref_dir, _, ref_results = ref
    base, results = port_exports
    got, want = os.path.join(base, name), os.path.join(ref_dir, name)
    assert results[name] == ref_results[name]
    assert _fits(got) == _fits(want)
    flips = total = 0
    for n in _fits(got):
        f, t = _payload_flips(os.path.join(got, n), os.path.join(want, n))
        flips += f
        total += t
    assert flips <= 1e-2 * total
    assert _without_hashes(_journal(got)) == _without_hashes(_journal(want))
    mg, mw = _manifest(got), _manifest(want)
    assert mg["quarantined"] == mw["quarantined"]
    assert sorted(mg["files"]) == sorted(mw["files"])


@pytest.fixture(scope="module")
def scen():
    from test_torch_export import SCENARIO, _ref_ensemble

    return _ref_ensemble("psrsigsim_torch", device="cpu", scenario=SCENARIO)


@pytest.fixture(scope="module")
def scen_exports(scen, tmp_path_factory):
    from psrsigsim_torch.runtime import FaultPlan
    from test_torch_export import SCENARIO_PARAMS

    base = tmp_path_factory.mktemp("port_scenario_supervised")
    results = {}
    for name, (spec, retry) in SCEN_EXPORTS.items():
        plan = None
        if spec is not None:
            plan = FaultPlan(str(base / (name + "_plan")), spec)
        r = _supervised(scen, str(base / name), faults=plan, retry=retry,
                        scenario_params=SCENARIO_PARAMS)
        results[name] = _result(r)
    return str(base), results


def _rfi_records(out):
    return [r for r in _journal(out) if r["e"] in ("rfi", "rfi_retry")]


@pytest.mark.parametrize("name", list(SCEN_EXPORTS))
def test_scenario_export_matches_reference(ref, scen_exports, name):
    """The RFI provenance of a supervised scenario export — journal records
    and the manifest's ``"rfi"`` block — equals the JAX package's exactly;
    the files within the end-to-end bound."""
    from test_torch_export import _payload_flips

    ref_dir, _, ref_results = ref
    base, results = scen_exports
    got, want = os.path.join(base, name), os.path.join(ref_dir, name)
    assert results[name] == ref_results[name]
    assert _fits(got) == _fits(want)
    flips = total = 0
    for n in _fits(got):
        f, t = _payload_flips(os.path.join(got, n), os.path.join(want, n))
        flips += f
        total += t
    assert flips <= 1e-2 * total
    assert _without_hashes(_journal(got)) == _without_hashes(_journal(want))
    assert _rfi_records(got)
    mg, mw = _manifest(got), _manifest(want)
    assert mg["rfi"] == mw["rfi"]
    assert mg["quarantined"] == mw["quarantined"]
    for field in ("scenario", "scenario_params_sha256"):
        assert mg[field] == mw[field]


def test_scenario_sigkill_then_resume_keeps_rfi_records(scen, scen_exports,
                                                        tmp_path,
                                                        monkeypatch):
    """A scenario export SIGKILLed after chunk 0's commit: the resumed run
    computes only the missing chunks, writes the clean run's bytes, and its
    journal and manifest carry the clean run's RFI provenance (chunk 0's
    records replayed from the journal)."""
    from test_torch_export import SCENARIO_PARAMS, _count_chunks

    clean = os.path.join(scen_exports[0], "scen_clean")
    out = str(tmp_path / "out")
    _die(tmp_path, out, {"run.kill": {"after_start": 0}}, scenario=True)
    assert [r["e"] for r in _journal(out)] == ["rfi", "commit"]
    calls = _count_chunks(monkeypatch, scen)
    _supervised(scen, out, resume="verify", scenario_params=SCENARIO_PARAMS)
    assert calls == [CHUNK, CHUNK]
    assert _bytes(out) == _bytes(clean)
    assert _rfi_records(out) == _rfi_records(clean)
    assert _manifest(out)["rfi"] == _manifest(clean)["rfi"]


def test_quarantine_outcomes(port_exports):
    """nan.obs: the observations are quarantined, retried with a salted
    key and recovered; untouched files equal the clean run's; a packed
    group re-runs its healthy members with their original keys; with
    retry off the observation stays quarantined and its file unwritten."""
    base, results = port_exports
    assert results["nan"]["retried"] == [1, 3]
    assert results["nan"]["recovered"] == [1, 3]
    assert results["packed"]["recovered"] == [1]
    assert results["noretry"] == {"quarantined": [1], "retried": [],
                                  "recovered": [], "n_paths": N_OBS}
    clean = _bytes(os.path.join(base, "clean"))
    nan = _bytes(os.path.join(base, "nan"))
    for n in clean:
        same = clean[n] == nan[n]
        assert same == (n not in ("obs_00001.fits", "obs_00003.fits")), n
    noretry = _bytes(os.path.join(base, "noretry"))
    assert "obs_00001.fits" not in noretry
    assert all(noretry[n] == clean[n] for n in noretry)
    assert _manifest(os.path.join(base, "noretry"))["quarantined"] == [1]


def test_salted_retry_files_hold_run_quantized_at(ens, port_exports):
    from psrsigsim_torch.io import FitsFile

    base, _ = port_exports
    d, s, o, _ = ens.run_quantized_at(RETRY_IDX, seed=SEED, byte_order="big",
                                      fold_salt=0x7E7247)
    for k, i in enumerate(RETRY_IDX):
        sub = FitsFile.read(os.path.join(base, "nan", f"obs_{i:05d}.fits"))
        sub = sub["SUBINT"].data
        assert sub["DATA"][:, 0].tobytes() == d[k].numpy().tobytes()
        np.testing.assert_array_equal(sub["DAT_SCL"], s[k].numpy())
        np.testing.assert_array_equal(sub["DAT_OFFS"], o[k].numpy())


# -- the port against itself ---------------------------------------------------


@pytest.fixture(scope="module")
def clean(port_exports):
    return _bytes(os.path.join(port_exports[0], "clean"))


def test_supervised_bytes_equal_unsupervised(ens, clean, tmp_path):
    from psrsigsim_torch.io import export_ensemble_psrfits
    from test_torch_export import TEMPLATE

    out = str(tmp_path / "plain")
    export_ensemble_psrfits(ens, N_OBS, out, TEMPLATE, ens.pulsar, seed=SEED,
                            chunk_size=CHUNK, writers=1)
    assert _bytes(out) == clean
    assert not os.path.exists(os.path.join(out, "run_journal.jsonl"))


def test_journal_and_manifest_record_true_hashes(port_exports):
    import hashlib

    out = os.path.join(port_exports[0], "clean")
    man = _manifest(out)
    for n, data in _bytes(out).items():
        assert man["files"][n] == hashlib.sha256(data).hexdigest()
    commits = [r for r in _journal(out) if r["e"] == "commit"]
    assert [(r["kind"], r["ident"]) for r in commits] == \
        [("chunk", 0), ("chunk", 2), ("chunk", 4)]
    with open(os.path.join(out, "run_cursor.json")) as fh:
        cursor = json.load(fh)
    assert cursor["commits"] == 3
    assert cursor["journal_bytes"] == os.path.getsize(
        os.path.join(out, "run_journal.jsonl"))


def test_writer_pool_commits_in_order_and_writes_the_same_bytes(ens, clean,
                                                                tmp_path):
    out = str(tmp_path / "pool")
    _supervised(ens, out, writers=2, chunk_size=3)
    assert _bytes(out) == clean
    commits = [r for r in _journal(out) if r["e"] == "commit"]
    assert [r["ident"] for r in commits] == [0, 3]
    assert sorted(f for r in commits for f in r["files"]) == sorted(clean)


def _die(tmp_path, out, spec, resume="true", scenario=False):
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as fh:
        json.dump({"scratch_dir": str(tmp_path / "scratch"), "spec": spec,
                   "scenario": scenario}, fh)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--port", out, plan,
         resume], env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode in (-9, 137), (proc.returncode, proc.stderr[-3000:])


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """An export SIGKILLed right after chunk 0's journal commit."""
    tmp = tmp_path_factory.mktemp("killed")
    out = str(tmp / "out")
    _die(tmp, out, {"run.kill": {"after_start": 0}})
    return out


@pytest.mark.parametrize("mode", [True, "verify"])
def test_sigkill_then_resume_is_byte_identical(ens, clean, killed, tmp_path,
                                               monkeypatch, mode):
    from test_torch_export import _count_chunks

    out = str(tmp_path / "resumed")
    shutil.copytree(killed, out)
    assert _fits(out) == ["obs_00000.fits", "obs_00001.fits"]
    assert [r["e"] for r in _journal(out)] == ["commit"]
    calls = _count_chunks(monkeypatch, ens)
    _supervised(ens, out, resume=mode)
    assert calls == [CHUNK, CHUNK]   # chunk 0 is not computed again
    assert _bytes(out) == clean
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]


def test_file_partial_then_verify_is_byte_identical(ens, clean, tmp_path):
    out = str(tmp_path / "partial")
    _die(tmp_path, out, {"file.partial": {"match": "obs_00003"}})
    assert os.path.exists(os.path.join(out, "obs_00003.fits.tmp"))
    assert "obs_00003.fits" not in _fits(out)
    _supervised(ens, out, resume="verify")
    assert _bytes(out) == clean


def test_verify_rewrites_a_corrupted_file(ens, clean, tmp_path):
    out = str(tmp_path / "v")
    res = _supervised(ens, out)
    with open(res.paths[1], "wb") as fh:
        fh.write(clean["obs_00001.fits"][:128])   # right name, wrong bytes
    keep = os.stat(res.paths[0]).st_mtime_ns
    _supervised(ens, out, resume="verify")
    assert _bytes(out) == clean
    assert os.stat(res.paths[0]).st_mtime_ns == keep   # others untouched


def test_plain_resume_trusts_existence(ens, tmp_path):
    out = str(tmp_path / "nv")
    res = _supervised(ens, out)
    with open(res.paths[1], "wb") as fh:
        fh.write(b"garbage")
    _supervised(ens, out)
    with open(res.paths[1], "rb") as fh:
        assert fh.read() == b"garbage"


def test_verify_without_supervision_raises(ens, tmp_path):
    from psrsigsim_torch.io import export_ensemble_psrfits
    from test_torch_export import TEMPLATE

    with pytest.raises(ValueError, match="verify"):
        export_ensemble_psrfits(ens, 2, str(tmp_path / "x"), TEMPLATE,
                                ens.pulsar, resume="verify")


def test_supervisor_extras_survive_a_matching_resume(ens, tmp_path):
    out = str(tmp_path / "x")
    _supervised(ens, out)
    first = _manifest(out)
    os.unlink(os.path.join(out, "obs_00004.fits"))
    _supervised(ens, out)
    again = _manifest(out)
    assert again["files"] == first["files"]
    assert again["quarantined"] == []


def test_journal_replay_tolerates_a_torn_tail(tmp_path):
    from psrsigsim_torch.runtime import RunSupervisor

    out = str(tmp_path / "j")
    os.makedirs(out)
    jpath = os.path.join(out, "run_journal.jsonl")
    good = json.dumps({"e": "commit", "kind": "chunk", "ident": 0,
                       "files": {"obs_00000.fits": "aa"}}) + "\n"
    with open(jpath, "w") as fh:
        fh.write(good)
        fh.write('{"e": "commit", "files": {"obs_00001.fits"')  # torn
    sup = RunSupervisor(out, resume=True, verify=True)
    assert sup._hashes == {"obs_00000.fits": "aa"}
    # truncated away, so this run's appends start on a fresh line
    with open(jpath) as fh:
        assert fh.read() == good
    sup.chunk_committed(("chunk", 1, ["obs_00001.fits"]),
                        [("obs_00001.fits", "bb")])
    sup.close()
    sup2 = RunSupervisor(out, resume=True, verify=True)
    assert sup2._hashes == {"obs_00000.fits": "aa", "obs_00001.fits": "bb"}


def test_journal_loader_rules(tmp_path):
    from psrsigsim_torch.runtime import (load_chunk_journal,
                                         load_journal_records)

    path = str(tmp_path / "j.jsonl")
    assert load_journal_records(path) == ([], 0)
    lines = [json.dumps({"e": "chunk", "start": 0}) + "\n", "not json\n",
             json.dumps({"e": "chunk", "start": 4}) + "\n"]
    with open(path, "w") as fh:
        fh.writelines(lines)
    recs, end = load_journal_records(path)
    assert recs == [{"e": "chunk", "start": 0}] and end == len(lines[0])
    with open(path, "w") as fh:
        fh.write(lines[0] + json.dumps({"e": "other", "start": 2}) + "\n")
    assert list(load_chunk_journal(path)) == [0]


def test_chunk_journal_commit_bytes(tmp_path, monkeypatch):
    """The chunk journal every producer commits through: the line bytes,
    the fsync'd cursor, and each producer's kill point firing only right
    after the commit its ``after_start`` names."""
    from psrsigsim_torch.runtime import FaultPlan, journal

    syncs, kills = [], []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (syncs.append(fd), real_fsync(fd)))
    monkeypatch.setattr(journal, "crash_process", lambda: kills.append(1))
    jpath, cpath = str(tmp_path / "j.jsonl"), str(tmp_path / "c.json")
    plan = FaultPlan(str(tmp_path / "plan"), {
        "run.kill": {"after_start": 3}, "mc.kill": {"after_start": 8},
        "dataset.kill": {"after_start": 4}})
    j = journal.ChunkJournal(jpath, cpath, faults=plan)
    assert not os.path.exists(jpath)   # opens at the first record
    j.append({"e": "integrity", "start": 0})
    assert len(syncs) == 1
    j.commit({"start": 0, "e": "chunk", "count": 4})
    assert len(syncs) == 3   # the line, then the cursor's temp file
    lines = [b'{"e": "integrity", "start": 0}\n',
             b'{"count": 4, "e": "chunk", "start": 0}\n']
    with open(jpath, "rb") as fh:
        assert fh.read() == b"".join(lines)
    with open(cpath, "rb") as fh:
        assert fh.read() == (b'{"commits": 1, "journal_bytes": %d}'
                             % sum(map(len, lines)))
    assert not os.path.exists(cpath + ".tmp")

    def fired(point, ident, **kw):
        before = len(kills)
        j.maybe_kill(point, ident, **kw)
        return len(kills) > before

    assert not fired("mc.kill", 0) and not fired("dataset.kill", 0)
    assert not fired("run.kill", 3, targetable=False)  # a retry commit
    assert not fired("run.kill", [1, 2])
    assert fired("run.kill", [2, 3])   # a packed export's group batch
    assert not fired("run.kill", 3)    # once
    assert fired("dataset.kill", 4) and fired("mc.kill", 8)
    j.close()
    j.close()
    journal.ChunkJournal(jpath, cpath).maybe_kill("mc.kill", 8)
    assert len(kills) == 3

def test_resume_false_resets_journal_and_cursor(tmp_path):
    from psrsigsim_torch.runtime import RunSupervisor

    out = str(tmp_path / "r")
    os.makedirs(out)
    for name in ("run_journal.jsonl", "run_cursor.json"):
        with open(os.path.join(out, name), "w") as fh:
            fh.write("stale")
    RunSupervisor(out, resume=False)
    assert not os.path.exists(os.path.join(out, "run_journal.jsonl"))
    assert not os.path.exists(os.path.join(out, "run_cursor.json"))


def test_fault_plan_names_the_export_points(tmp_path):
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.runtime.faults import POINTS

    for point in ("nan.obs", "run.kill", "mc.kill", "dataset.kill",
                  "serve.kill", "serve.reject", "cache.contend",
                  "cache.enospc", "replica.slow", "device.sdc",
                  "host.corrupt", "disk.bitrot", "replica.kill",
                  "route.blackhole", "pod.kill"):
        assert point in POINTS
        FaultPlan(str(tmp_path), {point: {}})
    # a typo never silently disarms a fault test
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultPlan(str(tmp_path), {"pod.kil": {}})


_VML_PROBE = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(2)
VML = {torch.sin, torch.cos, torch.exp, torch.log, torch.sqrt}
seen = []


def hook(frame, event, arg):
    if event == "c_call" and any(arg is f for f in VML):
        seen.append(frame.f_code.co_filename)


sys.setprofile(hook)
from psrsigsim_torch.ops.shift import fourier_shift  # noqa: E402
sys.setprofile(None)
print(sum("psrsigsim_torch" in f for f in seen))
# F2's shape: 2 observations x 4 channels x 513 bins of a ramp, two
# threads; observation 0 and 1 have the same inputs
prof = torch.tensor(np.random.default_rng(0).random((4, 1024)),
                    dtype=torch.float32)
delays = torch.full((2, 4), 0.0123, dtype=torch.float32)
out = fourier_shift(prof, delays, dt=0.0048828125)
print(int(torch.equal(out[0], out[1])))
"""


def test_host_vector_math_is_set_up_serially_at_import():
    """F2, the SIGKILL-resume flake: on the host, ATen evaluates float
    cos/sin/exp through MKL's vector math (VML) in 2048-element blocks on
    the intra-op threads, and VML's first call in a process, made from two
    threads at once, races its own set-up — one thread's block (observation
    0 of the shift's ramp) then came out ~1e-4 off.  The killed child was a
    fresh process whose first such call was that ramp; the pytest worker
    had called it before.  The port now makes one serial call into VML when
    its device module is imported, before any parallel one: a fresh process
    that imports the shift has called it from the port's own code (the
    parent made no such call, so this fails there by construction), and the
    first shift of F2's shape gives identical observations identical
    rows."""
    proc = subprocess.run([sys.executable, "-c", _VML_PROBE], env=_env(),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    calls, same = (int(v) for v in proc.stdout.split()[-2:])
    assert calls >= 1
    assert same == 1


def test_runtime_imports_no_torch():
    """The export's spawn writers import the runtime package: it must not
    pull in torch (the integrity layer loads the digest kernel lazily)."""
    code = ("import sys; import psrsigsim_torch.runtime, "
            "psrsigsim_torch.runtime.integrity, psrsigsim_torch.io.export; "
            "assert 'torch' not in sys.modules; print('clean')")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


if __name__ == "__main__":
    if sys.argv[1] == "--port":
        _port_child(sys.argv[2], sys.argv[3],
                    True if sys.argv[4] == "true" else sys.argv[4])
    else:
        _child(sys.argv[1])
