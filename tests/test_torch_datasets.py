"""The port's SEARCH-mode dataset factory (``psrsigsim_torch.datasets``)
against the JAX package's, and against itself, on the CPU.

Specs: bench.py's ``_DATASET_BENCH_SPEC`` (4 channels, 20 pulses of 1024
samples, rfi + single_pulse, dm and rfi_imp_snr priors) and its smoke
sibling, cut to a few records.  Tolerances and why:

* the canonical JSON, the fingerprint, the spec errors, the shard
  indexes, the manifest's guarded fields and ``shuffled_order``: host
  arithmetic in both — equal, byte for byte;
* records: the 16-byte prefix, the index word and the labels
  ``params``, ``scenario_params`` (the sampled priors), ``energies`` and
  ``rfi_mask`` equal byte for byte (the draws are the JAX package's bit
  for bit, with XLA's ``exp`` written out for ``LogUniform`` and the
  log-normal energies, psrsigsim_torch/ops/stats.py); the SEARCH
  ``tile`` within rtol 1e-5 with a floor of 1e-5 of its peak (the
  Fourier shift's FFT ulps, tests/test_torch_search.py);
* the port against itself: corpora byte-identical for chunk sizes 1, 5
  and 8, after a SIGKILL at ``dataset.kill`` resumed with another chunk
  size, and after ``integrity=`` heals a ``host.corrupt``, a
  ``device.sdc`` and a ``disk.bitrot``.

The JAX reference runs in a child process (this file run as a script)
with the shims R1 and R2 and one XLA CPU device; the corpus that must die
by SIGKILL is this file run as a script with ``--port-kill``.
"""

import glob
import hashlib
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
sys.path.insert(0, HERE)

from test_torch_toa import child_env, shims  # noqa: E402

# bench.py _DATASET_BENCH_SPEC and _DATASET_SMOKE_SPEC
BENCH = {
    "nchan": 4, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "tobs_s": 0.1, "period_s": 0.005,
    "smean_jy": 0.05, "seed": 3, "n_records": 512, "shards": 4,
    "dm": 10.0, "scenarios": ["rfi", "single_pulse"],
    "rfi_imp_prob": 0.25, "rfi_nb_prob": 0.25,
    "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0},
               "rfi_imp_snr": {"dist": "loguniform", "lo": 1.0,
                               "hi": 50.0}},
}
SMOKE = dict(BENCH, nchan=2, tobs_s=0.02, seed=11,
             priors={"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0},
                     "rfi_imp_snr": {"dist": "loguniform", "lo": 1.0,
                                     "hi": 50.0},
                     "sp_sigma": {"dist": "uniform", "lo": 0.1, "hi": 1.0}})
PLAIN = {"nchan": 2, "fcent_mhz": 1400.0, "bw_mhz": 200.0,
         "sample_rate_mhz": 0.2048, "tobs_s": 0.02, "period_s": 0.005,
         "smean_jy": 0.05, "seed": 1, "n_records": 6, "dm": 10,
         "noise_scale": 1}
SCINT = dict(PLAIN, scenarios=["scintillation", "single_pulse:frb"],
             scint_mod=0.7, priors={"sp_amp": {"dist": "uniform", "lo": 2.0,
                                               "hi": 9.0},
                                    "noise_scale": {"dist": "normal",
                                                    "mean": 1.0,
                                                    "sigma": 0.1}})
SPECS = {"bench": BENCH, "smoke": SMOKE, "plain": PLAIN, "scint": SCINT}
BAD = {"unknown": dict(PLAIN, noise_scael=2.0),
       "missing": {"nchan": 2},
       "disabled": dict(PLAIN, rfi_imp_snr=5.0),
       "prior": dict(PLAIN, priors={"rfi_imp_snr": {"dist": "uniform",
                                                    "lo": 1, "hi": 2}}),
       "range": dict(PLAIN, nchan=0, dm="x")}
# the corpus held against the JAX package's, record by record
PARITY = dict(BENCH, n_records=10, shards=4)
PARITY_CHUNK = 4
SMALL = dict(SMOKE, n_records=13, shards=3)
ORDERS = [(0, 0, 0, 0), (1, 5, 0, 0), (17, 3, 2, 1), (64, 11, 1, 7)]


def _corpus(out_dir):
    """Every byte of a corpus's shards and indexes, by file name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "shard-*"))):
        with open(path, "rb") as fh:
            out[os.path.basename(path)] = fh.read()
    return out


def _sha(out_dir):
    h = hashlib.sha256()
    for name, data in _corpus(out_dir).items():
        h.update(name.encode() + data)
    return h.hexdigest()


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    from psrsigsim_tpu.datasets import (DatasetFactory, DatasetSpecError,
                                        canonicalize, fingerprint_hash,
                                        shuffled_order)
    from psrsigsim_tpu.datasets.spec import canonical_json

    meta = {"canonical": {}, "fingerprint": {}, "errors": {}}
    for name, spec in SPECS.items():
        c = canonicalize(spec)
        meta["canonical"][name] = canonical_json(c)
        meta["fingerprint"][name] = fingerprint_hash(c)
    for name, spec in BAD.items():
        try:
            canonicalize(spec)
        except DatasetSpecError as err:
            meta["errors"][name] = err.errors
    meta["orders"] = [shuffled_order(*o) for o in ORDERS]
    fac = DatasetFactory(PARITY)
    meta["describe"] = fac.sampler.describe()
    meta["summary"] = {k: v for k, v in fac.run(
        os.path.join(out, "corpus"), chunk_size=PARITY_CHUNK).items()
        if k != "telemetry"}
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_datasets")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "meta.json") as fh:
        meta = json.load(fh)
    meta["corpus_dir"] = str(out / "corpus")
    return meta


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


def _factory(spec, **kw):
    from psrsigsim_torch.datasets import DatasetFactory

    return DatasetFactory(spec, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_canonical_json_and_fingerprint_match_reference(ref, name):
    from psrsigsim_torch.datasets import canonicalize, fingerprint_hash
    from psrsigsim_torch.datasets.spec import canonical_json

    c = canonicalize(SPECS[name])
    assert canonical_json(c) == ref["canonical"][name]
    assert fingerprint_hash(c) == ref["fingerprint"][name]


@pytest.mark.parametrize("name", sorted(BAD))
def test_spec_errors_match_reference(ref, name):
    from psrsigsim_torch.datasets import DatasetSpecError, canonicalize

    with pytest.raises(DatasetSpecError) as err:
        canonicalize(BAD[name])
    assert err.value.errors == ref["errors"][name]


def test_shuffled_order_matches_reference(ref):
    from psrsigsim_torch.datasets import shuffled_order

    assert [shuffled_order(*o) for o in ORDERS] == ref["orders"]


def test_records_match_reference(ref, tmp_path):
    """The port's corpus of the same spec: every shard index and the
    manifest's guarded fields equal; per record the prefix, the index and
    every label byte equal, the tile within the FFT tolerance."""
    from psrsigsim_torch.datasets import DatasetReader

    fac = _factory(PARITY)
    assert fac.sampler.describe() == ref["describe"]
    out = str(tmp_path / "port")
    summary = fac.run(out, chunk_size=PARITY_CHUNK)
    assert {k: v for k, v in summary.items() if k != "telemetry"} == \
        ref["summary"]
    want_dir = ref["corpus_dir"]
    for name in ("dataset_manifest.json",
                 *[f"shard-{s:05d}.index.json" for s in range(4)]):
        with open(os.path.join(out, name)) as a, \
                open(os.path.join(want_dir, name)) as b:
            assert json.load(a) == json.load(b), name
    got, want = DatasetReader(out), DatasetReader(want_dir)
    floats = ("params", "scenario_params", "energies")
    assert [n for n, _, _ in got.layout] == [*floats, "rfi_mask", "tile"]
    for i in range(PARITY["n_records"]):
        gb, wb = got.record_bytes(i), want.record_bytes(i)
        assert gb[:24] == wb[:24]
        g, w = got.read_index(i), want.read_index(i)
        assert g["rfi_mask"].tobytes() == w["rfi_mask"].tobytes(), i
        for name in floats:
            assert g[name].tobytes() == w[name].tobytes(), (i, name)
        np.testing.assert_allclose(g["tile"], w["tile"], rtol=1e-5,
                                   atol=1e-5 * np.abs(w["tile"]).max())
    assert int(got.read_index(3)["rfi_mask"].sum()) + int(
        got.read_index(5)["rfi_mask"].sum()) > 0


def test_corpus_is_byte_identical_for_chunk_sizes_1_5_8(hw, tmp_path):
    hashes = set()
    for chunk in (1, 5, 8):
        out = str(tmp_path / f"c{chunk}")
        res = _factory(SMALL).run(out, chunk_size=chunk)
        assert res["commits"] == -(-SMALL["n_records"] // chunk)
        hashes.add(_sha(out))
    assert len(hashes) == 1


def _port_kill(out, scratch):
    """A corpus run that dies by SIGKILL right after chunk 4's commit."""
    from psrsigsim_torch.runtime import FaultPlan

    _factory(SMALL).run(out, chunk_size=4, faults=FaultPlan(
        scratch, {"dataset.kill": {"after_start": 4}}))
    print("the factory survived dataset.kill", file=sys.stderr)
    sys.exit(1)


def test_sigkill_then_resume_with_another_chunk_size(hw, tmp_path):
    from psrsigsim_torch.runtime.supervisor import load_chunk_journal

    clean = str(tmp_path / "clean")
    _factory(SMALL).run(clean, chunk_size=8)
    out = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--port-kill", out, str(tmp_path / "plan")],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == -9, proc.stderr[-3000:]
    assert sorted(load_chunk_journal(
        os.path.join(out, "dataset_journal.jsonl"))) == [0, 4]
    res = _factory(SMALL).run(out, chunk_size=5)
    # chunk size 5 starts at 0, 5, 10: none of them is a journaled chunk of
    # size 4, so every chunk is recomputed into the same slots
    assert res["resumed_chunks"] == 0 and res["commits"] == 3
    assert _corpus(out) == _corpus(clean)


def test_stop_and_resume_same_chunk_size_skips_committed(hw, tmp_path):
    out = str(tmp_path / "c")
    assert _factory(SMALL).run(out, chunk_size=4, _stop_after_chunks=2) is None
    res = _factory(SMALL).run(out, chunk_size=4)
    assert res["resumed_chunks"] == 2 and res["commits"] == 2
    clean = str(tmp_path / "clean")
    _factory(SMALL).run(clean, chunk_size=13)
    assert _corpus(out) == _corpus(clean)


def test_integrity_heals_host_corrupt_device_sdc_and_bitrot(hw, tmp_path):
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.runtime.integrity import scrub_dataset_dir

    clean = str(tmp_path / "clean")
    _factory(SMALL).run(clean, chunk_size=4)
    out = str(tmp_path / "armed")
    res = _factory(SMALL).run(out, chunk_size=4, integrity=1.0,
                              faults=FaultPlan(str(tmp_path / "p1"), {
                                  "host.corrupt": {"after_start": 4},
                                  "device.sdc": {"after_start": 8}}))
    st = res["integrity"]
    assert st["checksum_mismatches"] == 1 and st["audit_mismatches"] == 1
    # chunks 0, 8 and 12 audited; chunk 4 failed its checksum first
    assert st["healed_chunks"] == 2 and st["audits"] == 3
    assert _corpus(out) == _corpus(clean)
    with open(os.path.join(out, "dataset_journal.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert sorted(r["start"] for r in recs if r["e"] == "integrity") == [4, 8]
    assert all("dig" in r for r in recs if r["e"] == "chunk")

    rot = str(tmp_path / "rot")
    _factory(SMALL).run(rot, chunk_size=4, faults=FaultPlan(
        str(tmp_path / "p2"), {"disk.bitrot": {"match": "start=8"}}))
    assert scrub_dataset_dir(rot)["bad"] == [8]
    res = _factory(SMALL).run(rot, chunk_size=4)
    assert res["resumed_chunks"] == 3 and res["commits"] == 1
    assert scrub_dataset_dir(rot)["bad"] == []
    assert _corpus(rot) == _corpus(clean)


def test_manifest_guard_and_overwrite(hw, tmp_path):
    from psrsigsim_torch.datasets import DatasetManifestError

    out = str(tmp_path / "c")
    _factory(dict(SMALL, n_records=6)).run(out, chunk_size=6)
    with pytest.raises(DatasetManifestError, match="dm"):
        _factory(dict(SMALL, n_records=6, dm=11.0)).run(out, chunk_size=6)
    # resume=False wipes every byte of the old corpus
    _factory(dict(SMALL, n_records=3, shards=1)).run(out, chunk_size=3,
                                                     resume=False)
    assert sorted(_corpus(out)) == ["shard-00000.index.json",
                                    "shard-00000.records"]


def test_reader_and_record_host(hw, tmp_path):
    out = str(tmp_path / "c")
    fac = _factory(SMALL)
    fac.run(out, chunk_size=6)
    reader = fac.reader(out)
    seen = [int(r["index"]) for r in reader.iter_epoch(2)]
    assert sorted(seen) == list(range(SMALL["n_records"]))
    one = fac.sampler.record_host(7)
    rec = reader.read_index(7)
    for name, _, _ in fac.sampler.field_layout():
        assert np.array_equal(one[name], rec[name]), name
    assert rec["rfi_mask"].dtype == np.uint8
    assert rec["tile"].shape == (2, fac.sampler.cfg.nsamp)


def test_unported_options_raise_and_writer_imports_no_torch():
    from psrsigsim_torch.datasets import DatasetFactory

    from psrsigsim_torch.parallel import make_mesh

    # mesh= takes a Mesh (tests/test_torch_mesh.py holds its corpora)
    with pytest.raises(TypeError, match="Mesh"):
        DatasetFactory(SMALL, mesh=object(), device="cpu")
    fac = DatasetFactory(SMALL, mesh=make_mesh((2, 1), ["cpu"] * 2))
    assert fac.sampler.record_host(3)["tile"].shape == \
        (2, fac.sampler.cfg.nsamp)
    code = ("import sys; import psrsigsim_torch.datasets.writer; "
            "assert 'torch' not in sys.modules; print('clean')")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(HERE)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


@pytest.mark.cuda
def test_factory_on_the_card_matches_the_host(tmp_path):
    """On the card: two flat launches per chunk, the labels equal a
    PSS_SAMPLER=hw host corpus byte for byte and the tiles within the FFT
    tolerance; the corpus is byte-identical for chunk sizes 5 and 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flat kernel has no CPU mode")
    from psrsigsim_torch.datasets import DatasetFactory, DatasetReader
    from psrsigsim_torch.ops import rng_hw

    rng_hw.rng_flat_field.launches = 0
    a = str(tmp_path / "a")
    DatasetFactory(SMALL, device="cuda").run(a, chunk_size=5)
    assert rng_hw.rng_flat_field.launches == 2 * 3
    b = str(tmp_path / "b")
    DatasetFactory(SMALL, device="cuda").run(b, chunk_size=8)
    assert _corpus(a) == _corpus(b)
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        h = str(tmp_path / "h")
        _factory(SMALL).run(h, chunk_size=13)
    finally:
        os.environ.pop("PSS_SAMPLER")
    got, want = DatasetReader(a), DatasetReader(h)
    for i in range(SMALL["n_records"]):
        g, w = got.read_index(i), want.read_index(i)
        # the card's labels are the host's draws: byte for byte
        for name in ("params", "scenario_params", "energies", "rfi_mask"):
            assert g[name].tobytes() == w[name].tobytes()
        np.testing.assert_allclose(g["tile"], w["tile"], rtol=1e-5,
                                   atol=1e-5 * np.abs(w["tile"]).max())


if __name__ == "__main__":
    if sys.argv[1] == "--port-kill":
        _port_kill(sys.argv[2], sys.argv[3])
    else:
        _child(sys.argv[1])
