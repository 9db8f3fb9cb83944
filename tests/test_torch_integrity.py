"""The port's integrity lattice against the JAX package's, on the CPU.

Tolerances, all exact (the digests are modular uint32 arithmetic):

* ``digest_rows`` / ``triple_digest_rows`` / ``digest_array`` on numpy
  int16, float32, uint8 and int64 arrays made from a seed, at several
  salts: equal to the JAX package's bit for bit.
* the packed-digest kernel's plain version (what the wrapper runs on a CPU
  tensor) on packed buffers in both byte orders, at ``count`` < B and at
  ``count`` = B: equal to the JAX package's ``device_packed_digest_rows``
  bit for bit, and to ``triple_digest_rows`` of the split triple.
* ``audit_selected``: the same chunks for the same fingerprint and
  fraction.
* the integrity-armed supervised export against the port's clean export
  (``host.corrupt`` healed, ``device.sdc`` caught by a full audit and
  healed, ``disk.bitrot`` scrubbed and healed by the next resume): byte
  for byte; with integrity off the digest kernel never runs and the
  bytes and manifest are the unsupervised path's.

The ``cuda``-marked test holds the kernel to its plain version on the
card, bit for bit; it skips without a GPU.

Reference values come from a child process (this file run as a script)
that imports the JAX package; the pytest worker never does.
"""

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

SALTS = (0, 3, 1 << 20, 0xFFFFFFF0)
# (label, shape, dtype)
ARRAYS = [("int16", (4, 3, 10), np.int16), ("float32", (5, 17), np.float32),
          ("uint8", (3, 7, 2), np.uint8), ("int64", (2, 9), np.int64)]
# packed chunks: (label, B, nsub, C, nbin) — nbin % 4 == 0 and not
PACKED = [("nbin64", 3, 2, 5, 64), ("nbin13", 2, 3, 4, 13)]
FINGERPRINTS = ("fp", "fp2", "0" * 64)
FRACS = (0.0, 0.05, 0.5, 1.0)


def _arrays():
    r = np.random.default_rng(7)
    out = {}
    for label, shape, dtype in ARRAYS:
        if np.dtype(dtype).kind == "f":
            out[label] = r.normal(size=shape).astype(dtype)
        else:
            info = np.iinfo(dtype)
            out[label] = r.integers(info.min, info.max, size=shape,
                                    dtype=dtype, endpoint=True)
    return out


def _triple(B, nsub, C, nbin, seed):
    r = np.random.default_rng(seed)
    data = r.integers(-32768, 32767, (B, nsub, C, nbin), dtype=np.int16,
                      endpoint=True)
    data[0, 0, 0, :4] = (-32768, 32767, -1, 0)
    scl = r.uniform(1e-3, 5.0, (B, nsub, C)).astype(np.float32)
    offs = r.normal(0.0, 300.0, (B, nsub, C)).astype(np.float32)
    return data, scl, offs


def _packed(data, scl, offs, byte_order):
    """The ensemble's packed layout: codes (byte-swapped for "big"), then
    DAT_SCL and DAT_OFFS as native int16 halves."""
    codes = data.byteswap() if byte_order == "big" else data
    tail = np.stack([scl, offs], axis=-1).view(np.int16)
    return np.concatenate([codes, tail.reshape(scl.shape + (4,))], axis=-1)


def _child(out):
    """Reference digests from the JAX package (run in a child process)."""
    import jax.numpy as jnp

    from psrsigsim_tpu.runtime import integrity as it

    ref = {}
    for label, a in _arrays().items():
        for salt in SALTS:
            ref[f"rows_{label}_{salt}"] = it.digest_rows(a, salt)
        ref[f"array_{label}"] = np.uint32(it.digest_array(a))
    for label, B, nsub, C, nbin in PACKED:
        d, s, o = _triple(B, nsub, C, nbin, seed=B * nbin)
        ref[f"triple_{label}"] = it.triple_digest_rows(d, s, o)
        for order in ("little", "big"):
            p = _packed(d, s, o, order)
            ref[f"packed_{label}_{order}"] = np.asarray(
                it.device_packed_digest_rows(jnp.asarray(p), nbin))
    ref["audit"] = np.array([[it.audit_selected(fp, i, f) for i in range(300)]
                             for fp in FINGERPRINTS for f in FRACS])
    np.savez(os.path.join(out, "ref.npz"), **ref)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_integrity"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(os.path.join(out, "ref.npz")))


@pytest.mark.parametrize("label", [a[0] for a in ARRAYS])
def test_digest_rows_equal_reference(ref, label):
    from psrsigsim_torch.runtime import integrity as it

    a = _arrays()[label]
    for salt in SALTS:
        got = it.digest_rows(a, salt)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref[f"rows_{label}_{salt}"])
    assert it.digest_array(a) == int(ref[f"array_{label}"])


def test_digest_rejects_undigestable_dtypes():
    from psrsigsim_torch.runtime import integrity as it

    with pytest.raises(TypeError, match="undigestable"):
        it.digest_rows(np.zeros((2, 3), np.float16))
    with pytest.raises(ValueError):
        it.digest_rows(np.float32(1.0))


def test_single_bit_flip_and_swap_change_the_digest():
    from psrsigsim_torch.runtime import integrity as it

    a = np.arange(64, dtype=np.int16).reshape(2, 32)
    d0 = it.digest_rows(a)
    b = a.copy()
    b[1, 17] ^= 1
    d1 = it.digest_rows(b)
    assert d0[0] == d1[0] and d0[1] != d1[1]
    c = a.copy()
    c[0, 3], c[0, 4] = a[0, 4], a[0, 3]
    assert it.digest_rows(c)[0] != d0[0]


@pytest.mark.parametrize("label", [p[0] for p in PACKED])
@pytest.mark.parametrize("order", ["little", "big"])
def test_packed_digest_plain_equals_reference(ref, label, order):
    """The plain K4 (the wrapper on a CPU tensor) equals the JAX package's
    device digest of the same buffer, at count = B and count < B, and the
    host twin of the split triple (the codes as they sit in the buffer)."""
    from psrsigsim_torch.ops.digest import packed_digest, packed_digest_plain
    from psrsigsim_torch.runtime import integrity as it

    _, B, nsub, C, nbin = next(p for p in PACKED if p[0] == label)
    d, s, o = _triple(B, nsub, C, nbin, seed=B * nbin)
    p = _packed(d, s, o, order)
    want = ref[f"packed_{label}_{order}"]
    t = torch.from_numpy(p)
    got = packed_digest(t).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        packed_digest_plain(t, B - 1).numpy().view(np.uint32), want[:B - 1])
    dev = it.device_packed_digest_rows(t, nbin, count=B - 1)
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want[:B - 1])
    codes = p[..., :nbin]
    np.testing.assert_array_equal(it.triple_digest_rows(codes, s, o), want)
    if order == "little":
        np.testing.assert_array_equal(want, ref[f"triple_{label}"])


def test_packed_digest_checks_its_arguments():
    from psrsigsim_torch.ops.digest import packed_digest

    with pytest.raises(ValueError, match="int16"):
        packed_digest(torch.zeros((2, 3, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="count"):
        packed_digest(torch.zeros((2, 3, 4, 8), dtype=torch.int16), 3)
    assert packed_digest(torch.zeros((2, 3, 4, 8), dtype=torch.int16),
                         0).shape == (0,)


def test_audit_selection_equals_reference(ref):
    from psrsigsim_torch.runtime.integrity import audit_selected

    got = np.array([[audit_selected(fp, i, f) for i in range(300)]
                    for fp in FINGERPRINTS for f in FRACS])
    np.testing.assert_array_equal(got, ref["audit"])


def test_resolve_integrity_arming_rule(monkeypatch):
    from psrsigsim_torch.runtime import IntegrityChecker, resolve_integrity

    monkeypatch.delenv("PSS_INTEGRITY", raising=False)
    assert resolve_integrity(None) is None
    assert resolve_integrity(False) is None
    assert resolve_integrity(0.25, fingerprint="f").audit_frac == 0.25
    monkeypatch.setenv("PSS_INTEGRITY", "1")
    monkeypatch.setenv("PSS_INTEGRITY_AUDIT_FRAC", "0.5")
    ck = resolve_integrity(None, fingerprint="f")
    assert ck.audit_frac == 0.5 and ck.fingerprint == "f"
    mine = IntegrityChecker(audit_frac=0.0)
    assert resolve_integrity(mine, fingerprint="g") is mine
    assert mine.fingerprint == "g"
    with pytest.raises(TypeError):
        resolve_integrity("yes")
    with pytest.raises(ValueError):
        IntegrityChecker(audit_frac=2.0)


def test_failed_heal_is_permanent():
    from psrsigsim_torch.runtime import IntegrityChecker, IntegrityError

    ck = IntegrityChecker(audit_frac=0.0)
    calls = []

    def reexec():
        calls.append(1)
        return None

    with pytest.raises(IntegrityError, match="chunk 7"):
        ck.heal_verified(reexec, lambda out: False, producer="export",
                         ident=7, evidence={"start": 7})
    assert calls == [1]   # permanent: no second attempt
    st = ck.stats()
    assert st["permanent_failures"] == 1 and st["sdc_suspect"]



# (case, audit_frac, host rows that differ from the good bytes, rows the
# device's claim attests wrongly, whether the heal's second run disagrees)
VERDICTS = [("clean", 0.0, (), (), False),
            ("lattice_row", 0.0, (1,), (), False),
            ("audit_mismatch", 1.0, (2,), (2,), False),
            ("audit_clean", 1.0, (), (), False),
            ("heal_disagrees", 0.0, (1,), (), True)]


@pytest.mark.parametrize("case,frac,host_bad,dev_bad,split",
                         VERDICTS, ids=[v[0] for v in VERDICTS])
def test_verify_chunk_outcomes(case, frac, host_bad, dev_bad, split):
    """The one verdict every producer runs, on small numpy chunks with a
    scripted re-execution: what it adopts, under which digests, the event
    it reports and the counters it leaves."""
    from psrsigsim_torch.runtime import IntegrityChecker, IntegrityError
    from psrsigsim_torch.runtime.integrity import digest_rows

    good = np.arange(4 * 6, dtype=np.int16).reshape(4, 6)
    # row 3 pads the chunk: a disagreement there is never looked at
    pad = good.copy()
    pad[3] += 7

    def flipped(rows):
        a = good.copy()
        for r in rows:
            a[r, 0] ^= 1
        return a

    host = (flipped(host_bad),)
    dig_dev = digest_rows(flipped(dev_bad) if dev_bad else pad)
    calls, fetches = [], []

    def reexec(audit):
        calls.append(audit)
        dig = digest_rows(good)
        if split and not audit:
            dig = dig ^ np.uint32(1)
        return (lambda: fetches.append(audit) or (good.copy(),),
                dig.astype(np.int64))

    ck = IntegrityChecker(audit_frac=frac, fingerprint="fp")
    kw = dict(producer="mc", ident=16, rows=3, evidence={"start": 16})
    if case == "heal_disagrees":
        with pytest.raises(IntegrityError, match="chunk 16") as err:
            ck.verify_chunk(dig_dev, host, lambda a: digest_rows(a[0]),
                            reexec, **kw)
        assert err.value.evidence == {"producer": "mc", "start": 16,
                                      "lattice_rows": [1]}
        assert calls == [True, False] and fetches == [True]
        assert ck.stats() == {
            "audit_frac": 0.0, "checks": 1, "checksum_mismatches": 1,
            "audits": 0, "audit_mismatches": 0, "healed_chunks": 0,
            "permanent_failures": 1, "sdc_suspect": True}
        return
    arrays, digs, event = ck.verify_chunk(
        dig_dev, host, lambda a: digest_rows(a[0]), reexec, **kw)
    healed = case in ("lattice_row", "audit_mismatch")
    if healed:
        np.testing.assert_array_equal(arrays[0], good)
        np.testing.assert_array_equal(digs, digest_rows(good))
        assert calls == [True, False]
    else:
        assert arrays is host
        np.testing.assert_array_equal(digs, dig_dev)
        assert calls == ([True] if frac else [])
    # only the adopted run's arrays cross to the host
    assert fetches == ([True] if healed else [])
    assert digs.dtype == np.uint32
    assert event == {"clean": None, "audit_clean": None,
                     "lattice_row": ("checksum", [1], [1]),
                     "audit_mismatch": ("audit", [2], [])}[case]
    audit_bad = case == "audit_mismatch"
    assert ck.stats() == {
        "audit_frac": frac, "checks": 1,
        "checksum_mismatches": int(case == "lattice_row"),
        "audits": int(frac > 0), "audit_mismatches": int(audit_bad),
        "healed_chunks": int(healed), "permanent_failures": 0,
        "sdc_suspect": audit_bad}

# -- the integrity-armed export, the port against itself --------------------

N_OBS = 5
SEED = 3


@pytest.fixture(scope="module")
def ens():
    from test_torch_export import _ref_ensemble

    return _ref_ensemble("psrsigsim_torch", device="cpu")


def _supervised(ens, out, **kw):
    from psrsigsim_torch.runtime import supervised_export
    from test_torch_export import TEMPLATE

    return supervised_export(ens, N_OBS, out, TEMPLATE, ens.pulsar,
                             seed=SEED, chunk_size=2, writers=1, **kw)


def _bytes(paths):
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.fixture(scope="module")
def clean(ens, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("integ_clean") / "clean")
    return _bytes(_supervised(ens, out).paths)


def _journal(out):
    with open(os.path.join(out, "run_journal.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_full_audit_clean_run_is_false_positive_free(ens, clean, tmp_path):
    from psrsigsim_torch.runtime import IntegrityChecker

    ck = IntegrityChecker(audit_frac=1.0)
    res = _supervised(ens, str(tmp_path / "on"), integrity=ck)
    st = ck.stats()
    assert st["checks"] == 3 and st["audits"] == 3
    assert st["checksum_mismatches"] == 0 and st["audit_mismatches"] == 0
    assert not st["sdc_suspect"] and st["healed_chunks"] == 0
    assert _bytes(res.paths) == clean
    assert res.integrity == st


def test_host_corrupt_detected_and_healed(ens, clean, tmp_path):
    from psrsigsim_torch.runtime import FaultPlan, IntegrityChecker

    out = str(tmp_path / "out")
    plan = FaultPlan(str(tmp_path / "p"), {"host.corrupt": {"after_start": 0}})
    ck = IntegrityChecker(audit_frac=0.0)
    res = _supervised(ens, out, integrity=ck, faults=plan)
    st = ck.stats()
    assert st["checksum_mismatches"] == 1 and st["healed_chunks"] == 1
    assert not st["sdc_suspect"]   # the device was never wrong
    assert _bytes(res.paths) == clean
    integ = [e for e in _journal(out) if e["e"] == "integrity"]
    assert [(e["kind"], e["start"], e["obs"], e["healed"]) for e in integ] \
        == [("checksum", 0, [0], True)]


def test_device_sdc_caught_by_audit_and_healed(ens, clean, tmp_path):
    from psrsigsim_torch.runtime import FaultPlan, IntegrityChecker

    out = str(tmp_path / "out")
    plan = FaultPlan(str(tmp_path / "p"), {"device.sdc": {"after_start": 2}})
    ck = IntegrityChecker(audit_frac=1.0)
    res = _supervised(ens, out, integrity=ck, faults=plan)
    st = ck.stats()
    # the lattice cannot see SDC (the digest attests the wrong bytes);
    # only the duplicate execution disagrees
    assert st["checksum_mismatches"] == 0
    assert st["audit_mismatches"] == 1 and st["sdc_suspect"]
    assert st["healed_chunks"] == 1
    assert _bytes(res.paths) == clean
    integ = [e for e in _journal(out) if e["e"] == "integrity"]
    assert [(e["kind"], e["start"], e["obs"]) for e in integ] \
        == [("audit", 2, [2])]
    with open(os.path.join(out, "export_manifest.json")) as f:
        assert json.load(f)["integrity"] == st


def test_scenario_audit_reexecution_draws_the_same_factors(tmp_path):
    """A scenario export under a full audit with a device.sdc: the audit's
    re-executions redraw the same scenario factors, so they agree with
    each other, the heal restores the clean bytes and the RFI provenance
    is the clean run's."""
    from psrsigsim_torch.runtime import FaultPlan, IntegrityChecker
    from test_torch_export import SCENARIO, SCENARIO_PARAMS, _ref_ensemble

    scen = _ref_ensemble("psrsigsim_torch", device="cpu", scenario=SCENARIO)
    base = _supervised(scen, str(tmp_path / "clean"),
                       scenario_params=SCENARIO_PARAMS)
    out = str(tmp_path / "out")
    plan = FaultPlan(str(tmp_path / "p"), {"device.sdc": {"after_start": 2}})
    ck = IntegrityChecker(audit_frac=1.0)
    res = _supervised(scen, out, integrity=ck, faults=plan,
                      scenario_params=SCENARIO_PARAMS)
    st = ck.stats()
    assert st["audit_mismatches"] == 1 and st["healed_chunks"] == 1
    assert _bytes(res.paths) == _bytes(base.paths)
    rfi = [e for e in _journal(out) if e["e"] == "rfi"]
    assert rfi == [e for e in _journal(str(tmp_path / "clean"))
                   if e["e"] == "rfi"] and rfi


def test_disk_bitrot_scrubbed_and_resume_heals(ens, clean, tmp_path):
    from psrsigsim_torch.runtime import FaultPlan, scrub_export_dir

    out = str(tmp_path / "out")
    plan = FaultPlan(str(tmp_path / "p"),
                     {"disk.bitrot": {"match": "obs_00001"}})
    _supervised(ens, out, faults=plan)
    rep = scrub_export_dir(out)
    assert rep["bad"] == ["obs_00001.fits"] and rep["scanned"] == N_OBS
    assert os.path.exists(os.path.join(out, "obs_00001.fits.quarantine"))
    res = _supervised(ens, out)
    assert _bytes(res.paths) == clean
    assert scrub_export_dir(out)["bad"] == []


def test_integrity_off_never_runs_the_digest(ens, clean, tmp_path,
                                             monkeypatch):
    """Off is the unarmed path: no digest kernel launch (counted on the
    wrapper), no digest element on yielded chunks, no integrity record,
    and the unsupervised export's bytes and manifest."""
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.ops import digest
    from test_torch_export import TEMPLATE

    monkeypatch.delenv("PSS_INTEGRITY", raising=False)
    calls = []
    real = digest.packed_digest

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(digest, "packed_digest", counted)
    res = _supervised(ens, str(tmp_path / "sup"))
    assert res.integrity is None
    blocks = [b for _, b in ens.iter_chunks(2, chunk_size=2, seed=SEED,
                                            quantized=True)]
    assert all(len(b) == 3 for b in blocks)
    plain = str(tmp_path / "plain")
    paths = export_ensemble_psrfits(ens, N_OBS, plain, TEMPLATE, ens.pulsar,
                                    seed=SEED, chunk_size=2, writers=1)
    assert calls == []
    assert _bytes(paths) == clean
    with open(os.path.join(plain, "export_manifest.json")) as f:
        man = json.load(f)
    assert "integrity" not in man and "files" not in man
    # armed, the wrapper runs once per chunk
    from psrsigsim_torch.runtime import IntegrityChecker

    _supervised(ens, str(tmp_path / "armed"),
                integrity=IntegrityChecker(audit_frac=0.0))
    assert len(calls) == 3


def test_integrity_requires_supervision(ens, tmp_path):
    from psrsigsim_torch.io import export_ensemble_psrfits
    from test_torch_export import TEMPLATE

    with pytest.raises(ValueError, match="requires supervision"):
        export_ensemble_psrfits(ens, 2, str(tmp_path / "out"), TEMPLATE,
                                ens.pulsar, integrity=True)


def test_iter_chunks_digest_equals_host_twin(ens):
    """Each chunk's device digest (last element) equals the host twin of
    the fetched triple, at every prefetch/fetch setting."""
    from psrsigsim_torch.runtime import IntegrityChecker
    from psrsigsim_torch.runtime.integrity import triple_digest_rows

    ck = IntegrityChecker(audit_frac=0.0)
    for prefetch, fetch_ahead in ((0, 0), (1, 2)):
        for _, (d, s, o, dig) in ens.iter_chunks(
                N_OBS, chunk_size=2, seed=SEED, quantized=True,
                byte_order="big", integrity=ck, prefetch=prefetch,
                fetch_ahead=fetch_ahead):
            assert dig.dtype == np.uint32 and dig.shape == (d.shape[0],)
            np.testing.assert_array_equal(triple_digest_rows(d, s, o), dig)
    with pytest.raises(ValueError, match="quantized"):
        list(ens.iter_chunks(2, integrity=ck))


@pytest.mark.cuda
def test_packed_digest_on_card_equals_plain():
    """K4 on the card equals its plain version bit for bit: both byte
    orders, count < B, a vector-load and a scalar-load shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops import digest

    for _, B, nsub, C, nbin in PACKED + [("wide", 4, 20, 64, 2048)]:
        d, s, o = _triple(B, nsub, C, nbin, seed=B * nbin)
        for order in ("little", "big"):
            t = torch.from_numpy(_packed(d, s, o, order)).cuda()
            for count in (B, B - 1):
                n0 = digest.packed_digest.launches
                got = digest.packed_digest(t, count)
                assert digest.packed_digest.launches == n0 + 1
                want = digest.packed_digest_plain(t, count)
                assert torch.equal(got, want)


if __name__ == "__main__":
    _child(sys.argv[1])
