"""The port's serving core (psrsigsim_torch/serve/) against the JAX
package's, and its own contracts, on the CPU.

Against the reference, whose values come from a child process (this file
run as a script, with the R1/R2 shims of tests/test_torch_toa.py):

* canonical JSON, ``spec_hash`` and ``geometry_hash`` byte-equal over 50
  specs, scenario specs included; ``SpecError`` names the same problems;
* ``build_geometry``: the portrait and noise norm bit for bit, the fold
  configuration's ``nfold``/``noise_df``/``draw_norm``/``nsub``/``nph``
  exactly;
* the request keys (``(seed, spec hash)`` on the ``"serve"`` stage) as
  uint32 key data, bit for bit;
* served profiles within rtol 1e-5 plus 1e-5 of the peak (the FFTs and
  the subint sum round apart) for ``null_frac`` 0 and 0.3 and for the
  three-effect scenario;
* given the same result bytes, the cache's artifacts and journal lines
  byte-equal.

Within the port (``device="cpu"``): solo, coalesced, widths 1/8/32 and a
padded batch bit-equal; a cache hit and a SIGKILL resume make no device
call; one build per (geometry, width); admission, deadlines, drain, the
threaded and aio front ends, integrity healing.  Tests of the port alone
draw with ``PSS_SAMPLER=hw`` (the sampler kernel's plain version, the
stream the card draws), except where a test says otherwise.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_toa import child_env, shims  # noqa: E402

#: bench.py's serving geometry (4 channels, 1024 bins, 2 subints)
SPEC = {
    "nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
    "period_s": 0.005, "smean_jy": 0.05,
    "seed": 3, "dm": 10.0,
}
EFFECTS3 = ["scintillation", "rfi", "single_pulse"]
SCEN_SPEC = dict(SPEC, scenarios=EFFECTS3, scint_dnu_d_mhz=40.0,
                 scint_dt_d_s=0.3, rfi_imp_prob=0.5, rfi_nb_prob=0.5,
                 sp_sigma=0.8, seed=21)
#: the specs whose served profiles are held to the reference
SERVED = {"null0": SPEC, "null03": dict(SPEC, null_frac=0.3, seed=5),
          "scenario": SCEN_SPEC}


def spec_cases():
    """50 valid specs: numeric spellings, request knobs, geometry fields,
    scenario stacks (any order, every mode) with and without parameters."""
    rng = np.random.default_rng(11)
    cases = [SPEC, dict(SPEC, dm=10), dict(SPEC, nchan=4.0),
             dict(SPEC, noise_scale=1), dict(SPEC, null_frac=0)]
    for i in range(15):
        cases.append(dict(SPEC, seed=int(rng.integers(0, 2**31 - 1)),
                          dm=float(rng.uniform(0, 100)),
                          noise_scale=float(rng.uniform(0.1, 5)),
                          null_frac=float(rng.uniform(0, 1))))
    for i in range(10):
        cases.append(dict(SPEC, nchan=int(rng.integers(1, 128)),
                          fcent_mhz=float(rng.uniform(300, 3000)),
                          bw_mhz=float(rng.uniform(10, 800)),
                          period_s=float(rng.uniform(0.001, 2)),
                          profile_width=float(rng.uniform(0.01, 0.3)),
                          tsys_k=float(rng.integers(20, 80))))
    stacks = [["rfi"], ["scintillation"], ["single_pulse"],
              ["single_pulse:frb"], ["single_pulse:powerlaw", "rfi"],
              ["rfi", "scintillation"], EFFECTS3, list(reversed(EFFECTS3)),
              ["single_pulse:lognormal", "scintillation"], []]
    for st in stacks:
        cases.append(dict(SPEC, scenarios=st))
    cases += [SCEN_SPEC, dict(SCEN_SPEC, rfi_nb_snr=7),
              dict(SPEC, scenarios=["single_pulse:frb"], sp_amp=3),
              dict(SPEC, scenarios=["single_pulse:powerlaw"], sp_alpha=1.5),
              dict(SPEC, scenarios=["scintillation"], scint_mod=0.25,
                   seed=9)]
    while len(cases) < 50:
        cases.append(dict(SPEC, seed=1000 + len(cases),
                          dm=0.5 * len(cases)))
    return cases


BAD_SPECS = [
    {"nchan": 4, "bogus_field": 1},
    dict(SPEC, nchan=2.5, dm=-1.0),
    dict(SPEC, seed=True, null_frac=[0.1]),
    dict(SPEC, scint_mod=0.5),
    dict(SPEC, scenarios=["nope"]),
    dict(SPEC, scenarios="rfi"),
    dict(SPEC, nchan="x", period_s=1e9),
    [1, 2],
]


def cache_arrays():
    rng = np.random.default_rng(4)
    return [("%064x" % (i + 1) * 1, rng.normal(size=(4, 1024)).astype(
        np.float32), {"geom": "abc", "dig": i}) for i in range(3)]


def _child(out):
    shims()
    import jax

    from psrsigsim_tpu.serve import (ResultCache, SimulationService,
                                     SpecError, canonicalize,
                                     geometry_hash, spec_hash)
    from psrsigsim_tpu.serve.spec import _canonical_json, build_geometry

    res = {}
    canon = [canonicalize(s) for s in spec_cases()]
    res["canonical"] = np.array([_canonical_json(c) for c in canon])
    res["spec_hash"] = np.array([spec_hash(c) for c in canon])
    res["geometry_hash"] = np.array([geometry_hash(c) for c in canon])
    errs = []
    for bad in BAD_SPECS:
        try:
            canonicalize(bad)
            errs.append("")
        except SpecError as err:
            errs.append(json.dumps(err.errors))
    res["errors"] = np.array(errs)
    cfg, profiles, noise_norm = build_geometry(canonicalize(SPEC))
    res["profiles"] = np.asarray(profiles, np.float32)
    res["noise_norm"] = np.float64(noise_norm)
    res["cfg"] = np.array([cfg.nfold, cfg.noise_df, cfg.draw_norm, cfg.nsub,
                           cfg.nph], np.float64)
    svc = SimulationService(cache_dir=None, widths=(1,))
    try:
        for name, spec in SERVED.items():
            rid, _ = svc.submit(spec)
            res[f"served_{name}"] = np.asarray(svc.result(rid, timeout=600))
            res[f"key_{name}"] = np.asarray(jax.random.key_data(
                svc._request_key(canonicalize(spec), rid)))
    finally:
        svc.close()
    d = os.path.join(out, "cache")
    cache = ResultCache(d)
    for h, arr, meta in cache_arrays():
        cache.put(h, arr, meta=meta)
    cache.close()
    for h, _, _ in cache_arrays():
        with open(os.path.join(d, "results", h + ".npy"), "rb") as f:
            res[f"artifact_{h[-4:]}"] = np.frombuffer(f.read(), np.uint8)
    with open(os.path.join(d, "cache_journal.jsonl"), "rb") as f:
        res["journal"] = np.frombuffer(f.read(), np.uint8)
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_serve")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=child_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


@pytest.fixture
def hw(monkeypatch):
    """The card's stream: the sampler kernel's plain version."""
    monkeypatch.setenv("PSS_SAMPLER", "hw")


def _service(tmp_path=None, **kw):
    from psrsigsim_torch.serve import SimulationService

    kw.setdefault("widths", (1, 8))
    kw.setdefault("batch_window_s", 0.002)
    kw.setdefault("device", "cpu")
    cache_dir = str(tmp_path / "cache") if tmp_path is not None else None
    return SimulationService(cache_dir=cache_dir, **kw)


# ---------------------------------------------------------------------------
# canonical specs
# ---------------------------------------------------------------------------


class TestSpec:
    def test_canonical_json_and_hashes_match_reference(self, ref):
        from psrsigsim_torch.serve import (canonicalize, geometry_hash,
                                           spec_hash)
        from psrsigsim_torch.serve.spec import _canonical_json

        canon = [canonicalize(s) for s in spec_cases()]
        assert len(canon) == 50
        assert [_canonical_json(c) for c in canon] == list(ref["canonical"])
        assert [spec_hash(c) for c in canon] == list(ref["spec_hash"])
        assert [geometry_hash(c) for c in canon] == list(
            ref["geometry_hash"])

    def test_spec_errors_name_the_same_fields(self, ref):
        from psrsigsim_torch.serve import SpecError, canonicalize

        for bad, want in zip(BAD_SPECS, ref["errors"]):
            with pytest.raises(SpecError) as err:
                canonicalize(bad)
            assert json.dumps(err.value.errors) == want

    def test_unknown_and_missing_fields_all_named(self):
        from psrsigsim_torch.serve import SpecError, canonicalize

        with pytest.raises(SpecError) as err:
            canonicalize({"nchan": 4, "bogus_field": 1})
        msg = str(err.value)
        assert "bogus_field" in msg and "fcent_mhz: required" in msg

    def test_numeric_normalization_and_geometry_hash(self):
        from psrsigsim_torch.serve import (canonicalize, geometry_hash,
                                           spec_hash)

        assert spec_hash(canonicalize(dict(SPEC, dm=10))) == spec_hash(
            canonicalize(dict(SPEC, dm=10.0)))
        a = canonicalize(SPEC)
        b = canonicalize(dict(SPEC, seed=99, dm=55.0, noise_scale=2.0,
                              null_frac=0.3))
        assert geometry_hash(a) == geometry_hash(b)
        assert spec_hash(a) != spec_hash(b)
        assert a["noise_scale"] == 1.0 and a["null_frac"] == 0.0

    def test_build_geometry_matches_reference(self, ref):
        from psrsigsim_torch.serve import build_geometry, canonicalize

        cfg, profiles, noise_norm = build_geometry(canonicalize(SPEC))
        prof = np.asarray(profiles, np.float32)
        assert prof.tobytes() == ref["profiles"].tobytes()
        assert noise_norm == float(ref["noise_norm"])
        assert [cfg.nfold, cfg.noise_df, cfg.draw_norm, cfg.nsub,
                cfg.nph] == list(ref["cfg"])

    @pytest.mark.parametrize("name", sorted(SERVED))
    def test_request_keys_match_reference(self, ref, name):
        from psrsigsim_torch.serve import canonicalize, spec_hash
        from psrsigsim_torch.serve.service import request_keys

        c = canonicalize(SERVED[name])
        got = request_keys([c["seed"]], [spec_hash(c)])
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got[0], ref[f"key_{name}"])


# ---------------------------------------------------------------------------
# served profiles and batching invariance
# ---------------------------------------------------------------------------


def _serve_with_strangers(widths, n_strangers, window, spec=SPEC):
    """Serve ``spec`` through a service restricted to ``widths``, alongside
    ``n_strangers`` distinct same-geometry requests; its bytes and the
    registry's (width -> calls) map."""
    svc = _service(widths=widths, batch_window_s=window)
    try:
        svc.warmup(spec)
        ids = [svc.submit(dict(spec, seed=100 + i, dm=12.0 + i))[0]
               for i in range(n_strangers)]
        rid, _ = svc.submit(spec)
        out = svc.result(rid, timeout=120)
        for i in ids:
            svc.result(i, timeout=120)
        svc.registry.assert_single_compile()
        calls = {w: c for (_, w), c in svc.registry.call_counts().items()}
        return np.ascontiguousarray(out).tobytes(), calls
    finally:
        svc.close()


class TestBatchingInvariance:
    @pytest.mark.parametrize("name", sorted(SERVED))
    def test_served_profiles_match_reference(self, ref, name):
        """The threefry stream on both sides: the draws are bit for bit,
        the Fourier shift's FFTs and the subint sum round apart."""
        svc = _service(widths=(1,))
        try:
            rid, _ = svc.submit(SERVED[name])
            got = svc.result(rid, timeout=120)
        finally:
            svc.close()
        want = ref[f"served_{name}"]
        assert got.shape == want.shape == (4, 1024)
        assert got.dtype == np.float32
        peak = np.abs(want).max()
        bad = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-5 * peak
        assert not bad.any(), np.abs(got - want).max()

    def test_solo_vs_coalesced_vs_bucket_widths(self, hw):
        """For a fixed spec the served result is BIT-identical alone
        (width 1), coalesced with 6 strangers (width 8) and in a width-32
        batch; a 5-request batch padded to 8 too."""
        solo, c1 = _serve_with_strangers((1,), 0, 0.0)
        co8, c8 = _serve_with_strangers((8,), 6, 0.2)
        co32, c32 = _serve_with_strangers((32,), 20, 0.2)
        pad, cp = _serve_with_strangers((8,), 4, 0.2)
        assert 1 in c1 and 8 in c8 and 32 in c32 and 8 in cp
        assert solo == co8 == co32 == pad

    def test_threefry_widths_bit_equal(self):
        solo, _ = _serve_with_strangers((1,), 0, 0.0)
        co8, c8 = _serve_with_strangers((8,), 4, 0.2)
        assert 8 in c8 and solo == co8

    def test_scenario_widths_bit_equal(self, hw):
        solo, _ = _serve_with_strangers((1,), 0, 0.0, spec=SCEN_SPEC)
        co8, c8 = _serve_with_strangers((8,), 5, 0.2, spec=SCEN_SPEC)
        assert 8 in c8 and solo == co8

    def test_bucket_fn_matches_fold_pipeline(self, hw):
        """The bucket is fold_pipeline + fold_subints: null_frac 0 is the
        null-free pipeline bit for bit, and the rows equal the pipeline's
        own batch."""
        from psrsigsim_torch.parallel import build_width_bucket_fn
        from psrsigsim_torch.serve import build_geometry, canonicalize
        from psrsigsim_torch.serve.programs import example_keys
        from psrsigsim_torch.simulate import fold_pipeline, fold_subints

        cfg, profiles, noise_norm = build_geometry(canonicalize(SPEC))
        fn = build_width_bucket_fn(cfg, profiles, device="cpu")
        keys = example_keys(3)
        dms = np.float32([10.0, 11.0, 12.5])
        norms = np.full(3, noise_norm, np.float32)
        got = fn(keys, dms, norms, np.zeros(3, np.float32))
        want = fold_subints(fold_pipeline(keys, dms, norms, profiles, cfg,
                                          device="cpu"), cfg.nsub, cfg.nph)
        assert got.shape == (3, 4, cfg.nph)
        assert torch.equal(got, want)
        nulled = fn(keys, dms, norms, np.float32([0.0, 1.0, 0.0]))
        assert torch.equal(nulled[0], got[0])
        assert not torch.equal(nulled[1], got[1])

    def test_single_build_per_bucket_after_warmup(self, tmp_path, hw):
        svc = _service(tmp_path)
        try:
            svc.warmup(SPEC)
            for i in range(6):
                rid, _ = svc.submit(dict(SPEC, seed=200 + i))
                svc.result(rid, timeout=120)
            counts = svc.registry.compile_counts()
            assert set(w for _, w in counts) == {1, 8}
            svc.registry.assert_single_compile()
        finally:
            svc.close()

    def test_sampler_switch_stages_a_fresh_bucket(self, monkeypatch):
        """A bucket warmed under one sampler is never reused under the
        other: the key carries trace_env_key."""
        monkeypatch.setenv("PSS_SAMPLER", "hw")
        svc = _service(widths=(1,))
        try:
            gh = svc.warmup(SPEC)
            a = svc.registry.program(gh, 1)
            monkeypatch.setenv("PSS_SAMPLER", "threefry")
            b = svc.registry.program(gh, 1)
            assert a is not b
            builds = svc.registry._store.build_counts()
            assert sorted(k[3][0] for k in builds) == ["hw", "threefry"]
        finally:
            svc.close()

    def test_cache_hit_never_reexecutes(self, tmp_path, hw):
        svc = _service(tmp_path)
        try:
            rid, _ = svc.submit(SPEC)
            first = svc.result(rid, timeout=120)
            calls = svc.registry.device_calls
            rid2, _ = svc.submit(SPEC)
            assert rid2 == rid
            assert svc.result(rid2, timeout=120).tobytes() == first.tobytes()
            assert svc.registry.device_calls == calls
        finally:
            svc.close()
        # a fresh service over the same cache dir: the hit comes from disk
        svc2 = _service(tmp_path)
        try:
            rid3, status = svc2.submit(SPEC)
            assert rid3 == rid and status == "done"
            again = svc2.result(rid3, timeout=120)
            assert svc2.registry.device_calls == 0
            assert svc2.cache_hits == 1
            assert first.tobytes() == again.tobytes()
        finally:
            svc2.close()

    def test_null_frac_active_changes_result(self, hw):
        svc = _service(widths=(1,))
        try:
            a, _ = svc.submit(SPEC)
            b, _ = svc.submit(dict(SPEC, null_frac=0.9))
            assert (svc.result(a, timeout=120).tobytes()
                    != svc.result(b, timeout=120).tobytes())
        finally:
            svc.close()

    def test_no_card_no_device_raises(self, monkeypatch):
        from psrsigsim_torch.serve import SimulationService
        from psrsigsim_torch.serve.__main__ import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimulationService()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--port", "0"])
        with pytest.raises(ValueError, match="pod-num-hosts"):
            main(["--port", "0", "--device", "cpu", "--pod-follower"])


@pytest.mark.cuda
def test_served_on_the_card_matches_the_host(hw):
    """On the card the buckets launch the sampler kernel twice a batch and
    serve what the host serves within the fold bound; widths bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sampler kernel has no CPU mode")
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.serve import SimulationService

    svc = SimulationService(widths=(1, 8), device="cuda")
    try:
        svc.warmup(SPEC)
        rng_hw.rng_field.launches = 0
        rid, _ = svc.submit(SPEC)
        card = svc.result(rid, timeout=120)
        assert rng_hw.rng_field.launches == 2
    finally:
        svc.close()
    solo, _ = _serve_with_strangers((1,), 0, 0.0)
    host = np.frombuffer(solo, np.float32).reshape(card.shape)
    peak = np.abs(host).max()
    assert (np.abs(card - host) <= 1e-5 * np.abs(host) + 1e-5 * peak).all()


# ---------------------------------------------------------------------------
# result cache durability
# ---------------------------------------------------------------------------


class TestResultCache:
    def test_artifacts_and_journal_match_reference(self, ref, tmp_path):
        from psrsigsim_torch.serve import ResultCache

        d = str(tmp_path / "c")
        cache = ResultCache(d)
        for h, arr, meta in cache_arrays():
            cache.put(h, arr, meta=meta)
        cache.close()
        for h, _, _ in cache_arrays():
            with open(os.path.join(d, "results", h + ".npy"), "rb") as f:
                assert f.read() == ref[f"artifact_{h[-4:]}"].tobytes()
        with open(os.path.join(d, "cache_journal.jsonl"), "rb") as f:
            assert f.read() == ref["journal"].tobytes()

    def test_roundtrip_torn_tail_and_verify(self, tmp_path):
        from psrsigsim_torch.serve import ResultCache

        d = str(tmp_path / "c")
        c = ResultCache(d)
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.put("aa" * 32, arr)
        c.put("bb" * 32, np.ones(4, np.float32))
        c.close()
        with open(os.path.join(d, "cache_journal.jsonl"), "a") as f:
            f.write('{"e": "put", "hash": "torn')  # no newline: torn write
        c2 = ResultCache(d)
        assert c2.get("aa" * 32).tobytes() == arr.tobytes()
        c2.put("cc" * 32, np.ones(3, np.float32))
        c2.close()
        path = os.path.join(d, "results", "aa" * 32 + ".npy")
        with open(path, "r+b") as f:
            f.seek(-2, os.SEEK_END)
            f.write(b"XX")
        c3 = ResultCache(d, verify=True)
        assert c3.verified == 2 and c3.dropped == 1
        assert c3.get("aa" * 32) is None      # recompute, don't serve corrupt
        assert c3.get("cc" * 32) is not None
        c3.close()


# ---------------------------------------------------------------------------
# admission control, deadlines, drain
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_queue_full_rejects_with_retry_after(self, hw):
        from psrsigsim_torch.serve import RequestRejected

        svc = _service(widths=(1,), max_queue=0)
        try:
            with pytest.raises(RequestRejected) as err:
                svc.submit(SPEC)
            assert err.value.retry_after_s > 0 and svc.rejected == 1
        finally:
            svc.close()

    def test_injected_reject_then_success(self, tmp_path, hw):
        from psrsigsim_torch.runtime import FaultPlan
        from psrsigsim_torch.serve import RequestRejected

        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"serve.reject": {"times": 1}})
        svc = _service(tmp_path, faults=plan)
        try:
            with pytest.raises(RequestRejected):
                svc.submit(SPEC)
            rid, _ = svc.submit(SPEC)
            assert svc.result(rid, timeout=120).shape[0] == SPEC["nchan"]
            assert plan.shots_fired("serve.reject") == 1
        finally:
            svc.close()

    def test_deadlines_shed_expire_and_tighten(self, monkeypatch, hw):
        from psrsigsim_torch.serve import RequestFailed, RequestRejected

        svc = _service(widths=(1,), batch_window_s=0.0)
        gate = threading.Event()
        real_execute = svc._execute

        def gated_execute(batch):
            gate.wait(30)
            real_execute(batch)

        try:
            svc.warmup(SPEC)
            calls = svc.registry.device_calls
            # hopeless at submit time: shed, no queue slot, no device time
            with pytest.raises(RequestRejected) as err:
                svc.submit(dict(SPEC, seed=501), deadline_s=-1.0)
            assert "unmeetable" in err.value.reason and svc.shed == 1
            monkeypatch.setattr(svc, "_execute", gated_execute)
            rid1, _ = svc.submit(dict(SPEC, seed=700))   # holds the batcher
            time.sleep(0.05)
            rid2, st2 = svc.submit(dict(SPEC, seed=701), deadline_s=0.05)
            assert st2 == "queued"
            rid3, st3 = svc.submit(dict(SPEC, seed=701), deadline_s=-1.0)
            assert rid3 == rid2 and st3 == "queued"      # coalesced
            time.sleep(0.1)
            gate.set()
            with pytest.raises(RequestFailed) as err:
                svc.result(rid2, timeout=30)
            assert err.value.status == "expired" and svc.expired == 1
            svc.result(rid1, timeout=120)
            assert svc.registry.device_calls == calls + 1
        finally:
            gate.set()
            svc.close()

    def test_drain_rejects_new_work_and_finishes_queue(self, hw):
        from psrsigsim_torch.serve import RequestRejected

        svc = _service(batch_window_s=0.05)
        rid, _ = svc.submit(SPEC)
        assert svc.drain(timeout=120)
        assert svc.result(rid, timeout=1).shape[0] == SPEC["nchan"]
        with pytest.raises(RequestRejected) as err:
            svc.submit(dict(SPEC, seed=777))
        assert err.value.draining
        svc.close()

    def test_poisoned_batch_fails_request_not_engine(self, monkeypatch, hw):
        import psrsigsim_torch.serve.service as service_mod
        from psrsigsim_torch.serve import RequestFailed

        svc = _service(widths=(1,))
        try:
            def boom(canonical):
                raise RuntimeError("synthetic geometry failure")

            monkeypatch.setattr(service_mod, "build_geometry", boom)
            rid, _ = svc.submit(dict(SPEC, seed=600))
            with pytest.raises(RequestFailed) as err:
                svc.result(rid, timeout=30)
            assert "synthetic geometry failure" in err.value.detail
            monkeypatch.undo()
            monkeypatch.setenv("PSS_SAMPLER", "hw")
            rid2, _ = svc.submit(dict(SPEC, seed=601))
            assert svc.result(rid2, timeout=120) is not None
        finally:
            svc.close()


class TestIntegrity:
    @pytest.mark.parametrize("point", ["device.sdc", "host.corrupt"])
    def test_fault_heals_to_the_clean_bytes(self, tmp_path, point, hw):
        from psrsigsim_torch.runtime import FaultPlan

        clean = _service(widths=(1,))
        try:
            rid, _ = clean.submit(SPEC)
            want = clean.result(rid, timeout=120)
        finally:
            clean.close()
        plan = FaultPlan(str(tmp_path / "scratch"), {point: {"times": 1}})
        svc = _service(widths=(1,), integrity=1.0, faults=plan)
        try:
            rid, _ = svc.submit(SPEC)
            got = svc.result(rid, timeout=120)
            st = svc.integrity.stats()
        finally:
            svc.close()
        assert plan.shots_fired(point) == 1
        assert got.tobytes() == want.tobytes()
        assert st["healed_chunks"] == 1
        assert st["sdc_suspect"] == (point == "device.sdc")


# ---------------------------------------------------------------------------
# HTTP front ends (loopback)
# ---------------------------------------------------------------------------


def _post(base, path, obj, timeout=120):
    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path, timeout=120):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _raw(base, path, data=None, timeout=60):
    req = urllib.request.Request(
        base + path,
        data=(json.dumps(data).encode() if data is not None else None),
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="class")
def servers(tmp_path_factory):
    """ONE service behind BOTH front ends at once."""
    from psrsigsim_torch.serve.aio import AioHTTPServer
    from psrsigsim_torch.serve.http import make_server

    os.environ["PSS_SAMPLER"] = "hw"
    cache = tmp_path_factory.mktemp("serve_http") / "cache"
    srv_t = make_server(port=0, cache_dir=str(cache), widths=(1, 8),
                        batch_window_s=0.002, device="cpu")
    svc = srv_t.service
    svc.warmup(SPEC)
    srv_a = AioHTTPServer(port=0, service=svc, max_conns=64)
    for s in (srv_t, srv_a):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    srv_a._started.wait(5)
    yield (f"http://127.0.0.1:{srv_t.server_port}",
           f"http://127.0.0.1:{srv_a.server_port}", svc)
    srv_a.shutdown()
    srv_t.shutdown()
    svc.close()
    srv_a.server_close()
    srv_t.server_close()
    os.environ.pop("PSS_SAMPLER", None)


class TestHTTP:
    def test_simulate_wait_status_result_metrics(self, servers):
        base, _, _ = servers
        code, body, _ = _post(base, "/simulate", dict(SPEC, wait=120))
        assert code == 200 and body["status"] == "done"
        rid = body["id"]
        assert body["shape"] == [SPEC["nchan"], len(body["profile"][0])]
        assert _get(base, "/status/" + rid)[1]["status"] == "done"
        code, res = _get(base, "/result/" + rid)
        assert code == 200 and res["dtype"] == "float32"
        code, health = _get(base, "/healthz")
        assert code == 200 and health["ok"] and health["programs"] == 2
        code, m = _get(base, "/metrics")
        assert code == 200 and "request_p99_s" in m["stages"]
        assert m["programs"]["bucket_calls"] and m["cache"]["entries"] >= 1

    def test_async_submit_then_poll(self, servers):
        base, _, _ = servers
        code, body, _ = _post(base, "/simulate", dict(SPEC, seed=41))
        assert code in (200, 202)
        deadline = time.time() + 120
        while time.time() < deadline:
            code, _ = _get(base, "/result/" + body["id"])
            if code == 200:
                break
            assert code == 409      # pending, not an error
            time.sleep(0.02)
        assert code == 200

    def test_bad_requests(self, servers):
        base, _, _ = servers
        code, body, _ = _post(base, "/simulate", {"nchan": "x"})
        assert code == 400 and any("nchan" in e for e in body["fields"])
        assert _get(base, "/status/" + "0" * 64)[0] == 404
        assert _get(base, "/result/" + "0" * 64)[0] == 404
        code, body, _ = _post(base, "/simulate", [1, 2])
        assert code == 400 and "JSON object" in body["error"]
        assert _post(base, "/simulate", dict(SPEC, wait="soon"))[0] == 400
        assert _get(base, "/healthz")[0] == 200

    def test_injected_reject_maps_to_429(self, tmp_path, hw):
        from psrsigsim_torch.runtime import FaultPlan
        from psrsigsim_torch.serve.http import make_server

        plan = FaultPlan(str(tmp_path / "scratch"),
                         {"serve.reject": {"times": 1}})
        srv = make_server(port=0, cache_dir=None, widths=(1,), faults=plan,
                          device="cpu")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_port}"
        try:
            code, _, headers = _post(base, "/simulate", dict(SPEC))
            assert code == 429 and "Retry-After" in headers
            assert _post(base, "/simulate", dict(SPEC, wait=120))[0] == 200
        finally:
            srv.shutdown()
            srv.service.close()
            srv.server_close()


class TestAioFrontend:
    def test_bodies_byte_identical_across_front_ends(self, servers):
        base_t, base_a, _ = servers
        code, body = _raw(base_a, "/simulate", dict(SPEC, seed=311,
                                                    wait=120))
        assert code == 200 and json.loads(body)["status"] == "done"
        rid = json.loads(body)["id"]
        for path in (f"/result/{rid}", f"/status/{rid}", f"/result/{rid}",
                     "/result/" + "0" * 64, "/status/" + "0" * 64):
            assert _raw(base_t, path) == _raw(base_a, path), path
        assert (_raw(base_t, "/simulate", {"nchan": "x"})
                == _raw(base_a, "/simulate", {"nchan": "x"}))

    def test_keep_alive_pipelined_and_malformed(self, servers):
        _, base_a, _ = servers
        code, body = _raw(base_a, "/simulate", dict(SPEC, seed=77, wait=120))
        rid = json.loads(body)["id"]
        host, port = base_a.split("//")[1].split(":")
        s = socket.create_connection((host, int(port)), timeout=30)
        s.sendall(f"GET /result/{rid} HTTP/1.1\r\nHost: t\r\n\r\n".encode()
                  * 3)
        buf = b""
        deadline = time.time() + 30
        while buf.count(b"HTTP/1.1 200") < 3 and time.time() < deadline:
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
        s.close()
        assert buf.count(b"HTTP/1.1 200") == 3
        s = socket.create_connection((host, int(port)), timeout=10)
        s.sendall(b"garbage\r\n\r\n")
        assert b"400" in s.recv(65536)
        s.close()

    def test_frontend_gauges_and_on_done(self, servers):
        _, base_a, svc = servers
        h = json.loads(_raw(base_a, "/healthz")[1])
        assert h["frontend"]["kind"] == "aio" and "open_connections" in h
        m = json.loads(_raw(base_a, "/metrics")[1])
        assert "loop_lag_s" in m["frontend"]
        rid, _ = svc.submit(dict(SPEC, seed=9119))
        fired = []
        svc.on_done(rid, lambda: fired.append("a"))
        svc.result(rid, timeout=120)
        deadline = time.time() + 10
        while not fired and time.time() < deadline:
            time.sleep(0.01)
        assert fired == ["a"]
        svc.on_done(rid, lambda: fired.append("b"))          # already done
        svc.on_done("0" * 64, lambda: fired.append("c"))     # unknown
        assert fired == ["a", "b", "c"]

    def test_connection_limit_rejects_with_503(self, tmp_path, hw):
        from psrsigsim_torch.serve.aio import AioHTTPServer

        svc = _service(tmp_path)
        srv = AioHTTPServer(port=0, service=svc, max_conns=2)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        srv._started.wait(5)
        held = [socket.create_connection(("127.0.0.1", srv.server_port))
                for _ in range(2)]
        try:
            deadline = time.time() + 10
            while len(srv._conns) < 2 and time.time() < deadline:
                time.sleep(0.02)
            s3 = socket.create_connection(("127.0.0.1", srv.server_port))
            s3.settimeout(10)
            data = s3.recv(4096)
            assert b"503" in data and b"connection limit" in data
            s3.close()
            assert srv.overflow_rejects >= 1
        finally:
            for s in held:
                s.close()
            srv.shutdown()
            svc.close()
            srv.server_close()


# ---------------------------------------------------------------------------
# kill / resume of `python -m psrsigsim_torch.serve --device cpu`
# ---------------------------------------------------------------------------


def _launch(cache_dir, *extra):
    env = dict(os.environ, PSS_SAMPLER="hw", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    spec_path = os.path.join(str(cache_dir) + "_warm.json")
    with open(spec_path, "w") as f:
        json.dump(SPEC, f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "psrsigsim_torch.serve", "--device", "cpu",
         "--port", "0", "--widths", "1,8", "--cache-dir", str(cache_dir),
         "--warmup", spec_path, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=ROOT)
    ready = json.loads(proc.stdout.readline())
    assert ready["ready"]
    return proc, f"http://127.0.0.1:{ready['port']}"


@pytest.mark.faults
class TestKillResume:
    def test_sigkilled_server_resumes_with_cache_intact(self, tmp_path):
        """serve.kill SIGKILLs the server right after the 2nd artifact
        commit; the relaunch verifies the cache and serves the committed
        results with no device call, and re-executes the rest."""
        cache_dir = tmp_path / "cache"
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps({
            "scratch_dir": str(tmp_path / "scratch"),
            "spec": {"serve.kill": {"after_puts": 2}}}))
        proc, base = _launch(cache_dir, "--fault-plan", str(plan))
        specs = [dict(SPEC, seed=100 + i, dm=10.0 + 0.5 * i)
                 for i in range(4)]
        interrupted = []
        for i, spec in enumerate(specs):
            try:
                assert _post(base, "/simulate", dict(spec, wait=120))[0] \
                    == 200
            except (urllib.error.URLError, ConnectionError, OSError):
                interrupted.append(i)
                break
        proc.wait(timeout=60)
        assert proc.returncode == -signal.SIGKILL and interrupted
        journal = (cache_dir / "cache_journal.jsonl").read_text()
        assert len(journal.splitlines()) == 2

        proc2, base = _launch(cache_dir, "--verify-cache")
        try:
            for i in range(2):
                code, body, _ = _post(base, "/simulate",
                                      dict(specs[i], wait=120))
                assert code == 200 and body["cached"] is True
            _, m = _get(base, "/metrics")
            assert m["programs"]["device_calls"] == 0
            assert m["cache"]["hits"] >= 2
            for i in range(2, 4):
                code, body, _ = _post(base, "/simulate",
                                      dict(specs[i], wait=120))
                assert code == 200 and body["status"] == "done"
            assert _get(base, "/metrics")[1]["programs"]["device_calls"] >= 1
        finally:
            proc2.send_signal(signal.SIGTERM)
            assert proc2.wait(timeout=60) == 0      # drained on SIGTERM


def test_serve_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; import psrsigsim_torch.serve, "
            "psrsigsim_torch.serve.__main__, psrsigsim_torch.runtime.programs; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'psrsigsim_tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


if __name__ == "__main__":
    _child(sys.argv[1])
