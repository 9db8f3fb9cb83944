"""The port's fold-mode main path against the JAX package, on the CPU.

Same objects and seeds go through both packages; the port runs on
``device="cpu"`` with the threefry sampler, the only one the reference has
off a TPU.  Tolerances and why:

* ``build_fold_config``: host float64 arithmetic in both — every field
  equal, the portrait bit-equal, the noise scale equal.
* quantizer, byte swap and packing: the same IEEE operations on the same
  float block — bit-exact.
* ``fourier_shift`` and ``fold_pipeline``: the two FFT libraries (XLA's
  and PocketFFT) round differently, ~2e-7 of the portrait's peak — rtol
  1e-5.  The χ² fields themselves are bit-exact (tests/test_torch_rng.py).
* end-to-end int16 codes: those FFT ulps move a row's min or max by an ulp
  now and then, which shifts the row's scale and offset by an ulp and
  flips codes that sit within a fraction of an LSB of a rounding
  boundary — measured at 0.3-0.5% of codes on these geometries, never by
  more than 1 LSB.  Bound: at most 1 LSB, on at most 1% of codes, with
  scl/offs within rtol 1e-5.

Reference values come from a child process (this file run as a script)
that applies the JAX-version shim the reference needs for its traced-DM
path; the shim never touches the pytest worker.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_OBS = 6
SEED = 3


def _geometry(pkg, kind):
    """The same configured objects from either package.

    ``readme``: the README's J1713+0747 fold geometry (64 channels,
    Nph 935, 30 x 2 s subints) on the GBT's Lband_GUPPI system.
    ``readme16``: the same, cut to 16 channels and 4 subints (ensemble
    tests).  ``j1713``: BASELINE config 1's measured J1713 template
    (DataProfile) geometry with the TestScope/TestSys telescope, cut to
    16 channels and 4 subints of 60 s.  ``config2``: BASELINE config 2
    (bench.py ``config2_fold2048``: 2048 channels over 800 MHz, 2048
    bins, 8 x 30 s subints, the default Gaussian portrait), full width.
    """
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    if kind == "j1713":
        sig = S.FilterBankSignal(1380.0, 400.0, Nsubband=16, sample_rate=0.4096,
                                 fold=True, sublen=60.0)
        here = os.path.dirname(os.path.abspath(__file__))
        prof = np.load(os.path.join(here, "..", "psrsigsim_tpu", "data",
                                    "J1713+0747_profile.npy"))
        psr = P.Pulsar(0.005, 0.009, P.DataProfile(prof, phases=None, Nchan=16),
                       name="BENCH", seed=0)
        sig._tobs = U.make_quant(240.0, "s")
        sig._dm = U.make_quant(15.9, "pc/cm^3")
        tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="TestScope")
        tel.add_system("TestSys", T.Receiver(fcent=1380, bandwidth=400,
                                             name="TestRCVR"),
                       T.Backend(samprate=12.5, name="TestBack"))
        return sig, psr, tel, "TestSys"
    if kind == "config2":
        sig = S.FilterBankSignal(1380.0, 800.0, Nsubband=2048,
                                 sample_rate=0.4096, fold=True, sublen=30.0)
        psr = P.Pulsar(0.005, 0.005, P.GaussPortrait(peak=0.5, width=0.05, amp=1.0),
                       name="BENCH", seed=0)
        sig._tobs = U.make_quant(240.0, "s")
        sig._dm = U.make_quant(13.3, "pc/cm^3")
        tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="TestScope")
        tel.add_system("TestSys", T.Receiver(fcent=1380, bandwidth=800,
                                             name="TestRCVR"),
                       T.Backend(samprate=12.5, name="TestBack"))
        return sig, psr, tel, "TestSys"
    nchan, tobs = (64, 60.0) if kind == "readme" else (16, 8.0)
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=nchan, sample_rate=0.2048,
                             fold=True, sublen=2.0)
    psr = P.Pulsar(0.00457, 0.03, P.GaussProfile(peak=0.5, width=0.02),
                   name="J1713+0747", seed=0)
    sig._tobs = U.make_quant(tobs, "s")
    sig._dm = U.make_quant(15.99, "pc/cm^3")
    return sig, psr, T.GBT(), "Lband_GUPPI"


def _child(out):
    """Reference values from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.quantize import subint_quantize, swap16
    from psrsigsim_tpu.ops.shift import fourier_shift
    from psrsigsim_tpu.parallel import FoldEnsemble
    from psrsigsim_tpu.simulate import build_fold_config, fold_pipeline

    res = {}
    for kind in ("readme", "j1713", "config2"):
        cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_tpu", kind))
        res[f"cfg_{kind}"] = np.array(json.dumps(dataclasses.asdict(cfg)))
        res[f"prof_{kind}"] = prof
        res[f"nn_{kind}"] = np.float64(nn)

    # Fourier shift of the README portrait: host delays and traced delays
    cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_tpu", "readme16"))
    freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
    delays = (np.float32(4149377.593360996) * np.float32(15.99)) / (freqs * freqs)
    res["shift_host"] = np.asarray(fourier_shift(jnp.asarray(prof), delays,
                                                 dt=cfg.dt_ms))
    res["shift_traced"] = np.asarray(jax.jit(
        lambda p, d: fourier_shift(p, d, dt=cfg.dt_ms))(prof, delays))

    # one observation through fold_pipeline: envelope, fft, and nulling.
    # Frequencies go in as arguments, as the ensemble passes them: left to
    # their default they are compile-time constants, and XLA then folds
    # DM_K / f^2 into one constant and rounds the delays differently.
    key = jax.random.key(11)
    res["fold_key"] = np.asarray(jax.random.key_data(key))
    kw = dict(freqs=jnp.asarray(freqs), chan_ids=jnp.arange(freqs.shape[0]))
    args = (key, np.float32(15.99), np.float32(nn), prof)
    res["fold_envelope"] = np.asarray(fold_pipeline(*args, cfg, **kw))
    res["fold_fft"] = np.asarray(fold_pipeline(
        *args, dataclasses.replace(cfg, shift_mode="fft"), **kw))
    res["fold_null"] = np.asarray(fold_pipeline(*args, cfg, **kw,
                                                null_frac=np.float32(0.5)))

    # the ensemble: float run, quantized run, and the packed buffers
    ens = FoldEnsemble(*_geometry("psrsigsim_tpu", "readme16"))
    block = np.asarray(ens.run(N_OBS, seed=SEED))
    res["ens_block"] = block
    d, s, o, fin = ens.run_quantized(N_OBS, seed=SEED, return_finite=True)
    res["ens_data"], res["ens_scl"], res["ens_offs"] = map(np.asarray, (d, s, o))
    res["ens_finite"] = np.asarray(fin)
    keys, dms, norms, scp, pad = ens._prep_inputs(N_OBS, SEED, None, None)
    res["ens_keys"] = np.asarray(jax.random.key_data(keys))[:N_OBS]
    args = ens._program_args(keys, dms, norms, scp)
    res["packed_le"] = np.asarray(ens._run_sharded_quantized_packed(*args)[0])[:N_OBS]
    keys, dms, norms, scp, pad = ens._prep_inputs(N_OBS, SEED, None, None)
    args = ens._program_args(keys, dms, norms, scp)
    res["packed_be"] = np.asarray(ens._run_sharded_quantized_packed_be(*args)[0])[:N_OBS]
    # the quantizer and byte swap on a given float block
    q = [jax.jit(lambda b: subint_quantize(b, cfg.nsub, cfg.nph))(b) for b in block]
    res["q_data"] = np.stack([np.asarray(x[0]) for x in q])
    res["q_scl"] = np.stack([np.asarray(x[1]) for x in q])
    res["q_offs"] = np.stack([np.asarray(x[2]) for x in q])
    res["q_swapped"] = np.asarray(swap16(jnp.asarray(res["q_data"])))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pipeline") / "ref.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    env.pop("PSS_SAMPLER", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def _threefry(monkeypatch):
    monkeypatch.delenv("PSS_SAMPLER", raising=False)
    monkeypatch.delenv("PSS_EXACT_CHI2", raising=False)
    monkeypatch.delenv("PSS_EXACT_SHIFT", raising=False)


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ensemble():
    from psrsigsim_torch.parallel import FoldEnsemble

    return FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"), device="cpu")


def _codes_close(got, want):
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-2


@pytest.mark.parametrize("kind", ["readme", "j1713", "config2"])
def test_build_fold_config_matches_reference(ref, kind):
    from psrsigsim_torch.simulate import build_fold_config

    cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_torch", kind))
    assert dataclasses.asdict(cfg) == json.loads(str(ref[f"cfg_{kind}"]))
    assert prof.dtype == np.float32
    np.testing.assert_array_equal(prof, ref[f"prof_{kind}"])
    assert nn == float(ref[f"nn_{kind}"])


def test_config_from_reference_round_trips(ref):
    from psrsigsim_torch.compat import config_from_reference
    from psrsigsim_torch.simulate import build_fold_config

    fields = json.loads(str(ref["cfg_j1713"]))
    cfg, prof, nn = config_from_reference(fields, ref["prof_j1713"],
                                          float(ref["nn_j1713"]), device="cpu")
    own = build_fold_config(*_geometry("psrsigsim_torch", "j1713"))
    assert cfg == own[0] and nn == own[2]
    np.testing.assert_array_equal(prof.numpy(), own[1])
    with pytest.raises(ValueError):
        config_from_reference(dict(fields, bogus=1), ref["prof_j1713"], 1.0,
                              device="cpu")


@pytest.mark.parametrize("path", ["host", "traced"])
def test_fourier_shift_matches_reference(ref, path):
    from psrsigsim_torch.ops.shift import fourier_shift
    from psrsigsim_torch.simulate import build_fold_config

    cfg, prof, _ = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
    delays = (np.float32(4149377.593360996) * np.float32(15.99)) / (freqs * freqs)
    if path == "traced":
        delays = torch.from_numpy(delays)
    got = fourier_shift(torch.from_numpy(prof), delays, dt=cfg.dt_ms).numpy()
    want = ref[f"shift_{path}"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_quantizer_bit_exact_on_the_same_block(ref):
    from psrsigsim_torch.ops.quantize import (subint_dequantize,
                                              subint_quantize, swap16)
    from psrsigsim_torch.simulate import build_fold_config

    cfg, _, _ = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    block = torch.from_numpy(ref["ens_block"])
    data, scl, offs = subint_quantize(block, cfg.nsub, cfg.nph)
    np.testing.assert_array_equal(data.numpy(), ref["q_data"])
    np.testing.assert_array_equal(scl.numpy(), ref["q_scl"])
    np.testing.assert_array_equal(offs.numpy(), ref["q_offs"])
    sw = swap16(data)
    np.testing.assert_array_equal(sw.numpy(), ref["q_swapped"])
    assert torch.equal(swap16(sw), data)
    np.testing.assert_array_equal(sw.numpy().view(">i2"), ref["q_data"])
    # dequantized values sit within half a code of the block
    deq = subint_dequantize(data, scl, offs)
    err = (deq - block.reshape(N_OBS, -1, cfg.nsub, cfg.nph).transpose(1, 2)).abs()
    assert bool((err <= 0.5 * scl[..., None] * (1 + 1e-3) + 1e-3).all())


@pytest.mark.parametrize("order", ["le", "be"])
def test_packing_matches_reference_half_order(ref, order):
    """The reference's packed buffer, split on the host and packed again by
    the port, is bit-identical: the float32 columns ride as native-order
    int16 halves in both."""
    from psrsigsim_torch.ops.quantize import pack_triple
    from psrsigsim_torch.parallel.ensemble import _split_packed_chunk

    packed = ref[f"packed_{order}"]
    nbin = packed.shape[-1] - 4
    d, s, o = _split_packed_chunk(packed, nbin)
    again = pack_triple(torch.from_numpy(np.ascontiguousarray(d)),
                         torch.from_numpy(s), torch.from_numpy(o))
    np.testing.assert_array_equal(again.numpy(), packed)
    # the low half of each float32 comes first
    lo = (s.view(np.uint32) & 0xFFFF).astype(np.uint16).view(np.int16)
    np.testing.assert_array_equal(packed[..., nbin], lo)


@pytest.mark.parametrize("mode", ["envelope", "fft", "null"])
def test_fold_pipeline_matches_reference(ref, mode):
    from psrsigsim_torch.simulate import build_fold_config, fold_pipeline

    cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    kw = {}
    if mode == "fft":
        cfg = dataclasses.replace(cfg, shift_mode="fft")
    if mode == "null":
        kw["null_frac"] = 0.5
    got = fold_pipeline(ref["fold_key"], 15.99, nn, prof, cfg, device="cpu",
                        **kw).numpy()
    want = ref[f"fold_{mode}"]
    assert got.shape == want.shape == (cfg.meta.nchan, cfg.nsamp)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ensemble_keys_match_reference(ref, ensemble):
    keys, _, _ = ensemble._prep_chunk(np.arange(N_OBS), SEED, None, None)
    np.testing.assert_array_equal(keys.numpy(), ref["ens_keys"].astype(np.int64))


def test_ensemble_run_matches_reference(ref, ensemble):
    got = ensemble.run(N_OBS, seed=SEED).numpy()
    np.testing.assert_allclose(got, ref["ens_block"], rtol=1e-5)


def test_ensemble_run_quantized_matches_reference(ref, ensemble):
    d, s, o, fin = ensemble.run_quantized(N_OBS, seed=SEED, return_finite=True)
    assert d.dtype == torch.int16 and d.shape == ref["ens_data"].shape
    _codes_close(d.numpy(), ref["ens_data"])
    np.testing.assert_allclose(s.numpy(), ref["ens_scl"], rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref["ens_offs"], rtol=1e-5)
    np.testing.assert_array_equal(fin.numpy(), ref["ens_finite"])
    assert bool(fin.all())


def test_ensemble_j1713_template_matches_reference_codes(ref):
    """The config-1 template geometry end to end against the reference's
    staged config (carried across with config_from_reference)."""
    from psrsigsim_torch.compat import config_from_reference
    from psrsigsim_torch.parallel import FoldEnsemble

    cfg, prof, nn = config_from_reference(json.loads(str(ref["cfg_j1713"])),
                                          ref["prof_j1713"],
                                          float(ref["nn_j1713"]), device="cpu")
    ens = FoldEnsemble.from_config(cfg, prof, nn, dm=15.9, device="cpu")
    d, s, o = ens.run_quantized(2, seed=SEED)
    assert d.shape == (2, cfg.nsub, cfg.meta.nchan, cfg.nph)
    assert bool(torch.isfinite(s).all()) and bool((s > 0).all())


@pytest.mark.parametrize("order", ["little", "big"])
def test_iter_chunks_packed_matches_reference(ref, ensemble, order):
    (start, (d, s, o, fin)), = list(ensemble.iter_chunks(
        N_OBS, chunk_size=N_OBS, seed=SEED, quantized=True, byte_order=order,
        finite_mask=True))
    from psrsigsim_torch.parallel.ensemble import _split_packed_chunk

    want = ref["packed_le" if order == "little" else "packed_be"]
    wd, ws, wo = _split_packed_chunk(want, ensemble.cfg.nph)
    assert start == 0 and fin.shape == (N_OBS, ensemble.cfg.meta.nchan)
    assert bool(fin.all())
    if order == "big":
        d, wd = d.view(">i2").astype(np.int16), wd.view(">i2").astype(np.int16)
    _codes_close(d, wd)
    np.testing.assert_allclose(s, ws, rtol=1e-5)
    np.testing.assert_allclose(o, wo, rtol=1e-5)


def test_iter_chunks_invariant_to_chunk_size(ensemble):
    runs = {}
    for cs in (2, 3, 6):
        chunks = list(ensemble.iter_chunks(N_OBS, chunk_size=cs, seed=SEED,
                                           quantized=True, byte_order="big",
                                           finite_mask=True))
        assert [c[0] for c in chunks] == list(range(0, N_OBS, cs))
        runs[cs] = [np.concatenate([c[1][i] for c in chunks])
                    for i in range(4)]
    for cs in (3, 6):
        for a, b in zip(runs[2], runs[cs]):
            np.testing.assert_array_equal(a, b)
    # the big-endian chunk reads as run_quantized's codes
    d, s, o = ensemble.run_quantized(N_OBS, seed=SEED)
    np.testing.assert_array_equal(runs[6][0].view(">i2"), d.numpy())
    np.testing.assert_array_equal(runs[6][1], s.numpy())


def test_iter_chunks_float_and_progress(ensemble):
    """Float chunks (the tail chunk trimmed) reassemble into ``run``."""
    chunks = list(ensemble.iter_chunks(N_OBS, chunk_size=4, seed=SEED))
    assert [c[0] for c in chunks] == [0, 4]
    assert [len(c[1]) for c in chunks] == [4, N_OBS - 4]
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]),
                                  ensemble.run(N_OBS, seed=SEED).numpy())
    with pytest.raises(ValueError):
        next(ensemble.iter_chunks(N_OBS, finite_mask=True))


def _quantized_chunks(ens, **kw):
    args = dict(chunk_size=2, seed=SEED, quantized=True, byte_order="big",
                finite_mask=True)
    args.update(kw)
    return list(ens.iter_chunks(N_OBS, **args))


@pytest.mark.parametrize("fetch_ahead", [0, 1, 2])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_iter_chunks_overlap_options_change_no_byte(ensemble, prefetch,
                                                    fetch_ahead):
    """Dispatch-ahead and the fetch thread change no byte, no start and no
    order; progress reaches the total monotonically."""
    seen = []
    got = _quantized_chunks(ensemble, prefetch=prefetch,
                            fetch_ahead=fetch_ahead,
                            progress=lambda d, t: seen.append((d, t)))
    want = _quantized_chunks(ensemble, prefetch=0, fetch_ahead=0)
    assert [c[0] for c in got] == [0, 2, 4]
    for (s0, a), (s1, b) in zip(got, want):
        assert s0 == s1
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    done = [d for d, _ in seen]
    assert done == sorted(done) and seen[-1] == (N_OBS, N_OBS)


@pytest.mark.parametrize("fetch_ahead", [0, 2])
def test_iter_chunks_skip_chunk_skips_the_work(ensemble, monkeypatch,
                                               fetch_ahead):
    """A skipped chunk is never computed, yields nothing, and still moves
    the progress counter."""
    calls = []
    real = type(ensemble)._quantized_packed

    def counted(self, keys, *a, **k):
        calls.append(int(keys.shape[0]))
        return real(self, keys, *a, **k)

    monkeypatch.setattr(type(ensemble), "_quantized_packed", counted)
    seen = []
    got = _quantized_chunks(ensemble, fetch_ahead=fetch_ahead,
                            skip_chunk=lambda s, c: s != 2,
                            progress=lambda d, t: seen.append(d))
    assert calls == [2]
    assert [c[0] for c in got] == [2]
    assert seen == sorted(seen) and seen[-1] == N_OBS
    want = _quantized_chunks(ensemble)[1][1]
    for x, y in zip(got[0][1], want):
        np.testing.assert_array_equal(x, y)


def test_iter_chunks_fetch_error_reaches_the_consumer(ensemble):
    """An error in the fetch thread is raised in the consumer, and the
    thread is gone afterwards; abandoning the generator stops it too."""
    import threading

    from psrsigsim_torch.runtime import StageTimers

    class Broken(StageTimers):
        def add(self, stage, seconds, nbytes=0):
            if stage == "fetch" and threading.current_thread().name \
                    == "pss-chunk-fetch":
                raise OSError("injected fetch failure")
            super().add(stage, seconds, nbytes)

    with pytest.raises(OSError, match="injected fetch failure"):
        _quantized_chunks(ensemble, fetch_ahead=1, timers=Broken())
    gen = ensemble.iter_chunks(N_OBS, chunk_size=2, seed=SEED, quantized=True,
                               fetch_ahead=2)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate()
                if t.name == "pss-chunk-fetch"]


def test_iter_chunks_timers_see_dispatch_and_fetch(ensemble):
    from psrsigsim_torch.runtime import StageTimers

    timers = StageTimers()
    chunks = _quantized_chunks(ensemble, fetch_ahead=2, timers=timers)
    snap = timers.snapshot()
    assert snap["dispatch_calls"] == snap["fetch_calls"] == 3
    assert snap["dispatch_s"] > 0 and snap["fetch_s"] > 0
    cfg = ensemble.cfg
    # the packed buffer, its scl/offs halves gathered on the device, and
    # the finite mask
    rows = N_OBS * cfg.nsub * cfg.meta.nchan
    nbytes = rows * 2 * (cfg.nph + 4) + rows * 8 + N_OBS * cfg.meta.nchan
    assert snap["fetch_bytes"] == nbytes
    assert snap["live_buffer_bytes_gauge"] == 0
    assert snap["fetch_queue_depth_max"] >= 0
    # every chunk's host keys, a child of its dispatch (the observation
    # keys, then the pipeline's stage keys); no span log without a profiler
    assert snap["dispatch.keys_calls"] >= snap["dispatch_calls"]
    assert 0 < snap["dispatch.keys_s"] <= snap["dispatch_s"]
    assert "spans" not in snap and "." not in snap["bottleneck"]


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no card and no explicit device the entry points raise; they
    never fall back to the CPU behind the caller's back."""
    from psrsigsim_torch.compat import config_from_reference
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.simulate import build_fold_config, fold_pipeline
    from psrsigsim_torch.utils import key

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = _geometry("psrsigsim_torch", "readme16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoldEnsemble(*geom)
    with pytest.raises(RuntimeError):
        key(0)
    cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    with pytest.raises(RuntimeError):
        fold_pipeline(np.zeros(2, np.uint32), 15.99, nn, prof, cfg)
    with pytest.raises(RuntimeError):
        config_from_reference(dataclasses.asdict(cfg), prof, nn)


def test_port_never_imports_jax(tmp_path):
    """Every module of the port imports, a small ensemble runs and exports
    two PSRFITS files, and the Simulation façade runs the object-oriented
    flow (pulses, dispersion, nulling, an FD shift, noise) and saves pdv
    text, with jax and the JAX package blocked."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import importlib, importlib.abc, pkgutil, sys
sys.path.insert(0, {root!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'psrsigsim_tpu'):
            raise ImportError('blocked import of ' + name)
sys.meta_path.insert(0, Block())
import psrsigsim_torch
for m in pkgutil.walk_packages(psrsigsim_torch.__path__, 'psrsigsim_torch.'):
    importlib.import_module(m.name)
sys.path.insert(0, {os.path.join(root, 'tests')!r})
from test_torch_pipeline import _geometry
from psrsigsim_torch.parallel import FoldEnsemble
d, s, o = FoldEnsemble(*_geometry('psrsigsim_torch', 'readme16'), device='cpu').run_quantized(1)
assert d.shape[0] == 1
from test_torch_export import TEMPLATE, _geometry as _export_geometry
from psrsigsim_torch.io import FitsFile, export_ensemble_psrfits
ens = FoldEnsemble(*_export_geometry('psrsigsim_torch'), device='cpu')
paths = export_ensemble_psrfits(ens, 2, 'out', TEMPLATE, ens.pulsar, writers=1)
assert len(paths) == 2 and FitsFile.read(paths[1])['SUBINT'].data['DATA'].shape[0] == 2
from test_torch_simulate import PARS
from psrsigsim_torch.ism import ISM
from psrsigsim_torch.simulate import Simulation
sim = Simulation(psrdict=PARS, device='cpu')
sim.simulate()
assert len(sim.pulsar.null(sim.signal, 0.25)) == 1
ISM().FD_shift(sim.signal, [1e-5])
sim.save_simulation(outfile='s.pdv', out_format='pdv')
assert sim.signal.data.shape == (16, 4096)
assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'psrsigsim_tpu') for k in sys.modules)
print('clean')
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-3000:]


if __name__ == "__main__":
    _child(sys.argv[1])
