"""The port's baseband path (coherent dedispersion, the overlap-save plan,
the channelizer, ``BasebandSignal``/``RFSignal``, amplitude pulses and
noise, ``build_baseband_config`` and ``baseband_pipeline``) against the JAX
package, and against itself, on the CPU.

Geometry: BASELINE config 3 (bench.py ``build_baseband_workload``:
``BasebandSignal(1400, 100, sample_rate=200)``, P = 5 ms, 20 ms, DM 13.3)
for the configuration and its overlap-save plan; the pipeline and the
object-oriented flow at a 4 MHz band sampled at 8 MHz (P = 5 ms, 10 ms:
2 x 80,000 samples, a three-block plan).  Tolerances and why:

* host planes (a concrete DM), the overlap-save plans and the configs:
  float64 host arithmetic in both, equal;
* the double-float cycles of a per-observation DM: the same IEEE
  operations, the product's low term fused as XLA compiles it — bit-equal;
  the planes' ``cos``/``sin``: the port rounds the float64 trig of the
  float32 phase, XLA evaluates its float32 polynomial — within 1 ulp
  (measured: on 1.3% of the bins), DIVERGENCES P16;
* the threefry flat normals of the pulse and noise stages, and the
  amplitude block before dispersion: bit-exact (P2);
* everything after an FFT (the dispersed block, the pipeline's output,
  the channelizer's powers): within rtol 1e-5 plus 1e-5 of the peak — the
  two FFT libraries round apart by ulps (the fold pipeline's gate).

Reference values come from a child process (this file run as a script)
that applies the JAX-version shims R1 and R2.
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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_toa import child_env, shims  # noqa: E402

SEED = 7
DMS = [13.3, 20.0, 7.5]
NORM_SCALE = [1.0, 1.3, 0.7]
N_TRANSFER = 1 << 16
# (fcent, bw, dt_us) of the small band and the plan cases (nsamp, dm_max)
BAND = (1400.0, 4.0, 0.125)
PLANS = [("config3", 4_000_000, 13.3, 1400.0, 100.0, 0.005),
         ("three_blocks", 80_000, 13.3) + BAND,
         ("one_block_wide_halo", 3000, 13.3) + BAND,
         ("pow2", 1 << 16, 13.3) + BAND,
         ("too_wide", 1000, 400.0) + BAND]
CHAN_CASES = [(64, 2 * 64 * 100 + 37), (7, 1000)]


def _objects(pkg, sample_rate=8.0, bw=4.0, tobs=0.01, telescope=True):
    """A baseband signal, pulsar and telescope of either package."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu
                                       else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    kw = {} if tpu else {"device": "cpu"}
    sig = S.BasebandSignal(1400, bw, sample_rate=sample_rate, **kw)
    psr = P.Pulsar(0.005, 0.05, P.GaussProfile(width=0.05), name="BENCH",
                   seed=0)
    sig._tobs = U.make_quant(tobs, "s")
    tel = None
    if telescope:
        tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="BenchScope")
        tel.add_system("BenchSys", T.Receiver(fcent=1400, bandwidth=bw,
                                              name="R"),
                       T.Backend(samprate=12.5, name="B"))
    return sig, psr, tel


def _data(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _config_dict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.models.ism import ISM
    from psrsigsim_tpu.ops.channelize import channelize_power
    from psrsigsim_tpu.ops.dfloat import df_mod1, df_mul_f32, split_f64
    from psrsigsim_tpu.ops.shift import (coherent_dedisperse,
                                         coherent_dedisperse_os,
                                         coherent_dedispersion_transfer,
                                         plan_dedisperse_os)
    from psrsigsim_tpu.ops.stats import flat_normal_field
    from psrsigsim_tpu.simulate.pipeline import (_tile_periodic,
                                                 baseband_pipeline,
                                                 build_baseband_config)
    from psrsigsim_tpu.telescope import Receiver
    from psrsigsim_tpu.utils.rng import stage_key

    res, meta = {}, {}
    dms = jnp.asarray(DMS, jnp.float32)
    fc, bw, dt = BAND

    # the transfer function, three branches
    res["host_re"], res["host_im"] = coherent_dedispersion_transfer(
        N_TRANSFER, 13.3, fc, bw, dt)
    re, im = jax.jit(jax.vmap(lambda d: coherent_dedispersion_transfer(
        N_TRANSFER, d, fc, bw, dt)))(dms)
    res["df_re"], res["df_im"] = np.asarray(re), np.asarray(im)
    f = np.fft.rfftfreq(N_TRANSFER, d=dt) - bw / 2.0
    c = 1.0e6 / 2.41e-4 * f**2 / ((f + fc) * fc**2)
    c_hi, c_lo = split_f64(c)
    res["df_cycles"] = np.asarray(jax.jit(jax.vmap(lambda d: df_mod1(
        *df_mul_f32(d, jnp.asarray(c_hi), jnp.asarray(c_lo)))))(dms))
    re, im = jax.jit(lambda d, a, b, t: coherent_dedispersion_transfer(
        4096, d, a, b, t))(jnp.float32(1.5), jnp.float32(fc),
                           jnp.float32(bw), jnp.float32(dt))
    res["f32_re"], res["f32_im"] = np.asarray(re), np.asarray(im)

    meta["plans"] = {name: plan_dedisperse_os(*args)
                     for name, *args in PLANS}

    # coherent_dedisperse: the rFFT form (concrete data and DM), the
    # packed form (per-observation DM, even n), the rFFT form of a DM
    # tensor (odd n)
    x = _data((3, 2, 4096))
    res["cd_host"] = np.asarray(coherent_dedisperse(x, 13.3, fc, bw, dt))
    res["cd_packed"] = np.asarray(jax.jit(jax.vmap(
        lambda a, d: coherent_dedisperse(a, d, fc, bw, dt)))(x, dms))
    xo = _data((3, 3, 4095), seed=2)
    res["cd_odd"] = np.asarray(jax.jit(jax.vmap(
        lambda a, d: coherent_dedisperse(a, d, fc, bw, dt)))(xo, dms))
    for name, n, *args in PLANS[1:3]:
        plan = plan_dedisperse_os(n, *args)
        xs = _data((3, 2, n), seed=3)
        res[f"os_{name}"] = np.asarray(jax.jit(jax.vmap(
            lambda a, d, p=plan: coherent_dedisperse_os(
                a, d, fc, bw, dt, p)))(xs, dms))

    for nchan, n in CHAN_CASES:
        res[f"chan_{nchan}"] = np.asarray(channelize_power(
            _data((2, n), seed=4), nchan))

    # configs: BASELINE config 3 (bench.py) and the small band with noise
    sig, psr, _ = _objects("psrsigsim_tpu", 200.0, 100.0, 0.02, False)
    cfg, sp, nn = build_baseband_config(sig, psr, dm_max=13.3)
    meta["cfg3"], res["sprof3"], res["nn3"] = dataclasses.asdict(cfg), sp, nn
    from psrsigsim_tpu.utils import make_quant

    sig, psr, tel = _objects("psrsigsim_tpu")
    sig._dm = make_quant(13.3, "pc/cm^3")
    cfg, sp, nn = build_baseband_config(sig, psr, tel, "BenchSys")
    meta["cfg"], res["sprof"], res["nn"] = dataclasses.asdict(cfg), sp, nn
    cfg_exact = dataclasses.replace(cfg, os_plan=None)

    keys = jax.vmap(lambda i: stage_key(jax.random.key(SEED), "user", i))(
        jnp.arange(3))
    res["keys"] = np.asarray(jax.random.key_data(keys))
    nns = jnp.asarray(NORM_SCALE, jnp.float32) * jnp.float32(nn)
    npol, nsamp = sp.shape[0], cfg.nsamp
    for label, c, norms in (("plan", cfg, nns), ("exact", cfg_exact, nns),
                            ("quiet", cfg, jnp.zeros(3, jnp.float32))):
        res[f"pipe_{label}"] = np.asarray(jax.jit(jax.vmap(
            lambda k, d, s, c=c: baseband_pipeline(k, d, s, jnp.asarray(sp),
                                                   c)))(keys, dms, norms))
    res["amp"] = np.asarray(jax.jit(jax.vmap(lambda k: _tile_periodic(
        jnp.asarray(sp), nsamp) * flat_normal_field(
            stage_key(k, "pulse"), 0, npol * nsamp).reshape(npol, nsamp)))(
                keys))
    res["noise"] = np.asarray(jax.jit(jax.vmap(lambda k: flat_normal_field(
        stage_key(k, "noise"), 0, npol * nsamp)))(keys))

    # the object-oriented flow
    sig, psr, tel = _objects("psrsigsim_tpu")
    psr.make_pulses(sig, tobs=0.01)
    res["oo_pulses"] = np.asarray(sig.data)
    ISM().disperse(sig, 13.3)
    res["oo_dispersed"] = np.asarray(sig.data)
    Receiver(fcent=1400, bandwidth=4.0, seed=3).radiometer_noise(
        sig, psr, gain=2.0, Tsys=35.0)
    res["oo_noisy"] = np.asarray(sig.data)
    fb = sig.to_FilterBank(64)
    res["oo_fb"] = np.asarray(fb.data)
    k = Receiver(fcent=1400, bandwidth=4.0, seed=3)._keys.next("noise")
    res["oo_noise_draw"] = np.asarray(jax.random.normal(k, sig.data.shape))
    meta["oo_fb_meta"] = _fb_meta(fb)
    meta["oo_sig"] = [int(sig.nsamp), float(sig._Smax.to("Jy").value)]

    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def _fb_meta(fb):
    return {"nchan": int(fb.Nchan), "samprate": float(fb.samprate.value),
            "nsamp": int(fb.nsamp), "tobs": float(fb.tobs.value),
            "nsub": int(fb.nsub), "sublen": float(fb.sublen.value),
            "smax": float(fb._Smax.to("Jy").value), "dm": float(fb.dm.value),
            "freqs": [float(v) for v in fb.dat_freq.value],
            "sigtype": fb.sigtype, "fold": bool(fb.fold)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_baseband")
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
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
        monkeypatch.delenv(k, raising=False)


def _ulps(got, want):
    def ordered(a):
        i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(got) - ordered(want))


def _close(got, want):
    """Within rtol 1e-5 plus 1e-5 of the block's peak (FFT ulps)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_transfer_function_matches_reference(ref):
    from psrsigsim_torch.ops.dfloat import df_mod1, df_mul_f32_fused, split_f64
    from psrsigsim_torch.ops.shift import coherent_dedispersion_transfer

    fc, bw, dt = BAND
    re, im = coherent_dedispersion_transfer(N_TRANSFER, 13.3, fc, bw, dt)
    assert re.tobytes() == ref["host_re"].tobytes()
    assert im.tobytes() == ref["host_im"].tobytes()

    f = np.fft.rfftfreq(N_TRANSFER, d=dt) - bw / 2.0
    c = 1.0e6 / 2.41e-4 * f**2 / ((f + fc) * fc**2)
    c_hi, c_lo = (torch.from_numpy(p) for p in split_f64(c))
    cycles = df_mod1(*df_mul_f32_fused(torch.tensor(DMS)[:, None], c_hi,
                                       c_lo))
    assert cycles.numpy().tobytes() == ref["df_cycles"].tobytes()
    re, im = coherent_dedispersion_transfer(N_TRANSFER, torch.tensor(DMS),
                                            fc, bw, dt)
    for got, want in ((re, ref["df_re"]), (im, ref["df_im"])):
        u = _ulps(got.numpy(), want)
        assert u.max() <= 1 and (u > 0).mean() < 0.02

    re, im = coherent_dedispersion_transfer(
        4096, torch.tensor(1.5), torch.tensor(fc), torch.tensor(bw),
        torch.tensor(dt))
    np.testing.assert_allclose(re.numpy(), ref["f32_re"], atol=2e-3)
    np.testing.assert_allclose(im.numpy(), ref["f32_im"], atol=2e-3)


@pytest.mark.parametrize("case", [p[0] for p in PLANS])
def test_plan_matches_reference(ref, case):
    from psrsigsim_torch.ops.shift import plan_dedisperse_os

    args = next(p[1:] for p in PLANS if p[0] == case)
    plan = plan_dedisperse_os(*args)
    want = ref["plans"][case]
    assert (None if plan is None else list(plan)) == want
    if case == "config3":
        assert tuple(plan) == (1 << 23, 2194304, 2194304, 4_000_000, 1)
    if case == "three_blocks":
        assert plan.nb == 3
    if case == "one_block_wide_halo":
        assert plan.nb == 1 and plan.hl > 3000 // 2


def test_coherent_dedisperse_forms_match_reference(ref):
    from psrsigsim_torch.ops.shift import coherent_dedisperse

    fc, bw, dt = BAND
    x = torch.from_numpy(_data((3, 2, 4096)))
    _close(coherent_dedisperse(x, 13.3, fc, bw, dt), ref["cd_host"])
    _close(coherent_dedisperse(x, torch.tensor(DMS), fc, bw, dt),
           ref["cd_packed"])
    xo = torch.from_numpy(_data((3, 3, 4095), seed=2))
    _close(coherent_dedisperse(xo, torch.tensor(DMS), fc, bw, dt),
           ref["cd_odd"])


@pytest.mark.parametrize("case", ["three_blocks", "one_block_wide_halo"])
def test_coherent_dedisperse_os_matches_reference(ref, case):
    from psrsigsim_torch.ops.shift import (coherent_dedisperse_os,
                                           plan_dedisperse_os)

    n, *args = next(p[1:] for p in PLANS if p[0] == case)
    plan = plan_dedisperse_os(n, *args)
    x = torch.from_numpy(_data((3, 2, n), seed=3))
    fc, bw, dt = BAND
    _close(coherent_dedisperse_os(x, torch.tensor(DMS), fc, bw, dt, plan),
           ref[f"os_{case}"])


def test_packed_pair_does_not_leak():
    """One stream of a packed pair at zero stays zero, and its partner
    equals the rFFT form alone: H is real at DC and Nyquist."""
    from psrsigsim_torch.ops.shift import coherent_dedisperse

    fc, bw, dt = BAND
    x = torch.from_numpy(_data((2, 4096), seed=5))
    x[1] = 0.0
    dm = torch.tensor(13.3)
    y = coherent_dedisperse(x, dm, fc, bw, dt)
    peak = float(y[0].abs().max())
    assert float(y[1].abs().max()) <= 1e-6 * peak
    alone = coherent_dedisperse(x[:1], 13.3, fc, bw, dt)
    np.testing.assert_allclose(y[0].numpy(), alone[0].numpy(), rtol=0,
                               atol=1e-5 * peak)


@pytest.mark.parametrize("nchan,n", CHAN_CASES)
def test_channelize_power_matches_reference(ref, nchan, n):
    from psrsigsim_torch.ops.channelize import channelize_power

    got = channelize_power(torch.from_numpy(_data((2, n), seed=4)), nchan)
    assert got.shape == (nchan, n // (2 * nchan))
    _close(got, ref[f"chan_{nchan}"])


def test_build_baseband_config_matches_reference(ref):
    from psrsigsim_torch.simulate import build_baseband_config
    from psrsigsim_torch.utils import make_quant

    sig, psr, _ = _objects("psrsigsim_torch", 200.0, 100.0, 0.02, False)
    cfg, sp, nn = build_baseband_config(sig, psr, dm_max=13.3)
    assert _config_dict(cfg) == ref["cfg3"]
    assert sp.tobytes() == ref["sprof3"].tobytes() and nn == 0.0
    assert (cfg.nph, cfg.nsamp, sp.shape[0]) == (1_000_000, 4_000_000, 2)

    sig, psr, tel = _objects("psrsigsim_torch")
    sig._dm = make_quant(13.3, "pc/cm^3")
    cfg, sp, nn = build_baseband_config(sig, psr, tel, "BenchSys")
    assert _config_dict(cfg) == ref["cfg"]
    assert sp.tobytes() == ref["sprof"].tobytes()
    assert nn == float(ref["nn"]) and nn > 0
    exact = build_baseband_config(sig, psr, tel, "BenchSys", exact_fft=True)
    assert exact[0].os_plan is None


@pytest.fixture(scope="module")
def staged():
    from psrsigsim_torch.simulate import build_baseband_config
    from psrsigsim_torch.utils import make_quant

    sig, psr, tel = _objects("psrsigsim_torch")
    sig._dm = make_quant(13.3, "pc/cm^3")
    return build_baseband_config(sig, psr, tel, "BenchSys")


def _keys(ref):
    from psrsigsim_torch.utils import as_key

    return as_key(ref["keys"], "cpu")


@pytest.mark.parametrize("label", ["plan", "exact", "quiet"])
def test_baseband_pipeline_matches_reference(ref, staged, label):
    from psrsigsim_torch.simulate import baseband_pipeline

    cfg, sp, nn = staged
    if label == "exact":
        cfg = dataclasses.replace(cfg, os_plan=None)
    norms = (torch.zeros(3) if label == "quiet"
             else torch.tensor(NORM_SCALE) * np.float32(nn))
    got = baseband_pipeline(_keys(ref), torch.tensor(DMS), norms, sp, cfg,
                            device="cpu")
    assert got.shape == (3, 2, cfg.nsamp)
    _close(got, ref[f"pipe_{label}"])


def test_baseband_draws_are_exact(ref, staged):
    """The amplitude block before dispersion and the noise normals equal
    the JAX package's bytes (threefry flat stream, pol-major)."""
    from psrsigsim_torch.ops.stats import flat_normal_field
    from psrsigsim_torch.simulate.pipeline import _tile_periodic
    from psrsigsim_torch.utils import stage_key

    cfg, sp, _ = staged
    keys = _keys(ref)
    n = 2 * cfg.nsamp
    amp = flat_normal_field(stage_key(keys, "pulse"), 0, n).reshape(
        3, 2, cfg.nsamp)
    _tile_periodic(amp, torch.from_numpy(sp), cfg.nph)
    assert amp.numpy().tobytes() == ref["amp"].tobytes()
    noise = flat_normal_field(stage_key(keys, "noise"), 0, n)
    assert noise.numpy().tobytes() == ref["noise"].tobytes()


def test_object_oriented_flow_matches_reference(ref):
    from psrsigsim_torch.models.ism import ISM
    from psrsigsim_torch.models.telescope import Receiver
    from psrsigsim_torch.ops.stats import normal_sample

    sig, psr, tel = _objects("psrsigsim_torch")
    psr.make_pulses(sig, tobs=0.01)
    assert sig.data.device.type == "cpu"
    assert sig.data.numpy().tobytes() == ref["oo_pulses"].tobytes()
    ISM().disperse(sig, 13.3)
    _close(sig.data, ref["oo_dispersed"])
    Receiver(fcent=1400, bandwidth=4.0, seed=3).radiometer_noise(
        sig, psr, gain=2.0, Tsys=35.0)
    _close(sig.data, ref["oo_noisy"])
    k = Receiver(fcent=1400, bandwidth=4.0, seed=3)._keys.next("noise")
    draw = normal_sample(k, tuple(sig.data.shape))
    assert draw.numpy().tobytes() == ref["oo_noise_draw"].tobytes()
    assert [int(sig.nsamp), float(sig._Smax.to("Jy").value)] == ref["oo_sig"]
    fb = sig.to_FilterBank(64)
    assert fb.data.device.type == "cpu"
    _close(fb.data, ref["oo_fb"])
    assert _fb_meta(fb) == ref["oo_fb_meta"]


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
def test_baseband_pipeline_does_not_depend_on_the_batch(monkeypatch, staged,
                                                        sampler):
    """An observation's block is the same bits in batches of 1, 3 and 8, on
    both samplers (on ``hw`` the flat kernel's plain version)."""
    from psrsigsim_torch.simulate import baseband_pipeline
    from psrsigsim_torch.utils import key, stage_key

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    cfg, sp, nn = staged
    keys = stage_key(key(1, "cpu"), "user", torch.arange(8))
    dms = torch.linspace(5.0, 13.3, 8)
    nns = torch.full((8,), nn, dtype=torch.float32)
    batch = baseband_pipeline(keys, dms, nns, sp, cfg, device="cpu")
    assert batch.shape == (8, 2, cfg.nsamp)
    assert bool(torch.isfinite(batch).all())
    three = baseband_pipeline(keys[2:5], dms[2:5], nns[2:5], sp, cfg,
                              device="cpu")
    assert torch.equal(three, batch[2:5])
    one = baseband_pipeline(keys[6:7], dms[6:7], nns[6:7], sp, cfg,
                            device="cpu")
    assert torch.equal(one[0], batch[6])


def test_signals_and_metadata():
    from psrsigsim_torch.signal import BasebandSignal, RFSignal

    s = BasebandSignal(1400, 400, device="cpu")
    assert s.sigtype == "BasebandSignal" and s.Nchan == 2
    assert float(s.samprate.to("MHz").value) == 800.0
    assert s.to_Baseband() is s
    with pytest.raises(NotImplementedError):
        s.to_RF()
    with pytest.raises(ValueError, match="make_pulses"):
        s.to_FilterBank(8)
    r = RFSignal(1400, 400, device="cpu")
    assert r.sigtype == "RFSignal" and r.to_RF() is r
    assert float(r.samprate.to("MHz").value) == 2 * (1400 + 200)
    for fn in (r.to_Baseband, r.to_FilterBank):
        with pytest.raises(NotImplementedError):
            fn()
    s.data = torch.zeros((2, 100))
    with pytest.raises(ValueError, match="frame"):
        s.to_FilterBank(512)


def test_rf_signal_amplitude_pulses():
    """An RF signal's Nyquist rate is ~3 GHz: a tiny span of pulses."""
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import RFSignal

    sig = RFSignal(1400, 20, device="cpu")
    psr = Pulsar(1e-5, 0.05, GaussProfile(width=0.05), seed=0)
    psr.make_pulses(sig, tobs=2e-6)
    assert sig.data.shape == (2, int(2e-6 * 2820e6))
    assert bool(torch.isfinite(sig.data).all())


def test_observe_refuses_amplitude_signals(staged):
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope

    sig, psr, _ = _objects("psrsigsim_torch", tobs=0.002)
    psr.make_pulses(sig, tobs=0.002)
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="S")
    tel.add_system("sys", Receiver(fcent=1400, bandwidth=4, name="R"),
                   Backend(samprate=12.5, name="B"))
    with pytest.raises(NotImplementedError):
        tel.observe(sig, psr, system="sys", noise=True)


def test_entry_points_need_a_device_without_cuda(monkeypatch, staged):
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import BasebandSignal
    from psrsigsim_torch.simulate import baseband_pipeline
    from psrsigsim_torch.utils import key, stage_key

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, sp, nn = staged
    keys = stage_key(key(1, "cpu"), "user", torch.arange(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baseband_pipeline(keys, torch.tensor([13.3]), torch.tensor([nn]), sp,
                          cfg)
    sig = BasebandSignal(1400, 4.0, sample_rate=8.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pulsar(0.005, 0.05, GaussProfile(), seed=0).make_pulses(sig,
                                                                tobs=0.001)


@pytest.mark.cuda
def test_baseband_on_the_card_matches_the_host(staged):
    """On the card: ``baseband_pipeline`` launches the flat layout twice
    (pulse and noise stages for the whole batch) and equals the host
    (``PSS_SAMPLER=hw``) within the FFT bound."""
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.simulate import baseband_pipeline
    from psrsigsim_torch.utils import key, stage_key

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, sp, nn = staged
    keys = stage_key(key(1, "cpu"), "user", torch.arange(3))
    dms, nns = torch.tensor(DMS), torch.full((3,), nn)
    rng_hw.rng_flat_field.launches = 0
    card = baseband_pipeline(keys, dms, nns, torch.from_numpy(sp).cuda(),
                             cfg).cpu()
    assert rng_hw.rng_flat_field.launches == 2
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        host = baseband_pipeline(keys, dms, nns, sp, cfg, device="cpu")
    finally:
        os.environ.pop("PSS_SAMPLER")
    _close(card, host.numpy())


if __name__ == "__main__":
    _child(sys.argv[1])
