"""The port's object-oriented flow against the JAX package's, on the CPU.

The README's Quickstart (``Pulsar.make_pulses`` → ``ISM().disperse`` →
``GBT().observe``), nulling, the other ISM effects and every resampling
branch of ``Telescope.observe`` run in both packages on the same objects
and seeds (16 channels, at most 2**16 samples per channel); the port runs
on ``device="cpu"``.  Tolerances and why:

* keys, ``split``, ``permutation`` and the nulled pulses: the same integer
  arithmetic — bit-exact.
* ``make_pulses`` and the radiometer noise: χ² draws on jax's threefry
  stream.  The JAX package jits its pulse and noise kernels with df
  static, and the port draws with the arithmetic XLA compiles for them
  (``ops.stats.chi2_sample_compiled``, the noise added by one FMA).  What
  is left is ``erf_inv``, whose normals agree within 2 ulp (the bound of
  tests/test_torch_rng.py): Wilson–Hilferty draws (fold mode) within 2 ulp
  (measured: equal), and χ²(1) = z² (SEARCH mode), which doubles the
  normal's relative error, within 2·2 + 1 = 5 ulp.  XLA's CPU backend flushes float32 subnormals to
  zero and the port does not, so the ulp bounds hold where the reference
  is a normal number; below float32 tiny the two agree within 1e-30 of the
  peak (a subnormal portrait value read as 0 in one, times a draw, in the
  other).
* everything after a Fourier shift (``disperse``, ``FD_shift``,
  ``scatter_broaden``, nulling a dispersed signal, ``observe``): the two
  FFT libraries round differently, ~2e-7 of the peak — rtol 1e-5 with an
  absolute floor of 1e-5 of the peak, as tests/test_torch_pipeline.py holds
  ``fourier_shift``.
* resampling and the device convolution: float32 reductions in another
  order — rtol 1e-5, same floor.

Reference values come from a child process (this file run as a script)
that applies the JAX-version shim the reference needs; the shim never
touches the pytest worker.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PERM_SIZES = (1, 2, 100, 1000, 2**17)
FD_PARAMS = [1e-5, -2e-5, 3e-6]
# backend sample rates that take each branch of observe's resampling for
# the SEARCH signal below (0.2048 MHz, 0.05 s): equal rates, an integer
# factor, a non-integer factor, and a backend faster than the signal
RESAMPLE = {"same": 0.1024, "down": 0.0512, "rebin": 0.04, "pass": 0.3}
RESAMPLED_WIDTH = {"same": 10240, "down": 5120, "rebin": 4000, "pass": 10240}
TINY = float(np.finfo(np.float32).tiny)


def _modules(pkg):
    tpu = pkg == "psrsigsim_tpu"
    m = {n: importlib.import_module(f"{pkg}.{n}")
         for n in ("signal", "pulsar", "ism", "telescope", "utils")}
    m["kw"] = {} if tpu else {"device": "cpu"}
    m["host"] = np.asarray if tpu else (lambda t: t.numpy())
    return m


def _flows(pkg):
    """Every flow of this file in package ``pkg``: a dict of arrays."""
    m = _modules(pkg)
    S, P, I, T, U, kw, host = (m["signal"], m["pulsar"], m["ism"],
                               m["telescope"], m["utils"], m["kw"], m["host"])
    out = {}

    def fold_signal(**k):
        return S.FilterBankSignal(1400.0, 400.0, Nsubband=16, sample_rate=0.2048,
                                  fold=True, sublen=2.0, **kw, **k)

    def search_signal(nchan=16):
        return S.FilterBankSignal(1400.0, 400.0, Nsubband=nchan,
                                  sample_rate=0.2048, fold=False, **kw)

    def pulsar(seed=0, period=0.00457):
        return P.Pulsar(period, 0.03, P.GaussProfile(peak=0.5, width=0.02),
                        name="J1713+0747", seed=seed)

    # the README's Quickstart, cut to 16 channels and 8 s; GBT's receivers
    # draw from the global key sequence
    U.set_seed(0)
    sig, psr = fold_signal(), pulsar()
    psr.make_pulses(sig, tobs=8.0)
    out["qs_pulses"] = host(sig.data)
    I.ISM().disperse(sig, dm=15.99)
    out["qs_disp"] = host(sig.data)
    out["qs_delay"] = np.asarray(sig.delay.to("ms").value)
    T.GBT().observe(sig, psr, system="Lband_GUPPI", noise=True)
    out["qs_obs"] = host(sig.data)
    out["qs_meta"] = np.array([float(v) for v in (
        sig.nsub, sig.nsamp, sig.Nfold, sig._Smax.value, sig._draw_norm,
        sig._draw_max)])

    # SEARCH: pulses, dispersion, nulling a dispersed signal, noise
    U.set_seed(0)
    sig, psr = search_signal(), pulsar()
    psr.make_pulses(sig, tobs=0.2)
    out["sn_pulses"] = host(sig.data)
    I.ISM().disperse(sig, dm=15.99)
    out["sn_disp"] = host(sig.data)
    out["sn_nulled"] = np.asarray(psr.null(sig, 0.3) if pkg != "psrsigsim_tpu"
                                  else _null_pulses(psr, sig, 0.3))
    out["sn_null"] = host(sig.data)
    T.GBT().observe(sig, psr, system="Lband_GUPPI", noise=True)
    out["sn_obs"] = host(sig.data)

    # nulling without delays (fold mode, the same noise row in every channel)
    sig, psr = fold_signal(), pulsar(seed=3)
    psr.make_pulses(sig, tobs=8.0)
    nulled = psr.null(sig, 0.5) if pkg != "psrsigsim_tpu" else \
        _null_pulses(psr, sig, 0.5)
    out["fn_nulled"] = np.asarray(nulled)
    out["fn_null"] = host(sig.data)

    # the other ISM effects
    sig, psr = fold_signal(), pulsar(seed=5)
    psr.make_pulses(sig, tobs=4.0)
    ism = I.ISM()
    ism.FD_shift(sig, FD_PARAMS)
    out["fd"] = host(sig.data)
    ism.scatter_broaden(sig, 5e-5, 1400.0)
    out["scatter_shift"] = host(sig.data)
    out["scatter_delay"] = np.asarray(sig.delay.to("ms").value)
    sig, psr = fold_signal(), pulsar(seed=5)
    ism.scatter_broaden(sig, 2e-4, 1400.0, convolve=True, pulsar=psr)
    out["scatter_conv_prof"] = np.asarray(psr.Profiles._profile_data)
    psr.make_pulses(sig, tobs=4.0)
    out["scatter_conv_pulses"] = host(sig.data)
    freqs = np.asarray(sig.dat_freq.value)
    out["scale_laws"] = np.concatenate([np.atleast_1d(np.asarray(
        getattr(ism, f"scale_{law}")(2.0, 1400.0, freqs, beta=beta)))
        for law in ("dnu_d", "dt_d", "tau_d") for beta in (11 / 3, 4.5)])

    # observe: every resampling branch, with noise, and an int8 signal
    tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="T")
    for name, rate in RESAMPLE.items():
        tel.add_system(name, T.Receiver(fcent=1400, bandwidth=400, name="R",
                                        seed=11),
                       T.Backend(samprate=rate, name=name))
    for name in RESAMPLE:
        sig, psr = search_signal(nchan=8), pulsar(seed=7, period=0.005)
        psr.make_pulses(sig, tobs=0.05)
        res = tel.observe(sig, psr, system=name, noise=True, ret_resampsig=True)
        out[f"rs_{name}"] = host(res)
        out[f"rs_{name}_sig"] = host(sig.data)
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=16, sample_rate=0.2048,
                             fold=True, sublen=2.0, dtype=np.int8, **kw)
    psr = pulsar(seed=9)
    psr.make_pulses(sig, tobs=4.0)
    U.set_seed(4)
    res = T.GBT().observe(sig, psr, system="Lband_GUPPI", noise=True,
                          ret_resampsig=True)
    out["int8"] = host(res)
    out["int8_sig"] = host(sig.data)

    # Nfold = 0.1 s / 4.57 ms < 50: the exact gamma branch
    psr = P.Pulsar(0.00457, 0.03, P.GaussProfile(), seed=0)
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                             fold=True, sublen=0.1, **kw)
    psr.make_pulses(sig, tobs=0.2)
    out["gamma_pulses"] = host(sig.data)
    return out


def _null_pulses(psr, sig, frac):
    """The pulses the JAX package's ``null`` nulls: its permutation, drawn
    from the key the call takes (the next one of the pulsar's sequence)."""
    import copy

    import jax

    keys = copy.deepcopy(psr._keys)
    perm = np.asarray(jax.random.permutation(keys.next("null_select"), sig.nsub))
    psr.null(sig, frac)
    return perm[: int(np.round(sig.nsub * frac))]


def _child(out):
    """Reference values from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.convolve import convolve_profiles
    from psrsigsim_tpu.ops.resample import block_downsample, rebin
    from psrsigsim_tpu.utils.rng import KeySequence

    res = _flows("psrsigsim_tpu")
    k = jax.random.key(5)
    res["split"] = np.asarray(jax.random.key_data(jax.random.split(k, 3)))
    for n in PERM_SIZES:
        res[f"perm_{n}"] = np.asarray(jax.random.permutation(k, n))
    ks = KeySequence(7)
    res["keyseq"] = np.stack([np.asarray(jax.random.key_data(ks.next(st, i)))
                              for st, i in (("pulse", 0), ("noise", 0),
                                            ("null_select", 3), ("user", 2))])
    a, b, _ = _operands()
    res["conv"] = np.asarray(convolve_profiles(jnp.asarray(a), jnp.asarray(b), 40))
    _, _, x = _operands()
    res["down"] = np.asarray(block_downsample(jnp.asarray(x), 4))
    res["rebin"] = np.asarray(rebin(jnp.asarray(x), 37))
    np.savez(out, **res)


def _operands():
    r = np.random.default_rng(2)
    return (np.abs(r.normal(1.0, 0.5, (16, 64))).astype(np.float32),
            np.exp(-np.arange(64) / 7.0)[None, :].repeat(16, 0).astype(np.float32),
            r.normal(0.0, 1.0, (3, 5, 400)).astype(np.float32))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_oo") / "ref.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def port():
    return _flows("psrsigsim_torch")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv("PSS_SAMPLER", raising=False)
    monkeypatch.delenv("PSS_EXACT_CHI2", raising=False)


def _within_ulps(got, want, ulps):
    """``got`` within ``ulps`` float32 ulps of ``want`` where ``want`` is a
    normal number, and within 1e-30 of the peak below (XLA's CPU backend
    flushes subnormals)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    normal = np.abs(want) >= TINY
    d = np.abs(got.view(np.int32).astype(np.int64)
               - want.view(np.int32).astype(np.int64))
    assert d[normal].max(initial=0) <= ulps
    assert (np.abs(got - want)[~normal].max(initial=0)
            <= 1e-30 * np.abs(want).max())


def _shifted_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_split_and_permutation_match_jax(ref):
    from psrsigsim_torch.utils import key, permutation, split

    k = key(5, device="cpu")
    np.testing.assert_array_equal(split(k, 3).numpy(), ref["split"])
    for n in PERM_SIZES:
        got = permutation(k, n).numpy()
        np.testing.assert_array_equal(got, ref[f"perm_{n}"])
        assert np.array_equal(np.sort(got), np.arange(n))


def test_key_sequence_matches_jax(ref):
    from psrsigsim_torch.utils import KeySequence

    ks = KeySequence(7)
    got = np.stack([ks.next(st, i).numpy()
                    for st, i in (("pulse", 0), ("noise", 0),
                                  ("null_select", 3), ("user", 2))])
    np.testing.assert_array_equal(got, ref["keyseq"])


def test_global_key_sequence_is_seedable():
    from psrsigsim_torch.utils import default_keys, next_key, set_seed

    set_seed(3)
    a = next_key("pulse")
    set_seed(3)
    assert torch.equal(next_key("pulse"), a)
    assert default_keys._seed == 3


@pytest.mark.parametrize("name, ulps", [("qs_pulses", 2), ("sn_pulses", 5)])
def test_make_pulses_within_ulps(ref, port, name, ulps):
    _within_ulps(port[name], ref[name], ulps)


def test_quickstart_bookkeeping_matches(ref, port):
    np.testing.assert_array_equal(port["qs_meta"], ref["qs_meta"])
    np.testing.assert_array_equal(port["qs_delay"], ref["qs_delay"])
    assert port["qs_obs"].shape == (16, 4 * 935)


@pytest.mark.parametrize("name", ["qs_disp", "qs_obs", "sn_disp", "sn_null",
                                  "sn_obs", "fd", "scatter_shift",
                                  "scatter_conv_pulses"])
def test_shifted_flows_within_rtol(ref, port, name):
    _shifted_close(port[name], ref[name])


@pytest.mark.parametrize("case", ["sn", "fn"])
def test_null_picks_the_same_pulses(ref, port, case):
    np.testing.assert_array_equal(port[f"{case}_nulled"], ref[f"{case}_nulled"])
    assert len(port[f"{case}_nulled"]) > 0


def test_null_without_delays_within_2_ulp(ref, port):
    _within_ulps(port["fn_null"], ref["fn_null"], 2)


def test_scatter_convolution_and_laws(ref, port):
    np.testing.assert_allclose(port["scatter_conv_prof"],
                               ref["scatter_conv_prof"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(port["scatter_delay"], ref["scatter_delay"],
                               rtol=1e-15)
    np.testing.assert_allclose(port["scale_laws"], ref["scale_laws"], rtol=1e-15)


@pytest.mark.parametrize("branch", list(RESAMPLE))
def test_observe_resampling_branches(ref, port, branch):
    got, want = port[f"rs_{branch}"], ref[f"rs_{branch}"]
    assert got.dtype == want.dtype == np.float32
    _shifted_close(got, want)
    assert got.shape == (8, RESAMPLED_WIDTH[branch])
    # the signal itself gets χ²(1) noise at its own rate, not resampled
    _within_ulps(port[f"rs_{branch}_sig"], ref[f"rs_{branch}_sig"], 5)
    assert port[f"rs_{branch}_sig"].shape == (8, 10240)


def test_observe_casts_int8(ref, port):
    assert port["int8"].dtype == ref["int8"].dtype == np.int8
    # codes truncate the same floats; a float within 2 ulp of an integer
    # may truncate to its neighbour
    assert np.abs(port["int8"].astype(int) - ref["int8"].astype(int)).max() <= 1
    assert np.mean(port["int8"] != ref["int8"]) < 1e-3
    _within_ulps(port["int8_sig"], ref["int8_sig"], 2)


def test_convolve_and_resample_ops(ref):
    from psrsigsim_torch.ops import block_downsample, convolve_profiles, rebin

    a, b, x = (torch.from_numpy(v) for v in _operands())
    _shifted_close(convolve_profiles(a, b, 40).numpy(), ref["conv"])
    _shifted_close(block_downsample(x, 4).numpy(), ref["down"])
    _shifted_close(rebin(x, 37).numpy(), ref["rebin"])


def test_backend_fold_sums_periods():
    from psrsigsim_torch.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.telescope import Backend

    sig = FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                           fold=False, device="cpu")
    psr = Pulsar(0.005, 0.03, GaussProfile(), seed=1)
    psr.make_pulses(sig, tobs=0.05)
    nph = int((psr.period * sig.samprate).decompose())
    want = sig.data[:, : (sig.data.shape[1] // nph) * nph].reshape(4, -1, nph).sum(1)
    assert torch.equal(Backend(samprate=12.5).fold(sig, psr), want)


def test_receiver_with_a_sampled_response():
    """A receiver built from sampled bandpass data (response_from_data)
    takes the band from it and adds noise like a flat one."""
    from psrsigsim_torch.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.telescope import (Backend, Receiver, Telescope,
                                           response_from_data)

    resp = response_from_data([1200.0, 1400.0, 1600.0], [0.5, 1.0, 0.5])
    rcvr = Receiver(response=resp, name="R", seed=2)
    assert rcvr.fcent.value == 1400.0 and rcvr.bandwidth.value == 400.0
    assert resp(1300.0) == 0.75 and resp(1700.0) == 0.0
    with pytest.raises(ValueError):
        Receiver(response=resp, fcent=1400, bandwidth=400)
    flat = Receiver(fcent=1400, bandwidth=400, name="F", seed=2)
    out = []
    for r in (rcvr, flat):
        tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="T")
        tel.add_system("S", r, Backend(samprate=12.5, name="B"))
        sig = FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                               fold=True, sublen=1.0, device="cpu")
        psr = Pulsar(0.005, 0.03, GaussProfile(), seed=1)
        psr.make_pulses(sig, tobs=2.0)
        tel.observe(sig, psr, system="S", noise=True)
        out.append(sig.data)
    assert torch.equal(out[0], out[1])


def test_signal_state_and_device():
    from psrsigsim_torch.signal import FilterBankSignal, SignalState

    sig = FilterBankSignal(1400.0, 400.0, Nsubband=4, device="cpu")
    assert sig.data is None and sig.device == torch.device("cpu")
    sig.init_data(16)
    assert sig.data.shape == (4, 16) and sig.nsamp == 16
    assert isinstance(sig.state, SignalState)
    sig.data = torch.ones(4, 16)
    assert float(sig.data.sum()) == 64.0


def test_unported_paths_raise(ref, port):
    """``Signal()`` and ``null(length=)`` raise; the exact-gamma branch
    this test once held to a raise (``make_pulses`` at Nfold = 0.1 s /
    4.57 ms < 50) now draws the JAX package's pulses, bit for bit where
    they are normal numbers (``_within_ulps`` with 0 ulp)."""
    from psrsigsim_torch.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import FilterBankSignal, Signal

    with pytest.raises(NotImplementedError):
        Signal()
    psr = Pulsar(0.00457, 0.03, GaussProfile(), seed=0)
    _within_ulps(port["gamma_pulses"], ref["gamma_pulses"], 0)
    sig = FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                           fold=True, sublen=1.0, device="cpu")
    psr.make_pulses(sig, tobs=2.0)
    with pytest.raises(NotImplementedError):
        psr.null(sig, 0.5, length=1.0)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """Without a card and without ``device=`` the flow raises instead of
    running on the CPU."""
    from psrsigsim_torch.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.signal import FilterBankSignal

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig = FilterBankSignal(1400.0, 400.0, Nsubband=4, sample_rate=0.2048,
                           fold=True, sublen=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pulsar(0.005, 0.03, GaussProfile(), seed=0).make_pulses(sig, tobs=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sig.init_data(8)


if __name__ == "__main__":
    _child(sys.argv[1])
