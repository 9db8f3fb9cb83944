"""The port's sequence (time-axis) sharding of SEARCH streams
(``parallel/seqshard.py``: ``seq_sharded_search`` and its body, the flat
spans, the blocked draws, the guards) against the JAX package, and against
itself, on the CPU — the mirror of tests/test_seqshard.py.

Geometry: the JAX package's test geometry (8 channels over 400 MHz at
1400 MHz, 0.2048 MHz sampling, P = 5 ms: 1024 samples a pulse, 0.4 s =
81,920 samples), with and without 20% nulling.  A mesh of ``n`` shards is
``n`` repeated CPU devices.  At n = 8 a slab (10,240 samples) is not a
whole number of 4096-sample RNG blocks and the channels' flat spans start
at different tile phases: the unaligned case.  Tolerances and why:

* the draws (blocked threefry fields, flat spans, each slab's fields):
  the same keys, bits and arithmetic — bit-exact, for any split;
* envelope mode: every stage is elementwise in time and the portrait's
  shift is the same on every shard, so the stream is bit-identical for
  every shard count and equal to the port's ``single_pipeline`` bit for
  bit;
* fft mode: each shard shifts its ``Nchan/n`` channels of the whole
  stream.  On the CPU the shift's complex product rounds an element
  differently when the vectorized loop leaves it to its scalar tail,
  which depends on the row count, so the shard counts agree to the JAX
  package's own bound, ``max|Δ| < 1e-5 · l2`` (tests/test_seqshard.py;
  measured 7.6e-6 absolute at n = 2, i.e. 2e-8 of l2, 0 at n = 4 and 8);
* against the JAX package at the same n: the draws are bit-exact, the
  output within rtol 1e-5 plus 1e-5 of the peak (the portrait's or the
  stream's Fourier shift: the two FFT libraries round apart by ulps —
  the SEARCH pipeline's own gate, tests/test_torch_search.py).

Reference values come from a child process (this file run as a script)
with 8 virtual XLA CPU devices and the JAX-version shims R1 and R2.
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

KEY = 7
DM = 15.0
# (case, shift mode, null_frac, shard count) run by both packages
REF_CASES = [("env1", "envelope", 0.2, 1), ("env8", "envelope", 0.2, 8),
             ("fft2", "fft", 0.2, 2), ("fft8", "fft", 0.2, 8)]
ENVELOPE_NS = (1, 2, 4, 8, 16, 5)   # 16: 5120-sample slabs; 5 divides nsamp
FFT_NS = (1, 2, 4, 8)


def child_env8():
    """The reference child's environment with 8 virtual XLA CPU devices
    (its seq meshes need them)."""
    env = child_env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    return env


def _cfg(pkg, null_frac=0.0, nchan=8, tobs=0.4):
    """tests/test_seqshard.py's ``_search_cfg`` from either package:
    ``(cfg, profiles, noise_norm)``."""
    import importlib

    sim = importlib.import_module(pkg + ".simulate")
    d = {
        "fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 0.2048,
        "Nchan": nchan, "fold": False, "period": 0.005, "Smean": 0.05,
        "profiles": [0.5, 0.05, 1.0], "tobs": tobs, "name": "J0000+0000",
        "dm": 15.0, "aperture": 100.0, "area": 5500.0, "Tsys": 35.0,
        "tscope_name": "T", "system_name": "S", "rcvr_fcent": 1400,
        "rcvr_bw": 400, "rcvr_name": "R", "backend_samprate": 12.5,
        "backend_name": "B", "seed": 0,
    }
    kw = {} if pkg == "psrsigsim_tpu" else {"device": "cpu"}
    s = sim.Simulation(psrdict=d, **kw)
    s.init_all()
    return sim.build_single_config(s.signal, s.pulsar, s.tscope, "S",
                                   null_frac=null_frac)


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.parallel import make_seq_mesh, seq_sharded_search
    from psrsigsim_tpu.simulate import single_pipeline

    assert len(jax.devices()) == 8
    res, meta = {}, {}
    key = jax.random.key(KEY)
    res["key"] = np.asarray(jax.random.key_data(key))
    cfg, prof, nn = _cfg("psrsigsim_tpu", 0.2)
    meta["cfg"] = dataclasses.asdict(cfg)
    res["prof"], res["nn"] = prof, np.float64(nn)
    for mode in ("envelope", "fft"):
        c = dataclasses.replace(cfg, shift_mode=mode)
        res[f"single_{mode}"] = np.asarray(single_pipeline(
            key, jnp.float32(DM), jnp.float32(nn), jnp.asarray(prof), c))
    for case, mode, null, n in REF_CASES:
        c = dataclasses.replace(_cfg("psrsigsim_tpu", null)[0],
                                shift_mode=mode)
        run = seq_sharded_search(c, mesh=make_seq_mesh(n))
        res[case] = np.asarray(run(key, jnp.float32(DM), jnp.float32(nn),
                                   jnp.asarray(prof)))
    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_seqshard")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env8(), capture_output=True, text=True,
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


def seq_mesh(n):
    from psrsigsim_torch.parallel import make_seq_mesh

    return make_seq_mesh(devices=["cpu"] * n)


def _key():
    from psrsigsim_torch.utils import key

    return key(KEY, "cpu")


def _l2(a):
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a ** 2) * a.shape[-1]))


@pytest.fixture(scope="module")
def staged():
    return {null: _cfg("psrsigsim_torch", null) for null in (0.0, 0.2)}


@pytest.fixture(scope="module")
def outputs(staged):
    """The port's streams at every shard count, both modes (20% nulled),
    and its ``single_pipeline``."""
    from psrsigsim_torch.parallel import seq_sharded_search
    from psrsigsim_torch.simulate import single_pipeline

    cfg, prof, nn = staged[0.2]
    out = {}
    for mode, ns in (("envelope", ENVELOPE_NS), ("fft", FFT_NS)):
        c = dataclasses.replace(cfg, shift_mode=mode)
        out[mode, "single"] = single_pipeline(
            _key(), torch.tensor(DM), torch.tensor(nn, dtype=torch.float32),
            prof, c, device="cpu")
        for n in ns:
            out[mode, n] = seq_sharded_search(c, seq_mesh(n))(_key(), DM, nn,
                                                             prof)
    return out


class TestBlockedRNG:
    def test_shard_invariant_assembly(self):
        from psrsigsim_torch.parallel import SEQ_RNG_BLOCK, blocked_chan_chi2
        from psrsigsim_torch.utils import key

        k = key(3, "cpu")
        chan_ids = torch.arange(4)
        full = blocked_chan_chi2(k, chan_ids, 1.0, 0, 4 * SEQ_RNG_BLOCK)
        L = SEQ_RNG_BLOCK
        parts = [blocked_chan_chi2(k, chan_ids, 1.0, i * L, L)
                 for i in range(4)]
        assert torch.equal(full, torch.cat(parts, dim=1))

    def test_unaligned_spans(self):
        from psrsigsim_torch.parallel import SEQ_RNG_BLOCK, blocked_chan_chi2
        from psrsigsim_torch.utils import key

        k = key(5, "cpu")
        chan_ids = torch.arange(2)
        n = SEQ_RNG_BLOCK + 1000
        full = blocked_chan_chi2(k, chan_ids, 2.0, 0, 2 * n)
        a = blocked_chan_chi2(k, chan_ids, 2.0, 0, n)
        b = blocked_chan_chi2(k, chan_ids, 2.0, n, n)
        assert torch.equal(full, torch.cat([a, b], dim=1))

    def test_chi2_moments(self):
        from psrsigsim_torch.parallel import blocked_chan_chi2
        from psrsigsim_torch.utils import key

        x = blocked_chan_chi2(key(1, "cpu"), torch.arange(2), 4.0, 0,
                              100_000).numpy()
        assert np.allclose(x.mean(), 4.0, rtol=0.05)
        assert np.allclose(x.var(), 8.0, rtol=0.1)


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
@pytest.mark.parametrize("df", [None, 1.0, 80.0])
def test_flat_spans_are_the_flat_fields(monkeypatch, sampler, df):
    """``flat_spans`` draws each span as the one-span call does, bit for
    bit — one channel slab per span at every tile phase (on the kernel's
    plain version too, where spans sharing a phase are one call)."""
    from psrsigsim_torch.ops.stats import (flat_chi2_field, flat_normal_field,
                                           flat_spans)
    from psrsigsim_torch.utils import fold_in, key

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    keys = fold_in(key(4, "cpu"), torch.arange(2))
    nsamp, L = 81920, 10240
    f0s = [c * nsamp + 3 * L for c in range(4)] + [7]
    got = flat_spans(keys, f0s, L, df)
    assert got.shape == (2, len(f0s), L)
    for s, f0 in enumerate(f0s):
        want = (flat_normal_field(keys, f0, L) if df is None
                else flat_chi2_field(keys, f0, L, df))
        assert torch.equal(got[:, s], want), (s, f0)


def test_slab_fields_equal_the_whole_stream(staged):
    """The SEARCH χ² fields of every slab (the flat spans at ``c·nsamp +
    t0``) are the whole-stream field's columns, for aligned and unaligned
    slabs: the sample-for-sample contract, where no FFT can blur it."""
    from psrsigsim_torch.ops.stats import flat_spans
    from psrsigsim_torch.simulate.pipeline import _search_chi2
    from psrsigsim_torch.utils import stage_key

    cfg = staged[0.0][0]
    kp = stage_key(_key(), "pulse")
    nchan, nsamp = cfg.meta.nchan, cfg.nsamp
    whole = _search_chi2(kp, torch.arange(nchan), 1.0, nsamp, nchan)
    for n in (2, 8, 16):
        L = nsamp // n
        got = torch.cat([flat_spans(kp, [c * nsamp + s * L
                                         for c in range(nchan)], L, 1.0)
                         for s in range(n)], dim=-1)
        assert torch.equal(got, whole), n


class TestSeqShardedSearch:
    @pytest.mark.parametrize("n", ENVELOPE_NS[1:])
    def test_envelope_shard_count_invariance(self, outputs, n):
        """Envelope mode: bit-identical for every shard count, aligned or
        not (n = 16: 5120-sample slabs)."""
        assert outputs["envelope", n].shape == outputs["envelope", 1].shape
        assert torch.equal(outputs["envelope", n], outputs["envelope", 1]), n

    def test_n1_equals_single_pipeline(self, outputs):
        for mode in ("envelope", "fft"):
            assert torch.equal(outputs[mode, 1], outputs[mode, "single"]), mode

    @pytest.mark.parametrize("n", FFT_NS[1:])
    def test_fft_mode_matches_to_the_reference_bound(self, outputs, n):
        """fft mode through the two all_to_all transposes: within the JAX
        package's ``1e-5 · l2`` of the unsharded stream (see the module
        docstring for why not bit for bit on the CPU)."""
        ref = outputs["fft", "single"].numpy()
        got = outputs["fft", n].numpy()
        assert np.max(np.abs(got - ref)) < 1e-5 * _l2(ref)

    @pytest.mark.parametrize("null_frac", [0.0, 0.2])
    def test_hw_sampler_plain_kernel_invariance(self, monkeypatch, staged,
                                                null_frac):
        """On the sampler kernel's stream (its plain version here) the
        slabs draw the whole stream's samples too: envelope mode at n = 1,
        4 and 8 bit-equal to ``single_pipeline``."""
        from psrsigsim_torch.parallel import seq_sharded_search
        from psrsigsim_torch.simulate import single_pipeline

        monkeypatch.setenv("PSS_SAMPLER", "hw")
        cfg, prof, nn = staged[null_frac]
        want = single_pipeline(_key(), torch.tensor(DM),
                               torch.tensor(nn, dtype=torch.float32), prof,
                               cfg, device="cpu")
        for n in (1, 4, 8):
            got = seq_sharded_search(cfg, seq_mesh(n))(_key(), DM, nn, prof)
            assert torch.equal(got, want), n

    def test_nulling_removes_pulsed_power(self, staged, outputs):
        from psrsigsim_torch.parallel import seq_sharded_search

        cfg0, prof0, nn0 = staged[0.0]
        assert staged[0.2][0].n_null > 0
        clean = seq_sharded_search(cfg0, seq_mesh(8))(_key(), DM, nn0, prof0)
        assert outputs["envelope", 8].sum() < clean.sum()

    def test_rejects_indivisible_axes(self):
        from psrsigsim_torch.parallel import seq_sharded_search

        cfg, _, _ = _cfg("psrsigsim_torch", nchan=6)
        # the fft mode transposes channels over the mesh, so Nchan must
        # divide; the envelope mode is elementwise in time
        with pytest.raises(ValueError, match="Nchan"):
            seq_sharded_search(dataclasses.replace(cfg, shift_mode="fft"),
                               seq_mesh(4))
        seq_sharded_search(cfg, seq_mesh(4))
        with pytest.raises(ValueError, match="nsamp"):
            seq_sharded_search(cfg, seq_mesh(3))

    def test_mesh_guards(self, monkeypatch):
        from psrsigsim_torch.parallel import make_seq_mesh, seq_sharded_search

        with pytest.raises(ValueError, match="n_devices"):
            make_seq_mesh(2, devices=["cpu"])
        # no card and no devices: the default mesh raises instead of
        # falling back to the host
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_seq_mesh(2)
        cfg, _, _ = _cfg("psrsigsim_torch")
        with pytest.raises(RuntimeError, match="CUDA"):
            seq_sharded_search(cfg)
        with pytest.raises(TypeError, match="seq"):
            seq_sharded_search(cfg, object())

    @staticmethod
    def _xcorr_shift(row, template):
        r = np.fft.rfft(row - row.mean())
        t = np.fft.rfft(template - template.mean())
        return int(np.argmax(np.fft.irfft(r * np.conj(t), n=len(row))))

    def test_extra_delays_enter_the_shift(self, staged):
        """A constant per-channel extra delay moves the noise-free folded
        pulse by delay/dt bins."""
        from psrsigsim_torch.parallel import seq_sharded_search

        cfg, prof, _ = staged[0.0]
        extra_bins = 37
        extra = torch.full((cfg.meta.nchan,), extra_bins * cfg.dt_ms)
        moved = seq_sharded_search(cfg, seq_mesh(8))(
            _key(), 0.0, 0.0, prof, extra_delays_ms=extra).numpy()
        nsub, nph = cfg.nsub, cfg.nph
        f_m = moved[:, :nsub * nph].reshape(-1, nsub, nph).mean(axis=1)
        for c in range(cfg.meta.nchan):
            got = self._xcorr_shift(f_m[c], prof[c]) % nph
            assert abs(got - extra_bins) <= 2

    def test_dispersion_delay_visible(self, staged):
        from psrsigsim_torch.parallel import seq_sharded_search
        from psrsigsim_torch.utils.constants import DM_K_MS_MHZ2

        cfg, prof, _ = staged[0.0]
        out = seq_sharded_search(cfg, seq_mesh(8))(_key(), DM, 0.0,
                                                  prof).numpy()
        nsub, nph = cfg.nsub, cfg.nph
        folded = out[:, :nsub * nph].reshape(-1, nsub, nph).mean(axis=1)
        freqs = np.asarray(cfg.meta.dat_freq_mhz())
        for c in (0, cfg.meta.nchan - 1):
            expected = (DM_K_MS_MHZ2 * DM / freqs[c] ** 2) / cfg.dt_ms
            got = self._xcorr_shift(folded[c], prof[c])
            diff = min((got - expected) % nph, (expected - got) % nph)
            assert diff <= 2, (c, got, expected)


# -- against the JAX package ----------------------------------------------------


def test_config_and_key_match_reference(ref, staged):
    from psrsigsim_torch.utils import as_key

    cfg, prof, nn = staged[0.2]
    assert dataclasses.asdict(cfg) == ref["cfg"]
    np.testing.assert_array_equal(prof, ref["prof"])
    assert nn == float(ref["nn"])
    assert torch.equal(as_key(ref["key"], "cpu"), _key())


@pytest.mark.parametrize("case,mode,null,n", REF_CASES)
def test_sharded_search_matches_reference(ref, outputs, case, mode, null, n):
    """The port's stream at the reference's shard count: within rtol 1e-5
    plus 1e-5 of the peak (the Fourier shift's FFT libraries)."""
    got = outputs[mode, n].numpy()
    want = ref[case]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["envelope", "fft"])
def test_reference_sharded_equals_its_single_pipeline_bound(ref, mode):
    """The reference's own contract, read from its outputs: its n = 1 and
    n = 8 streams within ``1e-5 · l2`` of its ``single_pipeline`` — the
    bound the port's fft mode is held to above."""
    want = ref[f"single_{mode}"]
    for case, m, _, _ in REF_CASES:
        if m == mode:
            assert np.max(np.abs(ref[case] - want)) < 1e-5 * _l2(want), case


if __name__ == "__main__":
    _child(sys.argv[1])
