"""The port's time-sharded baseband path (``parallel/seqshard.py``:
``dispersion_halo_samples``, ``seq_sharded_dedisperse`` — overlap-save
blocks with a ring halo exchange — and ``seq_sharded_baseband``) against
the JAX package, and against itself, on the CPU — the mirror of
tests/test_seqshard_baseband.py.

Geometry: the JAX package's test geometry (a 4 MHz band at 1400 MHz
sampled at 8 MHz, a 1 ms pulsar, 16.384 ms: 2 x 131,072 samples, DM 2),
whose smearing is a small halo; a mesh of ``n`` shards is ``n`` repeated
CPU devices.  Tolerances and why:

* the halo sizes and the overlap-save geometry: host float64 arithmetic
  in both — equal, over a grid of DMs (a negative one too) and bands
  (BASELINE config 3's among them);
* the draws (the flat normal spans at ``p·nsamp + t0``): bit-exact to the
  whole stream's, for any shard count;
* the halo truncation: the reference's own bounds — max error below 5% of
  the stream's std and rms below 1% against the full circular filter, and
  a 4x halo no worse than the default;
* against the JAX package at the same n: the same block, halos and host
  float64 transfer planes, FFTs by another library — within 1e-5 of the
  output's peak (float32 transforms of 2^15-2^17 points round apart by a
  few ulps of the peak).

Reference values come from a child process (this file run as a script)
with 8 virtual XLA CPU devices and the JAX-version shims R1 and R2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_seqshard import child_env8, seq_mesh  # noqa: E402
from test_torch_toa import shims  # noqa: E402

SEED = 1
DM = 2.0
DEDISP_NS = (2, 4, 8)
BASEBAND_NS = (1, 2, 8)
# (dm, fcent, bw, dt_us): the small band, a negative DM, config 3's band
HALO_GRID = [(dm, 1400.0, 4.0, 0.125) for dm in (-5.0, -2.0, 0.0, 2.0, 13.3)]
HALO_GRID += [(13.3, 1400.0, 100.0, 0.005), (100.0, 820.0, 200.0, 0.0025),
              (0.5, 350.0, 50.0, 0.01)]


def _bb_cfg(pkg, dm=2.0, bw=4.0, fcent=1400.0, tobs=0.016384):
    """tests/test_seqshard_baseband.py's ``_bb_cfg`` from either package:
    ``(cfg, sqrt_profiles, noise_norm)``."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    U = importlib.import_module(pkg + ".utils")
    sim = importlib.import_module(pkg + ".simulate")
    sig = S.BasebandSignal(fcent, bw, sample_rate=2 * bw)
    psr = P.Pulsar(0.001, 0.05, P.GaussProfile(width=0.05), name="J0", seed=0)
    sig._tobs = U.make_quant(tobs, "s")
    return sim.build_baseband_config(sig, psr)


def _x(nsamp):
    return np.random.default_rng(SEED).standard_normal(
        (2, nsamp)).astype(np.float32)


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.shift import coherent_dedisperse
    from psrsigsim_tpu.parallel import (dispersion_halo_samples,
                                        make_seq_mesh, seq_sharded_baseband,
                                        seq_sharded_dedisperse)

    assert len(jax.devices()) == 8
    res = {}
    cfg, sqrt_profiles, nn = _bb_cfg("psrsigsim_tpu")
    res["halos"] = np.asarray([dispersion_halo_samples(*g)
                               for g in HALO_GRID], np.int64)
    x = _x(cfg.nsamp)
    res["circular"] = np.asarray(coherent_dedisperse(
        x, DM, cfg.fcent_mhz, cfg.bw_mhz, cfg.dt_us))
    for n in DEDISP_NS:
        run = seq_sharded_dedisperse(cfg, dm=DM, mesh=make_seq_mesh(n))
        res[f"dedisp{n}"] = np.asarray(run(jnp.asarray(x)))
    key = jax.random.key(3)
    res["key"] = np.asarray(jax.random.key_data(key))
    for n in BASEBAND_NS:
        run = seq_sharded_baseband(cfg, dm=DM, mesh=make_seq_mesh(n))
        res[f"baseband{n}"] = np.asarray(run(key, jnp.float32(nn),
                                             jnp.asarray(sqrt_profiles)))
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_seqshard_baseband")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env8(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


# -- the port -------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def staged():
    return _bb_cfg("psrsigsim_torch")


@pytest.fixture(scope="module")
def circular(staged):
    from psrsigsim_torch.ops.shift import coherent_dedisperse

    cfg = staged[0]
    return coherent_dedisperse(torch.from_numpy(_x(cfg.nsamp)), DM,
                               cfg.fcent_mhz, cfg.bw_mhz, cfg.dt_us).numpy()


def _dedisp(cfg, n, halo=None, dm=DM):
    from psrsigsim_torch.parallel import seq_sharded_dedisperse

    return seq_sharded_dedisperse(cfg, dm=dm, mesh=seq_mesh(n), halo=halo)(
        _x(cfg.nsamp)).numpy()


def _key():
    from psrsigsim_torch.utils import key

    return key(3, "cpu")


class TestHaloSize:
    def test_sweep_samples(self):
        from psrsigsim_torch.parallel import dispersion_halo_samples

        halo = dispersion_halo_samples(2.0, 1400.0, 4.0, 0.125)
        sweep_s = (1.0 / 2.41e-4) * 2.0 * (1398.0**-2 - 1402.0**-2)
        assert halo == int(np.ceil(4.0 * sweep_s * 1e6 / 0.125)) + 1

    def test_negative_dm_halo_positive(self):
        from psrsigsim_torch.parallel import dispersion_halo_samples

        assert dispersion_halo_samples(-2.0, 1400.0, 4.0, 0.125) == \
            dispersion_halo_samples(2.0, 1400.0, 4.0, 0.125)

    def test_config3_halo_exceeds_two_slabs(self):
        """At BASELINE config 3 (100 MHz at 1400 MHz, 200 MHz sampling, DM
        13.3) the default halo is ~3.23 M samples: more than a 2-shard
        slab of its 4,000,000 samples, so the default raises there, as the
        reference does; an explicit halo that fits is accepted."""
        from psrsigsim_torch.parallel import dispersion_halo_samples
        from psrsigsim_torch.parallel.seqshard import _make_dedisp_local

        cfg = _bb_cfg("psrsigsim_torch", bw=100.0, tobs=0.02)[0]
        assert cfg.nsamp == 4_000_000
        halo = dispersion_halo_samples(13.3, cfg.fcent_mhz, cfg.bw_mhz,
                                       cfg.dt_us)
        assert 3_200_000 < halo < 3_250_000
        with pytest.raises(ValueError, match="smearing"):
            _make_dedisp_local(cfg, 13.3, 2, cfg.nsamp // 2, None)
        _make_dedisp_local(cfg, 13.3, 2, cfg.nsamp // 2, 1_048_576)

    def test_halo_must_fit_slab(self, staged):
        from psrsigsim_torch.parallel import seq_sharded_dedisperse

        cfg = staged[0]
        with pytest.raises(ValueError, match="smearing"):
            seq_sharded_dedisperse(cfg, dm=DM, mesh=seq_mesh(8),
                                   halo=cfg.nsamp)

    def test_zero_halo_rejected(self, staged):
        from psrsigsim_torch.parallel import seq_sharded_dedisperse

        with pytest.raises(ValueError, match="halo"):
            seq_sharded_dedisperse(staged[0], dm=DM, mesh=seq_mesh(2), halo=0)

    def test_single_shard_needs_no_halo(self, staged):
        """n = 1 is the exact full-length filter, whatever the smearing."""
        from psrsigsim_torch.ops.shift import coherent_dedisperse

        cfg = staged[0]
        big_dm = 1e4
        x = _x(cfg.nsamp)
        want = coherent_dedisperse(torch.from_numpy(x), big_dm, cfg.fcent_mhz,
                                   cfg.bw_mhz, cfg.dt_us)
        assert torch.equal(torch.as_tensor(_dedisp(cfg, 1, dm=big_dm)), want)


class TestShardedDedisperse:
    @pytest.mark.parametrize("n", DEDISP_NS)
    def test_matches_circular_filter(self, staged, circular, n):
        """Cyclic halos reproduce the CIRCULAR filter up to the halo's
        truncation of the chirp's tails: the reference's bounds."""
        err = _dedisp(staged[0], n) - circular
        assert np.abs(err).max() / circular.std() < 5e-2, n
        assert err.std() / circular.std() < 1e-2, n

    def test_larger_halo_tightens(self, staged, circular):
        from psrsigsim_torch.parallel import dispersion_halo_samples

        cfg = staged[0]
        h0 = dispersion_halo_samples(DM, cfg.fcent_mhz, cfg.bw_mhz, cfg.dt_us)
        errs = [np.abs(_dedisp(cfg, 4, halo=h) - circular).max()
                for h in (h0, 4 * h0)]
        assert errs[1] <= errs[0]


class TestShardedBasebandPipeline:
    @pytest.fixture(scope="class")
    def outs(self, staged):
        from psrsigsim_torch.parallel import seq_sharded_baseband

        cfg, sqrt_profiles, nn = staged
        return {n: seq_sharded_baseband(cfg, dm=DM, mesh=seq_mesh(n))(
            _key(), nn, sqrt_profiles).numpy() for n in BASEBAND_NS}

    @pytest.mark.parametrize("n", BASEBAND_NS[1:])
    def test_shard_count_consistency(self, outs, n):
        assert outs[1].shape == (2, 131072)
        err = outs[1] - outs[n]
        assert np.abs(err).max() / outs[1].std() < 5e-2, n
        assert err.std() / outs[1].std() < 1e-2, n

    @pytest.mark.parametrize("n", [1, 2, 8, 16])
    def test_draws_are_the_whole_stream(self, staged, n):
        """Each slab's pulse and noise normals are the whole stream's
        (``baseband_pipeline``'s flat pol-major field) at its offsets."""
        from psrsigsim_torch.ops.stats import flat_normal_field, flat_spans
        from psrsigsim_torch.utils import stage_key

        nsamp = staged[0].nsamp
        L = nsamp // n
        for stage in ("pulse", "noise"):
            k = stage_key(_key(), stage)
            whole = flat_normal_field(k, 0, 2 * nsamp).reshape(2, nsamp)
            got = torch.cat([flat_spans(k, [p * nsamp + s * L
                                            for p in range(2)], L)
                             for s in range(n)], dim=-1)
            assert torch.equal(got, whole), (stage, n)

    def test_n1_matches_baseband_pipeline(self, staged, outs):
        """n = 1 against ``baseband_pipeline`` (the same draws; the filter
        of a host DM against a per-observation DM's double-float planes):
        within 1e-4, the reference's bound."""
        from psrsigsim_torch.simulate import baseband_pipeline

        cfg, sqrt_profiles, nn = staged
        want = baseband_pipeline(_key(), torch.tensor(DM),
                                 torch.tensor(nn, dtype=torch.float32),
                                 sqrt_profiles, cfg, device="cpu").numpy()
        assert np.max(np.abs(outs[1] - want)) < 1e-4

    def test_statistics_match_unsharded_pipeline(self, staged, outs):
        from psrsigsim_torch.simulate import baseband_pipeline

        cfg, sqrt_profiles, nn = staged
        plain = baseband_pipeline(_key(), torch.tensor(DM),
                                  torch.tensor(nn, dtype=torch.float32),
                                  sqrt_profiles, cfg, device="cpu").numpy()
        assert outs[8].shape == plain.shape
        assert np.allclose(outs[8].std(), plain.std(), rtol=0.05)
        assert np.allclose(outs[8].mean(), plain.mean(),
                           atol=0.02 * plain.std())


# -- against the JAX package ----------------------------------------------------


def test_halo_sizes_match_reference(ref):
    from psrsigsim_torch.parallel import dispersion_halo_samples

    got = [dispersion_halo_samples(*g) for g in HALO_GRID]
    assert got == ref["halos"].tolist()


@pytest.mark.parametrize("n", DEDISP_NS)
def test_sharded_dedisperse_matches_reference(ref, staged, circular, n):
    want = ref[f"dedisp{n}"]
    np.testing.assert_allclose(_dedisp(staged[0], n), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(circular, ref["circular"], rtol=0,
                               atol=1e-5 * np.abs(ref["circular"]).max())


@pytest.mark.parametrize("n", BASEBAND_NS)
def test_sharded_baseband_matches_reference(ref, staged, n):
    from psrsigsim_torch.parallel import seq_sharded_baseband
    from psrsigsim_torch.utils import as_key

    cfg, sqrt_profiles, nn = staged
    assert torch.equal(as_key(ref["key"], "cpu"), _key())
    got = seq_sharded_baseband(cfg, dm=DM, mesh=seq_mesh(n))(
        _key(), nn, sqrt_profiles).numpy()
    want = ref[f"baseband{n}"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


if __name__ == "__main__":
    _child(sys.argv[1])
