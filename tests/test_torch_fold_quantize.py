"""The fused fold → quantize → pack kernel's plain version against the
unfused port path and against the JAX package.

* Against the unfused port path (``rng_field_plain`` fields of the whole
  batch → portrait multiply → noise add → ``subint_quantize`` → ``swap16``
  → ``pack_triple``, the fields fed through the plain version's hook):
  bit for bit — the plain version's own draws, span by span and one
  observation at a time, are the same samples.  A row holding a NaN is
  flagged and leaves every other row as it was; its own codes are left
  undefined, as the reference leaves them.
* Against the JAX package, given the reference's own ``chan_chi2_field``
  fields and ``fourier_shift`` portrait through the field hook: bit for bit
  against what the reference's ``subint_quantize`` + ``swap16`` + packing
  make of the block its arithmetic builds from them.  Against the packed
  buffer of the reference's jitted ensemble program, whose fields and shift
  XLA rounds differently by an ulp here and there, the existing bound of
  test_torch_pipeline.py holds: codes ≤1 LSB on ≤1% of entries, scl/offs
  rtol 1e-5.

Reference values come from a child process (this file run as a script)
that applies the JAX-version shim the reference needs; the shim never
touches the pytest worker.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from psrsigsim_torch.ops import fold_quantize as fq
from psrsigsim_torch.ops import rng_hw
from psrsigsim_torch.parallel.ensemble import _split_packed_chunk
from psrsigsim_torch.utils import rng

torch.set_num_threads(2)

N_REF = 3
SEED = 3
CPU = torch.device("cpu")

# (name, B, nchan, chan0, nph, nsub, modes, dfs, draw_norm, t0, byte_order)
CASES = {
    "odd13": (2, 13, 8, 1000, 5, ("chi2_wh", "chi2_wh"), (12000.0, 437.6),
              1.0, 0, "little"),
    "odd13_big": (2, 13, 8, 1000, 5, ("chi2_wh", "chi2_wh"), (12000.0, 437.6),
                  1.0, 0, "big"),
    "chi2_sel": (2, 9, 0, 1000, 2, ("chi2_sel", "chi2_sel"),
                 ((1.0, 12000.0), (12000.0, 1.0)), 1.0, 0, "big"),
    "draw_norm": (2, 8, 16, 512, 3, ("chi2_wh", "chi2_1"), (437.6, 0.0),
                  0.37, 0, "little"),
    "nph935": (1, 16, 0, 935, 3, ("chi2_wh", "chi2_wh"), (437.6, 437.6), 1.0,
               0, "little"),
    "t0_unaligned": (1, 5, 8, 700, 3, ("normal", "chi2_1"), (0.0, 0.0), 1.0,
                     1234, "big"),
    # the card's rows kernel: chi2_wh x chi2_wh, whole quads, every row inside
    # one 4096-sample RNG block (the main path's shape class)
    "rows_main_like": (2, 8, 0, 512, 3, ("chi2_wh", "chi2_wh"),
                       (12000.0, 12000.0), 1.0, 0, "little"),
    "rows_t0_3072": (2, 13, 8, 512, 6, ("chi2_wh", "chi2_wh"), (437.6, 437.6),
                     0.37, 3072, "big"),
    # whole quads, but rows cross an RNG block: the general kernel
    "rows_cross_block": (1, 8, 0, 3072, 3, ("chi2_wh", "chi2_wh"),
                         (437.6, 437.6), 1.0, 0, "big"),
}


def _inputs(B, nchan, nph, dfs, seed=0):
    """Seeds, dfs, a positive-ish portrait and noise scales from numpy."""
    r = np.random.default_rng(seed)
    keys = rng.fold_in(rng.key(seed + 17, device=CPU), torch.arange(2 * B))
    seeds = rng_hw.seed_words(keys).reshape(2, B, 2).contiguous()
    d = np.empty((2, B), np.float32)
    for i in range(2):
        d[i] = dfs[i]
    prof = r.normal(0.3, 0.4, (B, nchan, nph)).astype(np.float32)
    nn = r.uniform(0.5, 2.0, B).astype(np.float32)
    return seeds, torch.from_numpy(d), torch.from_numpy(prof), torch.from_numpy(nn)


def _field(seeds, dfs, mode, chan0, t0, nchan, nsamp):
    """The unfused path's draws: K1's plain version over the span."""
    b0, off = divmod(t0, rng_hw.RNG_BLOCK)
    B = seeds.shape[0]
    pos = torch.tensor([[chan0 // rng_hw.CHAN_GROUP, b0]] * B, dtype=torch.int32)
    return rng_hw.rng_field_plain(seeds, dfs, pos, mode, nchan,
                                  off + nsamp)[..., off:]


def _unfused(seeds, dfs, modes, prof, nn, *, nsub, chan0, t0, **kw):
    """The unfused path: K1's plain fields of the whole batch, then the
    fold, quantizer and packing (the plain version's body, through its
    field hook)."""
    B, C, nph = prof.shape
    fields = [_field(seeds[i], dfs[i], modes[i], chan0, t0, C, nsub * nph)
              for i in range(2)]
    return fq.fold_quantize_plain(seeds, dfs, modes, prof, nn, nsub=nsub,
                                  chan0=chan0, t0=t0, fields=fields, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_matches_unfused_path(case):
    B, C, chan0, nph, nsub, modes, dfs, dn, t0, order = CASES[case]
    seeds, dfs_t, prof, nn = _inputs(B, C, nph, dfs)
    kw = dict(nsub=nsub, draw_norm=dn, chan0=chan0, t0=t0, byte_order=order)
    got, fin = fq.fold_quantize_plain(seeds, dfs_t, modes, prof, nn, **kw)
    want, wfin = _unfused(seeds, dfs_t, modes, prof, nn, **kw)
    assert got.shape == (B, nsub, C, nph + 4) and got.dtype == torch.int16
    assert torch.equal(got, want)
    assert torch.equal(fin, wfin) and bool(fin.all())
    # the CPU wrapper is the plain version
    assert torch.equal(fq.fold_quantize(seeds, dfs_t, modes, prof, nn, **kw)[0],
                       got)


def _given_fields(B, C, nsamp, seed=1):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.chisquare(df, (B, C, nsamp)).astype(np.float32))
            for df in (437.6, 437.6)]


def test_fused_plain_constant_row():
    B, C, nph, nsub = 2, 8, 300, 2
    modes = ("chi2_wh", "chi2_wh")
    seeds, dfs, prof, nn = _inputs(B, C, nph, (437.6, 437.6))
    fields = _given_fields(B, C, nsub * nph)
    prof[1, 5] = 0.0
    fields[1][1, 5] = 2.0
    got, fin = fq.fold_quantize_plain(seeds, dfs, modes, prof, nn, nsub=nsub,
                                      fields=fields)
    assert bool(fin.all())
    data, scl, offs = _split_packed_chunk(got.numpy(), nph)
    assert not data[1, :, 5].any()
    np.testing.assert_array_equal(scl[1, :, 5], 1.0)
    np.testing.assert_array_equal(offs[1, :, 5], np.float32(2.0) * nn[1].numpy())


def test_fused_plain_nan_row_is_flagged_and_isolated():
    B, C, nph, nsub = 2, 13, 1000, 5
    modes = ("chi2_wh", "chi2_wh")
    seeds, dfs, prof, nn = _inputs(B, C, nph, (437.6, 437.6))
    clean = _given_fields(B, C, nsub * nph)
    fields = [f.clone() for f in clean]
    fields[0][0, 3, 1500] = float("nan")  # observation 0, subint 1, channel 3
    kw = dict(nsub=nsub, chan0=8, byte_order="big")
    got, fin = fq.fold_quantize_plain(seeds, dfs, modes, prof, nn,
                                      fields=fields, **kw)
    want, wfin = fq.fold_quantize_plain(seeds, dfs, modes, prof, nn,
                                        fields=clean, **kw)
    assert bool(wfin.all())
    assert not bool(fin[0, 3]) and int(fin.sum()) == B * C - 1
    keep = torch.ones((B, nsub, C), dtype=torch.bool)
    keep[0, 1, 3] = False
    assert torch.equal(got[keep], want[keep])


# -- against the JAX package ------------------------------------------------------


def _child(out):
    """Reference values from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.quantize import subint_quantize as r_quantize
    from psrsigsim_tpu.ops.quantize import swap16 as r_swap16
    from psrsigsim_tpu.ops.shift import fourier_shift
    from psrsigsim_tpu.ops.stats import chan_chi2_field
    from psrsigsim_tpu.parallel import FoldEnsemble
    from psrsigsim_tpu.simulate import build_fold_config
    from psrsigsim_tpu.simulate.pipeline import _dispersion_delays
    from psrsigsim_tpu.utils.rng import stage_key

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_pipeline import _geometry

    geom = _geometry("psrsigsim_tpu", "readme16")
    cfg, prof, nn = build_fold_config(*geom)
    dm = np.float32(geom[0].dm.value)
    freqs = jnp.asarray(np.asarray(cfg.meta.dat_freq_mhz(), np.float32))
    chan = jnp.arange(freqs.shape[0])
    quantize = jax.jit(lambda b: r_quantize(b, cfg.nsub, cfg.nph))

    def pack(d, s, o):  # ensemble.py:312-314
        return jnp.concatenate([d, jax.lax.bitcast_convert_type(s, jnp.int16),
                                jax.lax.bitcast_convert_type(o, jnp.int16)],
                               axis=-1)

    res = {k: [] for k in ("pulse", "noise", "prof", "le", "be")}
    for i in range(N_REF):
        k = stage_key(jax.random.key(SEED), "user", i)
        fp = chan_chi2_field(stage_key(k, "pulse"), chan, cfg.nfold, 0, cfg.nsamp)
        fn = chan_chi2_field(stage_key(k, "noise"), chan, cfg.noise_df, 0,
                             cfg.nsamp)
        ps = fourier_shift(jnp.asarray(prof),
                           _dispersion_delays(jnp.float32(dm), freqs, None),
                           dt=cfg.dt_ms)
        # the block, in the reference's arithmetic (pipeline.py:280-281, 314)
        block = jnp.tile(ps, (1, cfg.nsub)) * fp * cfg.draw_norm
        block = block + fn * np.float32(nn)
        d, s, o = quantize(block)
        res["pulse"].append(np.asarray(fp))
        res["noise"].append(np.asarray(fn))
        res["prof"].append(np.asarray(ps))
        res["le"].append(np.asarray(pack(d, s, o)))
        res["be"].append(np.asarray(pack(r_swap16(d), s, o)))
    res = {k: np.stack(v) for k, v in res.items()}
    res["cfg"] = np.array(repr(dataclasses.asdict(cfg)))
    res["nn"] = np.float32(nn)
    # the reference's jitted ensemble program on the same observations
    ens = FoldEnsemble(*_geometry("psrsigsim_tpu", "readme16"))
    for order, fn_name in (("le", "_run_sharded_quantized_packed"),
                           ("be", "_run_sharded_quantized_packed_be")):
        keys, dms, norms, scp, _ = ens._prep_inputs(N_REF, SEED, None, None)
        args = ens._program_args(keys, dms, norms, scp)
        res[f"ens_{order}"] = np.asarray(getattr(ens, fn_name)(*args)[0])[:N_REF]
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_fold_quantize") / "ref.npz"
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


def _ref_call(ref, order):
    from psrsigsim_torch.simulate import build_fold_config
    from test_torch_pipeline import _geometry

    cfg, _, nn = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    assert np.float32(nn) == ref["nn"]
    B = ref["prof"].shape[0]
    modes = ("chi2_wh", "chi2_wh")
    seeds = torch.zeros((2, B, 2), dtype=torch.int32)
    dfs = torch.full((2, B), cfg.nfold, dtype=torch.float32)
    return fq.fold_quantize_plain(
        seeds, dfs, modes, torch.from_numpy(ref["prof"]),
        torch.full((B,), nn, dtype=torch.float32), nsub=cfg.nsub,
        draw_norm=cfg.draw_norm, byte_order="big" if order == "be" else "little",
        fields=(torch.from_numpy(ref["pulse"]), torch.from_numpy(ref["noise"])))


@pytest.mark.parametrize("order", ["le", "be"])
def test_fused_plain_matches_jax_reference_bit_for_bit(ref, order):
    got, fin = _ref_call(ref, order)
    np.testing.assert_array_equal(got.numpy(), ref[order])
    assert bool(fin.all())


@pytest.mark.parametrize("order", ["le", "be"])
def test_fused_plain_matches_jax_ensemble_codes(ref, order):
    """Against the reference's jitted program, whose own draws and shift
    differ from the eager ones by an ulp here and there."""
    got, _ = _ref_call(ref, order)
    nbin = got.shape[-1] - 4
    d, s, o = _split_packed_chunk(got.numpy(), nbin)
    wd, ws, wo = _split_packed_chunk(ref[f"ens_{order}"], nbin)
    if order == "be":
        d, wd = d.view(">i2").astype(np.int16), wd.view(">i2").astype(np.int16)
    diff = d.astype(np.int32) - wd.astype(np.int32)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-2
    np.testing.assert_allclose(s, ws, rtol=1e-5)
    np.testing.assert_allclose(o, wo, rtol=1e-5)


# -- the route and the slice on the CPU ----------------------------------------------


@pytest.mark.parametrize("order", ["little", "big"])
def test_fused_pipeline_equals_unfused_ensemble_on_hw_stream(order, monkeypatch):
    """The whole slice: FoldEnsemble's unfused body on the hw sampler's
    stream (plain fields on the CPU) against fold_pipeline_quantized."""
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.simulate import fold_pipeline_quantized
    from test_torch_pipeline import _geometry

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    monkeypatch.delenv("PSS_EXACT_SHIFT", raising=False)
    ens = FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"), device="cpu")
    keys, dms, norms = ens._prep_chunk(np.arange(2), SEED, None, None)
    want, wfin = ens._quantized_packed(keys, dms, norms, order)
    got, fin = fold_pipeline_quantized(keys, dms, norms, ens._profiles, ens.cfg,
                                       freqs=ens._freqs, chan_ids=ens._chan_ids,
                                       byte_order=order)
    assert torch.equal(got, want) and torch.equal(fin, wfin)


def test_fused_route_follows_configuration(monkeypatch):
    from psrsigsim_torch.simulate import build_fold_config, fused_route
    from test_torch_pipeline import _geometry

    monkeypatch.delenv("PSS_SAMPLER", raising=False)
    monkeypatch.delenv("PSS_EXACT_CHI2", raising=False)
    monkeypatch.delenv("PSS_EXACT_SHIFT", raising=False)
    cfg, _, _ = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    assert fused_route(cfg, "cuda")
    assert not fused_route(cfg, "cpu")
    assert not fused_route(cfg, "cuda", null_frac=0.5)
    assert not fused_route(dataclasses.replace(cfg, shift_mode="fft"), "cuda")
    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    assert not fused_route(cfg, "cuda")
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    assert not fused_route(cfg, "cpu")
    monkeypatch.setenv("PSS_EXACT_SHIFT", "1")
    cfg_exact, _, _ = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    assert not fused_route(cfg_exact, "cuda")


def test_fold_quantize_checks_arguments():
    seeds, dfs, prof, nn = _inputs(2, 8, 64, (437.6, 437.6))
    modes = ("chi2_wh", "chi2_wh")
    kw = dict(nsub=2)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs, ("chi2_wh", "gamma"), prof, nn, **kw)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds[0], dfs, modes, prof, nn, **kw)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs.double(), modes, prof, nn, **kw)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs, modes, prof[0], nn, **kw)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs, modes, prof, nn[:1], **kw)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs, modes, prof, nn, nsub=0)
    with pytest.raises(ValueError):
        fq.fold_quantize(seeds, dfs, modes, prof, nn, byte_order="middle", **kw)


def test_fold_quantize_counts_only_kernel_launches():
    before = fq.fold_quantize.launches
    seeds, dfs, prof, nn = _inputs(1, 8, 64, (437.6, 437.6))
    fq.fold_quantize(seeds, dfs, ("chi2_wh", "chi2_wh"), prof, nn, nsub=1)
    assert fq.fold_quantize.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    dev = torch.device("cuda")
    assert fq.route(("chi2_wh", "chi2_wh"), 2048, 20) == "rows"
    assert fq.route(("chi2_wh", "chi2_wh"), 3072, 3) == "staged"
    assert fq.route(("chi2_wh", "chi2_1"), 2048, 20) == "staged"
    assert fq.route(("chi2_wh", "chi2_wh"), 8192, 2) == "two-pass"
    for case in CASES:
        B, C, chan0, nph, nsub, modes, dfs, dn, t0, order = CASES[case]
        args = [t.to(dev) for t in _inputs(B, C, nph, dfs)]
        kw = dict(nsub=nsub, draw_norm=dn, chan0=chan0, t0=t0, byte_order=order)
        got, fin = fq.fold_quantize(*args[:2], modes, *args[2:], **kw)
        want, wfin = fq.fold_quantize_plain(*args[:2], modes, *args[2:], **kw)
        assert torch.equal(got, want) and torch.equal(fin, wfin)


if __name__ == "__main__":
    _child(sys.argv[1])
