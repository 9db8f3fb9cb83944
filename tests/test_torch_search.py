"""The port's SEARCH mode (flat-tile χ² fields, ``single_pipeline`` with
nulling and the scenario's SEARCH hooks, ``build_single_config``) against
the JAX package, and against itself, on the CPU.

Geometry: BASELINE config 4 (bench.py ``build_single_workload``: 64
channels at 0.4096 MHz, P = 5 ms, 2048 samples a pulse, 2 s, 20% nulled)
for the configuration, cut to 8 channels and 100 pulses (0.5 s) for the
pipeline.  Tolerances and why:

* flat fields (threefry, the reference's sampler off a TPU): the same
  keys, bits and order and XLA's arithmetic written out (its ``erf_inv``
  with a correctly rounded square root, the Wilson–Hilferty add fused
  into a multiply-add as the jitted reference compiles it), so the
  normals, χ²(1) = z² and the Wilson–Hilferty cube (df ≥ 50 and a
  per-observation df) are bit-exact;
* ``build_single_config``: host float64 arithmetic in both — every field
  equal, the portrait bit-equal;
* ``single_pipeline``: the null masks (shared row and per-channel rolls),
  the pulse and noise fields and the replacement noise row bit-exact;
  the block within rtol 1e-5 with a floor of 1e-5 of its peak — the two
  FFT libraries of the Fourier shift round apart by ulps (the fold
  pipeline's gate, tests/test_torch_pipeline.py);
* the SEARCH scenario hooks: the factors are the scenario engine's draws
  (gains, masks and log-normal energies exact, the energies through
  XLA's ``exp`` written out), so the hooked block is bit-exact.

The port against itself: the flat kernel's wrapper equals the sampler's
plain rows reordered by the flat index formula; any span of a flat stream
equals the slice of a longer one; a record is bit-identical in any batch
on both samplers.  Reference values come from a child process (this file
run as a script) that applies the JAX-version shims R1 and R2.
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

SEED = 5
TILE = 8 * 4096
# (name, f0, length): aligned, unaligned start, length not a whole tile
FLAT_CASES = [("aligned", 0, 3 * TILE), ("unaligned", 12345, 50000),
              ("ragged", 2 * TILE, TILE + 4097)]
LONG = 1 << 21      # normals: ~8,000 beyond 2.9 sigma, erf_inv's root branch
DM = [15.9, 22.5]
STACKS = {"none": None,
          "scint": ["scintillation"],
          "rfi": ["rfi"],
          "frb": ["single_pulse:frb"],
          "all": ["scintillation", "rfi", "single_pulse:lognormal"]}
# (case, shift mode, stack, observations)
PIPE_CASES = [("env_none", "envelope", "none", 2),
              ("env_all", "envelope", "all", 2),
              ("env_scint", "envelope", "scint", 1),
              ("env_rfi", "envelope", "rfi", 1),
              ("env_frb", "envelope", "frb", 1),
              ("fft_none", "fft", "none", 1),
              ("fft_all", "fft", "all", 1)]
SCEN_PARAMS = {"scint_dnu_d_mhz": 30.0, "scint_dt_d_s": 0.02,
               "scint_mod": 0.8, "rfi_imp_prob": 0.3, "rfi_imp_snr": 5.0,
               "rfi_nb_prob": 0.3, "rfi_nb_snr": 3.0, "sp_sigma": 0.6,
               "sp_amp": 8.0}


def _objects(pkg, nchan, tobs):
    """BASELINE config 4's objects (bench.py build_single_workload) from
    either package, at ``nchan`` channels and ``tobs`` seconds."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu
                                       else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    sig = S.FilterBankSignal(1380, 400, Nsubband=nchan, sample_rate=0.4096,
                             fold=False)
    psr = P.Pulsar(0.005, 0.05, P.GaussProfile(width=0.05), name="BENCH",
                   seed=0)
    sig._tobs = U.make_quant(tobs, "s")
    tel = T.Telescope(100.0, area=5500.0, Tsys=35.0, name="BenchScope")
    tel.add_system("BenchSys", T.Receiver(fcent=1380, bandwidth=400, name="R"),
                   T.Backend(samprate=12.5, name="B"))
    return sig, psr, tel, "BenchSys"


def _params(labels, parse=None):
    """Fixed scenario parameters of the stack ``labels`` (``parse``: the
    package's ``parse_stack``, the port's by default)."""
    if labels is None:
        return None
    if parse is None:
        from psrsigsim_torch.scenarios import parse_stack as parse
    names = parse(labels).param_names()
    return {k: v for k, v in SCEN_PARAMS.items() if k in names}


def _exp_inputs():
    rng = np.random.default_rng(SEED)
    return np.concatenate([rng.uniform(-90.0, 90.0, 1 << 20),
                           rng.normal(0.0, 3.0, 1 << 19)]).astype(np.float32)


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.stats import (chan_chi2_field, flat_chi2_field,
                                         flat_normal_field)
    from psrsigsim_tpu.scenarios.registry import (
        apply_additive_effects_search, apply_pulse_effects_search, parse_stack)
    from psrsigsim_tpu.simulate.pipeline import (_null_mask_row, _search_chi2,
                                                 build_single_config,
                                                 single_pipeline)
    from psrsigsim_tpu.utils.constants import DM_K_MS_MHZ2
    from psrsigsim_tpu.utils.rng import stage_key

    res, meta = {}, {}
    keys = jax.vmap(lambda i: stage_key(jax.random.key(SEED), "user", i))(
        jnp.arange(2))
    res["keys"] = np.asarray(jax.random.key_data(keys))
    res["normal_long"] = np.asarray(jax.jit(
        lambda k: jax.random.normal(k, (LONG,), jnp.float32))(keys[0]))
    res["exp"] = np.asarray(jax.jit(jnp.exp)(_exp_inputs()))
    for name, f0, n in FLAT_CASES:
        res[f"normal_{name}"] = np.asarray(jax.jit(jax.vmap(
            lambda k: flat_normal_field(k, f0, n)))(keys))
        res[f"chi2_1_{name}"] = np.asarray(jax.jit(jax.vmap(
            lambda k: flat_chi2_field(k, f0, n, 1.0)))(keys))
    res["chi2_60"] = np.asarray(jax.jit(jax.vmap(
        lambda k: flat_chi2_field(k, 12345, 50000, 60.0)))(keys))
    res["chi2_obs"] = np.asarray(jax.jit(jax.vmap(
        lambda k, d: flat_chi2_field(k, 0, 50000, d)))(
            keys, jnp.asarray([1.0, 80.0], jnp.float32)))

    cfg, prof, nn = build_single_config(*_objects("psrsigsim_tpu", 64, 2.0),
                                        null_frac=0.2)
    meta["cfg4"] = dataclasses.asdict(cfg)
    res["prof4"], res["nn4"] = prof, np.float64(nn)

    cfg, prof, nn = build_single_config(*_objects("psrsigsim_tpu", 8, 0.5),
                                        null_frac=0.2)
    meta["cfg"] = dataclasses.asdict(cfg)
    res["prof"], res["nn"] = prof, np.float64(nn)
    freqs = jnp.asarray(cfg.meta.dat_freq_mhz(), jnp.float32)
    chan_ids = jnp.arange(cfg.meta.nchan)
    dms = jnp.asarray(DM, jnp.float32)
    nns = jnp.asarray([nn, 1.3 * nn], jnp.float32)
    for case, mode, stack, n in PIPE_CASES:
        c = dataclasses.replace(cfg, shift_mode=mode)
        labels = STACKS[stack]
        st = parse_stack(labels)
        sp = _params(labels, parse_stack)
        res[f"pipe_{case}"] = np.asarray(jax.vmap(
            lambda k, d, s: single_pipeline(
                k, d, s, jnp.asarray(prof), c, freqs=freqs, chan_ids=chan_ids,
                scenario=st, scenario_params=sp))(keys[:n], dms[:n], nns[:n]))

    # the pieces that must be exact
    def pieces(k, d):
        pulse = _search_chi2(stage_key(k, "pulse"), chan_ids, 1.0, cfg.nsamp,
                             cfg.meta.nchan)
        noise = _search_chi2(stage_key(k, "noise"), chan_ids, 1.0, cfg.nsamp,
                             cfg.meta.nchan)
        repl = chan_chi2_field(stage_key(k, "null_noise"),
                               jnp.asarray([cfg.meta.nchan]), 1.0, 0,
                               cfg.nsamp, aligned=True)[0]
        row = _null_mask_row(k, cfg, 0, cfg.nsamp)
        delays = DM_K_MS_MHZ2 * d / freqs ** 2
        dint = jnp.round(delays / cfg.dt_ms).astype(jnp.int32)
        rolled = jax.vmap(lambda s: jnp.roll(row, s))(dint)
        return pulse, noise, repl, row, rolled

    for name, a in zip(("pulse", "noise", "repl", "mask_row", "mask"),
                       jax.jit(jax.vmap(pieces))(keys, dms)):
        res[f"piece_{name}"] = np.asarray(a)

    # the hooks on a given block
    st = parse_stack(STACKS["all"])
    sp = _params(STACKS["all"], parse_stack)
    block = jax.random.uniform(jax.random.key(9), (cfg.meta.nchan,
                                                   cfg.nsamp), jnp.float32)
    res["hook_block"] = np.asarray(block)
    res["hook_pulse"] = np.asarray(jax.jit(lambda k, b: apply_pulse_effects_search(
        k, b, st, sp, nsub=cfg.nsub, nph=cfg.nph, nsamp=cfg.nsamp,
        freqs=freqs, fcent_mhz=cfg.meta.fcent_mhz, period_s=cfg.period_s,
        f_lo_mhz=cfg.meta.fcent_mhz - cfg.meta.bw_mhz / 2))(keys[0], block))
    res["hook_additive"] = np.asarray(jax.jit(
        lambda k, b: apply_additive_effects_search(
            k, b, st, sp, nsub=cfg.nsub, nph=cfg.nph, nsamp=cfg.nsamp,
            chan_ids=chan_ids, noise_level=jnp.float32(2.5)))(keys[0], block))
    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_search")
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


def _keys(ref):
    from psrsigsim_torch.utils import as_key

    return as_key(ref["keys"], "cpu")


def _config(nchan=8, tobs=0.5):
    from psrsigsim_torch.simulate import build_single_config

    return build_single_config(*_objects("psrsigsim_torch", nchan, tobs),
                               null_frac=0.2)


def _ulps(got, want):
    """Largest distance in float32 ulps (sign-magnitude, as
    tests/test_torch_rng.py counts them)."""
    def ordered(a):
        i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(got) - ordered(want)).max())


def test_xla_normal_and_exp_are_bit_exact(ref):
    """The threefry normals (XLA's ``erf_inv`` with its correctly rounded
    root) and XLA's ``exp`` as written out equal jitted jax's bytes."""
    from psrsigsim_torch.ops.stats import exp, normal

    got = normal(_keys(ref)[0], LONG).numpy()
    assert got.tobytes() == ref["normal_long"].tobytes()
    got = exp(torch.from_numpy(_exp_inputs())).numpy()
    assert got.tobytes() == ref["exp"].tobytes()


@pytest.mark.parametrize("name,f0,n", FLAT_CASES)
def test_flat_fields_match_reference(ref, name, f0, n):
    from psrsigsim_torch.ops.stats import flat_chi2_field, flat_normal_field

    keys = _keys(ref)
    assert _ulps(flat_normal_field(keys, f0, n).numpy(),
                 ref[f"normal_{name}"]) == 0
    assert _ulps(flat_chi2_field(keys, f0, n, 1.0).numpy(),
                 ref[f"chi2_1_{name}"]) == 0


def test_flat_chi2_wilson_hilferty_and_per_observation_df(ref):
    from psrsigsim_torch.ops.stats import flat_chi2_field

    keys = _keys(ref)
    got = flat_chi2_field(keys, 12345, 50000, 60.0).numpy()
    assert _ulps(got, ref["chi2_60"]) == 0
    got = flat_chi2_field(keys, 0, 50000,
                          torch.tensor([1.0, 80.0])).numpy()
    assert _ulps(got[0], ref["chi2_obs"][0]) == 0
    assert _ulps(got[1], ref["chi2_obs"][1]) == 0


def test_flat_chi2_guard_and_small_df():
    from psrsigsim_torch.ops import stats

    assert stats.flat_chi2_ok(1.0) and stats.flat_chi2_ok(50.0)
    assert not stats.flat_chi2_ok(3.0)
    assert stats.flat_chi2_ok(torch.tensor([1.0, 80.0]))
    assert not stats.flat_chi2_ok(1.0, span_end=2**31)
    assert stats.flat_chi2_ok(1.0, span_end=2**31 - 1)
    with pytest.raises(ValueError, match="gamma"):
        stats.flat_chi2_field(torch.zeros(2, dtype=torch.int64), 0, 10, 3.0)
    os.environ["PSS_EXACT_CHI2"] = "1"
    try:
        assert not stats.flat_chi2_ok(1.0)
    finally:
        os.environ.pop("PSS_EXACT_CHI2")


@pytest.mark.parametrize("mode,df", [("normal", 0.0), ("chi2_1", 0.0),
                                     ("chi2_wh", 120.0), ("chi2_sel", 1.0)])
@pytest.mark.parametrize("skip,length", [(0, 2 * TILE), (1234, 50000),
                                         (4097, 4999), (TILE - 3, 10)])
def test_flat_kernel_wrapper_is_the_rows_in_flat_order(mode, df, skip, length):
    """The flat wrapper (its plain version on the CPU) stores sample ``s``
    of channel ``c`` in block ``b0 + t`` at flat index ``(t·8 + c)·4096 +
    s``: held to the sampler's rows through that formula."""
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.utils import fold_in, key

    keys = fold_in(key(2, "cpu"), torch.arange(2))
    seeds = rng_hw.seed_words(keys)
    dfs = torch.full((2,), df)
    pos = torch.tensor([[0, 3], [0, 7]], dtype=torch.int32)
    got = rng_hw.rng_flat_field(seeds, dfs, pos, mode, skip, length)
    nt = -(-(skip + length) // TILE)
    rows = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 8, nt * 4096)
    g = np.arange(skip, skip + length)
    t, rem = np.divmod(g, TILE)
    c, s = np.divmod(rem, 4096)
    want = rows[:, c, t * 4096 + s]
    assert got.shape == (2, length) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rng_hw.rng_flat_field.launches == 0   # the CPU never launches


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
def test_flat_span_is_a_slice_of_a_longer_span(monkeypatch, sampler):
    from psrsigsim_torch.ops.stats import flat_chi2_field
    from psrsigsim_torch.utils import fold_in, key

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    keys = fold_in(key(4, "cpu"), torch.arange(2))
    whole = flat_chi2_field(keys, 0, 3 * TILE, 1.0)
    for f0, n in ((0, 3 * TILE), (5, 40000), (TILE + 17, 20001)):
        torch.testing.assert_close(flat_chi2_field(keys, f0, n, 1.0),
                                   whole[:, f0:f0 + n], rtol=0, atol=0)


def test_build_single_config_matches_reference(ref):
    cfg, prof, nn = _config(64, 2.0)
    assert dataclasses.asdict(cfg) == ref["cfg4"]
    np.testing.assert_array_equal(prof, ref["prof4"])
    assert nn == float(ref["nn4"])
    assert (cfg.meta.nchan, cfg.nph, cfg.nsub, cfg.nsamp, cfg.n_null) == \
        (64, 2048, 400, 819200, 80)


def test_build_single_config_rejects_fold_and_fractional_sampling():
    from psrsigsim_torch.simulate import build_single_config

    sig, psr, tel, system = _objects("psrsigsim_torch", 4, 0.1)
    sig._fold = True
    with pytest.raises(ValueError, match="fold=False"):
        build_single_config(sig, psr, tel, system)
    sig, psr, tel, system = _objects("psrsigsim_torch", 4, 0.1)
    sig._samprate = sig.samprate * 0.9999
    with pytest.raises(ValueError, match="integral"):
        build_single_config(sig, psr, tel, system)


@pytest.fixture(scope="module")
def staged():
    return _config()


@pytest.mark.parametrize("case,mode,stack,n", PIPE_CASES)
def test_single_pipeline_matches_reference(ref, staged, case, mode, stack, n):
    from psrsigsim_torch.simulate import single_pipeline

    cfg, prof, nn = staged
    assert dataclasses.asdict(cfg) == ref["cfg"]
    labels = STACKS[stack]
    got = single_pipeline(
        _keys(ref)[:n], torch.tensor(DM[:n]),
        torch.tensor([nn, 1.3 * nn], dtype=torch.float32)[:n], prof,
        dataclasses.replace(cfg, shift_mode=mode), device="cpu",
        scenario=labels, scenario_params=_params(labels)).numpy()
    want = ref[f"pipe_{case}"]
    assert got.shape == want.shape == (n, 8, cfg.nsamp)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_search_fields_and_null_masks_exact(ref, staged):
    from psrsigsim_torch.simulate.pipeline import (_chan_chi2,
                                                   _dispersion_delays,
                                                   _null_mask_row,
                                                   _roll_rows, _search_chi2)
    from psrsigsim_torch.utils import stage_key

    cfg, _, _ = staged
    keys = _keys(ref)
    chan_ids = torch.arange(8)
    for stage in ("pulse", "noise"):
        got = _search_chi2(stage_key(keys, stage), chan_ids, 1.0, cfg.nsamp, 8)
        assert _ulps(got.numpy(), ref[f"piece_{stage}"]) == 0
    got = _chan_chi2(stage_key(keys, "null_noise"), torch.tensor([8]), 1.0,
                     cfg.nsamp)[:, 0]
    assert _ulps(got.numpy(), ref["piece_repl"]) == 0
    row = _null_mask_row(keys, cfg, 0, cfg.nsamp, torch.device("cpu"))
    np.testing.assert_array_equal(row.numpy(), ref["piece_mask_row"])
    assert int(row[0].sum()) == cfg.n_null * cfg.nph
    freqs = torch.tensor(np.asarray(cfg.meta.dat_freq_mhz(), np.float32))
    delays = _dispersion_delays(torch.tensor(DM), freqs, None)
    inv_dt = float(np.float32(1.0) / np.float32(cfg.dt_ms))
    dint = torch.round(delays * inv_dt).to(torch.int64)
    np.testing.assert_array_equal(_roll_rows(row, dint).numpy(),
                                  ref["piece_mask"])


def test_search_hooks_match_reference(ref, staged):
    from psrsigsim_torch.scenarios import (apply_additive_effects_search,
                                           apply_pulse_effects_search)

    cfg, _, _ = staged
    key0 = _keys(ref)[0]
    block = torch.from_numpy(ref["hook_block"])
    freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
    got = apply_pulse_effects_search(
        key0, block.clone(), STACKS["all"], _params(STACKS["all"]),
        nsub=cfg.nsub, nph=cfg.nph, nsamp=cfg.nsamp, freqs=freqs,
        fcent_mhz=cfg.meta.fcent_mhz, period_s=cfg.period_s,
        f_lo_mhz=cfg.meta.fcent_mhz - cfg.meta.bw_mhz / 2).numpy()
    assert _ulps(got, ref["hook_pulse"]) == 0
    got = apply_additive_effects_search(
        key0, block.clone(), STACKS["all"], _params(STACKS["all"]),
        nsub=cfg.nsub, nph=cfg.nph, nsamp=cfg.nsamp, chan_ids=torch.arange(8),
        noise_level=2.5).numpy()
    assert _ulps(got, ref["hook_additive"]) == 0


def test_ragged_tail_clamps_into_the_last_pulse():
    """``nsamp`` not a whole number of pulses: the tail takes the last
    pulse's factor (the reference's ``_subint_of_sample``), both ways."""
    from psrsigsim_torch.scenarios.registry import _per_pulse

    nph, nsub = 4, 3
    factor = torch.tensor([[2.0, 3.0, 5.0]])
    for nsamp, want in ((14, [2] * 4 + [3] * 4 + [5] * 6),
                        (10, [2] * 4 + [3] * 4 + [5] * 2),
                        (12, [2] * 4 + [3] * 4 + [5] * 4)):
        got = _per_pulse(torch.ones(1, nsamp), factor, nph, nsub,
                         torch.Tensor.mul_)
        assert got[0].tolist() == want


def test_batched_permutation_equals_one_key_at_a_time():
    from psrsigsim_torch.utils import fold_in, key, permutation

    keys = fold_in(key(8, "cpu"), torch.arange(3))
    batch = permutation(keys, 400)
    for i in range(3):
        assert torch.equal(batch[i], permutation(keys[i], 400))
    assert sorted(batch[1].tolist()) == list(range(400))


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
def test_single_pipeline_does_not_depend_on_the_batch(monkeypatch, staged,
                                                      sampler):
    """An observation's block is the same bits alone and in a batch (its
    keys, fields, mask and Fourier shift are per observation), with every
    effect on, on both samplers; on ``hw`` the flat fields come from the
    flat kernel's plain version."""
    from psrsigsim_torch.simulate import single_pipeline
    from psrsigsim_torch.utils import key, stage_key

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    cfg, prof, nn = staged
    cfg = dataclasses.replace(cfg, nsub=20, nsamp=20 * cfg.nph + 777,
                              n_null=4)
    keys = stage_key(key(1, "cpu"), "user", torch.arange(3))
    dms = torch.tensor([10.0, 15.9, 40.0])
    nns = torch.full((3,), nn, dtype=torch.float32)
    kw = dict(device="cpu", scenario=STACKS["all"],
              scenario_params=_params(STACKS["all"]))
    batch = single_pipeline(keys, dms, nns, prof, cfg, **kw)
    assert batch.shape == (3, 8, cfg.nsamp) and bool(torch.isfinite(batch).all())
    for i in (0, 2):
        one = single_pipeline(keys[i:i + 1], dms[i:i + 1], nns[i:i + 1],
                              prof, cfg, **kw)
        assert torch.equal(one[0], batch[i])


def test_nulled_windows_carry_the_replacement_row(staged):
    """Each nulled window holds the one off-pulse replacement row in every
    channel: with no dispersion and a zero noise scale the block there is
    exactly ``repl · off_pulse_mean``, the same row across channels."""
    from psrsigsim_torch.simulate import single_pipeline
    from psrsigsim_torch.simulate.pipeline import _chan_chi2, _null_mask_row
    from psrsigsim_torch.utils import key, stage_key

    cfg, prof, _ = staged
    cfg = dataclasses.replace(cfg, nsub=10, nsamp=10 * cfg.nph, n_null=3,
                              off_pulse_mean=0.25)
    keys = stage_key(key(2, "cpu"), "user", torch.arange(1))
    block = single_pipeline(keys, torch.zeros(1), torch.zeros(1), prof, cfg,
                            device="cpu")
    mask = _null_mask_row(keys, cfg, 0, cfg.nsamp, torch.device("cpu"))[0]
    assert 0 < int(mask.sum()) <= 3 * cfg.nph
    repl = _chan_chi2(stage_key(keys, "null_noise"), torch.tensor([8]), 1.0,
                      cfg.nsamp)[0, 0] * 0.25
    held = block[0][:, mask]
    assert torch.equal(held, repl[mask].expand_as(held))
    assert not torch.equal(block[0][:, ~mask][0], repl[~mask])


@pytest.mark.cuda
def test_search_on_the_card_matches_the_host():
    """On the card: the flat kernel equals its plain version bit for bit in
    every mode, and single_pipeline equals a PSS_SAMPLER=hw host run within
    the pipeline's tolerance, with 2 flat launches and 1 row launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flat kernel has no CPU mode")
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.simulate import single_pipeline
    from psrsigsim_torch.utils import fold_in, key, stage_key

    dev = torch.device("cuda")
    keys = fold_in(key(2, dev), torch.arange(3, device=dev))
    seeds = rng_hw.seed_words(keys)
    pos = torch.tensor([[0, 1]] * 3, dtype=torch.int32, device=dev)
    for mode, df in (("normal", 0.0), ("chi2_1", 0.0), ("chi2_wh", 99.0),
                     ("chi2_sel", 1.0)):
        dfs = torch.full((3,), df, device=dev)
        for skip, length in ((0, 3 * TILE), (1234, 50001), (5, 7)):
            got = rng_hw.rng_flat_field(seeds, dfs, pos, mode, skip, length)
            want = rng_hw.rng_flat_field_plain(seeds, dfs, pos, mode, skip,
                                               length)
            assert torch.equal(got, want), (mode, skip, length)
    cfg, prof, nn = _config()
    hk = stage_key(key(3, "cpu"), "user", torch.arange(2))
    rng_hw.rng_field.launches = rng_hw.rng_flat_field.launches = 0
    card = single_pipeline(hk, torch.tensor(DM), torch.full((2,), nn), prof,
                           cfg, device=dev, scenario=STACKS["all"],
                           scenario_params=_params(STACKS["all"]))
    assert (rng_hw.rng_flat_field.launches, rng_hw.rng_field.launches) == (2, 1)
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        host = single_pipeline(hk, torch.tensor(DM), torch.full((2,), nn),
                               prof, cfg, device="cpu", scenario=STACKS["all"],
                               scenario_params=_params(STACKS["all"]))
    finally:
        os.environ.pop("PSS_SAMPLER")
    want = host.numpy()
    np.testing.assert_allclose(card.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


if __name__ == "__main__":
    _child(sys.argv[1])
