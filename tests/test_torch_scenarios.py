"""The port's scenario engine (``psrsigsim_torch.scenarios``,
``ops/scenario.py``) against the JAX package's, and against itself, on the
CPU.

Tolerances and why:

* the registry (labels, parameter names, defaults, ``parse_stack`` and
  ``stack_from_knobs`` canonicalisation, the errors): pure Python, equal;
* the draws, against the JAX package's jitted ops: every key is jax's bit
  for bit and the float arithmetic is the one XLA's CPU backend compiles
  (``pow`` rounded from float64, its ``log1p``, its fused multiply-adds), so
  the scintle cell ids, the RFI truth mask and the FRB energies are exact —
  the cell-id flips are counted and must be 0 (DIVERGENCES P13) — and the
  gains and RFI levels are held within 2 ulp (measured 0); the power-law
  energies within 1 ulp (measured 0) and the log-normal ones within 2 ulp
  (torch's ``exp`` against XLA's: measured 1);
* ``fold_pipeline(scenario=)`` against the JAX package's: rtol 1e-5, floor
  1e-5 of the peak (the two FFT libraries of the Fourier shift, and XLA's
  fused multiply-adds in the noise and RFI adds);
* ``run_quantized(return_rfi=True)`` against the JAX package's ensemble:
  the existing bound of tests/test_torch_pipeline.py (codes ≤1 LSB on ≤1%,
  scl/offs rtol 1e-5), the truth mask exact;
* the port against itself: bit for bit (chunk sizes 32/128/512, the fused
  route's plain version against the unfused body, a study trial against
  the ensemble's observation, identity parameters against no scenario).

Reference values come from a child process (this file run as a script)
that applies the JAX-version shims; they never touch the pytest worker.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_pipeline import _geometry  # noqa: E402
from test_torch_toa import child_env, shims  # noqa: E402

SEED = 3
N_OBS = 6
STACK = ["scintillation", "rfi", "single_pulse:lognormal"]
# per-observation parameters of STACK (N_OBS each) and scalars
PARAMS = {"scint_dnu_d_mhz": [5.0, 20.0, 50.0, 80.0, 12.5, 35.0],
          "scint_dt_d_s": [3.0, 1.0, 0.5, 8.0, 2.0, 1.5],
          "scint_mod": [1.0, 0.7, 0.3, 0.9, 0.5, 1.0],
          "rfi_imp_prob": 0.4, "rfi_imp_snr": [2.0, 5.0, 8.0, 1.0, 3.0, 6.0],
          "rfi_nb_prob": 0.25, "sp_sigma": [0.5, 1.0, 0.2, 2.0, 0.8, 0.1]}
# (label lists, knob sets) the registry is held to
STACKS = [["rfi"], ["single_pulse"], ["single_pulse:frb", "scintillation"],
          [("single_pulse", "powerlaw"), "rfi", "scintillation"],
          ["rfi", "rfi"], [], None]
BAD_STACKS = [["bogus"], ["rfi:loud"], ["single_pulse:gauss"],
              ["single_pulse:frb", "single_pulse:powerlaw"]]
KNOB_SETS = [["dm"], ["scint_mod", "dm"], ["rfi_nb_snr"], ["sp_amp"],
             ["sp_alpha", "scint_dt_d_s", "rfi_imp_prob"],
             ["sp_sigma", "sp_amp"]]
# the draws' geometry: BASELINE config 1's band (64 channels over 400 MHz at
# 1380 MHz, 20 x 60 s subints), 48 observations
OPS = dict(B=48, C=64, nsub=20, fcent=1380.0, bw=400.0, sublen=60.0)


def _registry_dump(reg):
    """Everything the registry says, as JSON-able values."""
    out = {"order": list(reg.EFFECT_ORDER), "knobs": list(reg.scenario_knobs()),
           "effects": {n: [reg.EFFECTS[n].stage, list(reg.EFFECTS[n].modes),
                           reg.EFFECTS[n].default_mode,
                           [[p.name, p.default, p.lo, p.hi]
                            for p in reg.EFFECTS[n].params]]
                       for n in reg.EFFECT_ORDER},
           "stacks": [], "bad": [], "knob_stacks": []}
    for items in STACKS:
        st = reg.parse_stack(items)
        out["stacks"].append(None if st is None else [
            [list(e) for e in st.entries], st.labels(), st.label(),
            list(st.param_names()), st.describe(),
            list(reg.default_params(st))])
    for items in BAD_STACKS:
        try:
            reg.parse_stack(items)
            out["bad"].append(None)
        except ValueError as err:
            out["bad"].append(str(err))
    for knobs in KNOB_SETS:
        try:
            st = reg.stack_from_knobs(knobs)
            out["knob_stacks"].append(None if st is None else st.labels())
        except ValueError as err:
            out["knob_stacks"].append(str(err))
    return out


def _ops_inputs():
    r = np.random.default_rng(11)
    B = OPS["B"]
    return dict(
        dnu=np.exp(r.uniform(np.log(0.05), np.log(500.0), B)).astype(np.float32),
        dt=np.exp(r.uniform(np.log(2.0), np.log(2000.0), B)).astype(np.float32),
        mod=r.uniform(0.0, 1.0, B).astype(np.float32),
        rfi=r.uniform(0.0, 1.0, (4, B)).astype(np.float32) * np.array(
            [[1.0], [10.0], [1.0], [10.0]], np.float32),
        sigma=r.uniform(0.0, 3.0, B).astype(np.float32),
        alpha=r.uniform(0.5, 6.0, B).astype(np.float32),
        amp=r.uniform(0.0, 50.0, B).astype(np.float32))


def _ops_freqs():
    C, fc, bw = OPS["C"], OPS["fcent"], OPS["bw"]
    return (fc - bw / 2 + bw / C * (np.arange(C) + 0.5)).astype(np.float32)


# -- the JAX reference (child process) -------------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops import scenario as S
    from psrsigsim_tpu.parallel import FoldEnsemble
    from psrsigsim_tpu.scenarios import registry as reg
    from psrsigsim_tpu.simulate import build_fold_config, fold_pipeline
    from psrsigsim_tpu.utils.rng import stage_key

    res = {}
    with open(os.path.join(out, "registry.json"), "w") as fh:
        json.dump(_registry_dump(reg), fh)

    # the draws, vmapped and jitted as the ensemble's program runs them
    B, C, nsub = OPS["B"], OPS["C"], OPS["nsub"]
    fc, bw, sublen = OPS["fcent"], OPS["bw"], OPS["sublen"]
    f_lo = fc - bw / 2
    x = _ops_inputs()
    freqs = jnp.asarray(_ops_freqs())
    root = jax.random.key(SEED)

    def keys(stage):
        k = jax.vmap(lambda i: stage_key(root, stage, i))(jnp.arange(B))
        res[f"keys_{stage}"] = np.asarray(jax.random.key_data(k))
        return k

    ks = keys("scint")
    res["gain"] = np.asarray(jax.jit(jax.vmap(
        lambda k, d, t, m: S.scint_gain(k, freqs, nsub, d, t, m, fc, sublen,
                                        f_lo_mhz=f_lo)))(
        ks, x["dnu"], x["dt"], x["mod"]))

    def cells(d, t):  # ops/scenario.py scint_gain's cell ids, line for line
        xx = freqs / jnp.float32(fc)
        dnu = jnp.maximum(jnp.float32(d), 1e-6)
        dt = jnp.maximum(jnp.float32(t), 1e-6)
        x_lo = jnp.asarray(f_lo, jnp.float32) / jnp.float32(fc)
        a = jnp.float32(S.SCINT_DNU_EXPONENT - 1.0)
        n_f = (jnp.float32(fc) / dnu) * (x_lo ** -a - xx ** -a) / a
        t_mid = (jnp.arange(nsub, dtype=jnp.float32) + 0.5) \
            * jnp.float32(sublen)
        dt_c = dt * xx ** jnp.float32(S.SCINT_DT_EXPONENT)
        return (S._cell_clip(n_f),
                S._cell_clip(t_mid[None, :] / dt_c[:, None]))

    cf, ct = jax.jit(jax.vmap(cells))(x["dnu"], x["dt"])
    res["cell_f"], res["cell_t"] = np.asarray(cf), np.asarray(ct)
    kr = keys("rfi")
    lv, mk = jax.jit(jax.vmap(lambda k, a, b, c, d: S.rfi_levels(
        k, jnp.arange(C), nsub, a, b, c, d)))(kr, *x["rfi"])
    res["rfi_levels"], res["rfi_mask"] = np.asarray(lv), np.asarray(mk)
    kt = keys("transient")
    for mode, par in (("lognormal", "sigma"), ("powerlaw", "alpha"),
                      ("frb", "amp")):
        res[f"energy_{mode}"] = np.asarray(jax.jit(jax.vmap(
            lambda k, p, m=mode: S.pulse_energies(k, nsub, m, p)))(
            kt, x[par]))

    # one observation through fold_pipeline with each stack
    geom = _geometry("psrsigsim_tpu", "readme16")
    cfg, prof, nn = build_fold_config(*geom)
    f = jnp.asarray(np.asarray(cfg.meta.dat_freq_mhz(), np.float32))
    kw = dict(freqs=f, chan_ids=jnp.arange(f.shape[0]))
    key = jax.random.key(11)
    for i, labels in enumerate((STACK, ["single_pulse:frb", "rfi"],
                                ["single_pulse:powerlaw", "scintillation"])):
        st = reg.parse_stack(labels)
        sp = {n: jnp.float32(np.ravel(PARAMS.get(n, reg._param(n).default))[0])
              for n in st.param_names()}
        res[f"fold_{i}"] = np.asarray(jax.jit(
            lambda k, p, s=st: fold_pipeline(
                k, jnp.float32(15.99), jnp.float32(nn), prof, cfg,
                scenario=s, scenario_params=p, **kw))(key, sp))

    # the ensemble: quantized run with the truth mask, per-observation params
    ens = FoldEnsemble(*_geometry("psrsigsim_tpu", "readme16"),
                       scenario=STACK)
    d, s, o, fin, rfi = ens.run_quantized(
        N_OBS, seed=SEED, return_finite=True, return_rfi=True,
        scenario_params={k: np.asarray(v, np.float32)
                         for k, v in PARAMS.items()})
    for name, v in (("ens_data", d), ("ens_scl", s), ("ens_offs", o),
                    ("ens_finite", fin), ("ens_rfi", rfi)):
        res[name] = np.asarray(v)
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    saved = os.environ.get("PSS_SCENARIO_REF")
    if saved:
        # the reference this file wrote as a script on a machine with jax
        # (the card's machine has none)
        out = pathlib.Path(saved)
    else:
        if importlib.util.find_spec("jax") is None:
            pytest.skip("the JAX reference needs jax: run this file as a "
                        "script where jax is installed and name its output "
                        "directory in PSS_SCENARIO_REF")
        out = tmp_path_factory.mktemp("torch_scenarios")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               str(out)], env=child_env(),
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        res = dict(z)
    with open(out / "registry.json") as fh:
        res["registry"] = json.load(fh)
    return res


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY"):
        monkeypatch.delenv(k, raising=False)


def _ulps(got, want):
    got = np.ascontiguousarray(got, np.float32).view(np.int32).astype(np.int64)
    want = np.ascontiguousarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(got - want)


def _keys(ref, stage):
    from psrsigsim_torch.utils import as_key, key, stage_key

    k = stage_key(key(SEED, "cpu"), stage, torch.arange(OPS["B"]))
    assert torch.equal(k, as_key(ref[f"keys_{stage}"], "cpu"))
    return k


def _codes_close(got, want):
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-2


# -- the registry ----------------------------------------------------------------------


def test_registry_matches_reference(ref):
    from psrsigsim_torch.scenarios import registry as reg

    assert json.loads(json.dumps(_registry_dump(reg))) == ref["registry"]


def test_registry_param_dict_and_errors():
    from psrsigsim_torch.scenarios import registry as reg

    st = reg.parse_stack(["single_pulse:frb", "rfi"])
    assert st.labels() == ["rfi", "single_pulse:frb"]
    assert reg.parse_stack(st) is st
    p = reg.param_dict(st, {"rfi_nb_prob": 0.5})
    assert p["rfi_nb_prob"] == 0.5 and p["sp_amp"] == np.float32(10.0)
    assert reg.param_dict(st, range(7)) == dict(zip(st.param_names(),
                                                   range(7)))
    with pytest.raises(ValueError, match="expects 7"):
        reg.param_dict(st, [1.0])
    # the SEARCH hooks (ported with single_pipeline) refuse a stream whose
    # length is not the configuration's
    block = torch.ones(2, 10)
    with pytest.raises(ValueError, match="samples"):
        reg.apply_pulse_effects_search(
            None, block, st, None, nsub=2, nph=4, nsamp=12, freqs=[1.0, 2.0],
            fcent_mhz=1.5, period_s=0.005, f_lo_mhz=1.0)
    with pytest.raises(ValueError, match="samples"):
        reg.apply_additive_effects_search(
            None, block, st, None, nsub=2, nph=4, nsamp=12,
            chan_ids=torch.arange(2), noise_level=1.0)


# -- the draws ---------------------------------------------------------------------------


# the draws' keys on the host (the torch CPU route) and on the card (the
# scenario-draws kernel, K10): both are held to the JAX package's draws
KEY_DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _on(dev):
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device(dev)


def _host_of(t, dev):
    assert t.device.type == dev.type
    return t.cpu().numpy()


@pytest.mark.parametrize("dev", KEY_DEVICES)
def test_scint_cells_exact_and_gains_within_2_ulp(ref, dev):
    from psrsigsim_torch.ops import scenario as S

    dev = _on(dev)
    x = _ops_inputs()
    args = (_ops_freqs(), OPS["nsub"], torch.from_numpy(x["dnu"]),
            torch.from_numpy(x["dt"]))
    geo = (OPS["fcent"], OPS["sublen"], OPS["fcent"] - OPS["bw"] / 2)
    cf, ct = S.scint_cells(*args, *geo)
    flips = int((cf.numpy() != ref["cell_f"]).sum()
                + (ct.numpy() != ref["cell_t"]).sum())
    assert flips == 0, f"{flips} scintle cell ids flipped"
    assert len(np.unique(ref["cell_t"])) > 100   # the cells do vary
    g = S.scint_gain(_keys(ref, "scint").to(dev), *args,
                     torch.from_numpy(x["mod"]), *geo)
    assert g.shape == ref["gain"].shape and g.dtype == torch.float32
    assert _ulps(_host_of(g, dev), ref["gain"]).max() <= 2


@pytest.mark.parametrize("dev", KEY_DEVICES)
def test_rfi_mask_exact_and_levels_within_2_ulp(ref, dev):
    from psrsigsim_torch.ops import scenario as S

    dev = _on(dev)
    x = _ops_inputs()
    lv, mk = S.rfi_levels(_keys(ref, "rfi").to(dev), torch.arange(OPS["C"]),
                          OPS["nsub"], *(torch.from_numpy(v) for v in x["rfi"]))
    np.testing.assert_array_equal(_host_of(mk, dev), ref["rfi_mask"])
    assert 0 < ref["rfi_mask"].mean() < 1
    assert _ulps(_host_of(lv, dev), ref["rfi_levels"]).max() <= 2


@pytest.mark.parametrize("dev", KEY_DEVICES)
@pytest.mark.parametrize("mode,par,ulps", [("lognormal", "sigma", 2),
                                           ("powerlaw", "alpha", 1),
                                           ("frb", "amp", 0)])
def test_pulse_energies_match_reference(ref, mode, par, ulps, dev):
    from psrsigsim_torch.ops import scenario as S

    dev = _on(dev)
    e = _host_of(S.pulse_energies(_keys(ref, "transient").to(dev),
                                  OPS["nsub"], mode,
                                  torch.from_numpy(_ops_inputs()[par])), dev)
    want = ref[f"energy_{mode}"]
    if mode == "frb":
        np.testing.assert_array_equal(e, want)
        assert ((want != 0).sum(axis=1) <= 1).all()
    else:
        assert _ulps(e, want).max() <= ulps


def test_unknown_mode_raises():
    from psrsigsim_torch.ops import scenario as S
    from psrsigsim_torch.utils import key

    with pytest.raises(ValueError, match="single-pulse mode"):
        S.pulse_energies(key(1, "cpu")[None], 4, "gauss", 1.0)


# -- the pipeline and the ensemble against the JAX package ------------------------------------


@pytest.mark.parametrize("i,labels", [(0, STACK), (1, ["single_pulse:frb", "rfi"]),
                                      (2, ["single_pulse:powerlaw",
                                           "scintillation"])])
def test_fold_pipeline_scenario_matches_reference(ref, i, labels):
    from psrsigsim_torch.scenarios import registry as reg
    from psrsigsim_torch.simulate import build_fold_config, fold_pipeline
    from psrsigsim_torch.utils import key

    cfg, prof, nn = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    st = reg.parse_stack(labels)
    sp = {n: float(np.float32(np.ravel(PARAMS.get(n, reg._param(n).default))[0]))
          for n in st.param_names()}
    got = fold_pipeline(key(11, "cpu"), 15.99, np.float32(nn), prof, cfg,
                        scenario=labels, scenario_params=sp, device="cpu")
    want = ref[f"fold_{i}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    plain = fold_pipeline(key(11, "cpu"), 15.99, np.float32(nn), prof, cfg,
                          device="cpu")
    assert not torch.equal(got, plain)   # the effects did land


@pytest.fixture(scope="module")
def ens():
    from psrsigsim_torch.parallel import FoldEnsemble

    return FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                        device="cpu", scenario=STACK)


def _params():
    return {k: np.asarray(v, np.float32) if np.ndim(v) else v
            for k, v in PARAMS.items()}


def test_run_quantized_rfi_matches_reference(ref, ens):
    d, s, o, fin, rfi = ens.run_quantized(N_OBS, seed=SEED, return_finite=True,
                                          return_rfi=True,
                                          scenario_params=_params())
    np.testing.assert_array_equal(rfi.numpy(), ref["ens_rfi"])
    assert rfi.shape == (N_OBS, 16, ens.cfg.nsub) and rfi.any()
    np.testing.assert_array_equal(fin.numpy(), ref["ens_finite"])
    _codes_close(d.numpy(), ref["ens_data"])
    np.testing.assert_allclose(s.numpy(), ref["ens_scl"], rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref["ens_offs"], rtol=1e-5)


# -- the port against itself ----------------------------------------------------------------


def _small_ensemble(scenario, nph=64):
    """readme16's band and subints with a short random portrait (the chunk
    tests need hundreds of observations)."""
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.simulate import build_fold_config

    cfg, _, nn = build_fold_config(*_geometry("psrsigsim_torch", "readme16"))
    cfg = dataclasses.replace(cfg, nph=nph)
    prof = np.random.default_rng(5).uniform(0.1, 1.0, (16, nph))
    return FoldEnsemble.from_config(cfg, prof.astype(np.float32), nn,
                                    dm=15.99, device="cpu", scenario=scenario)


def test_chunk_size_invariance(monkeypatch):
    """Quantized chunks and their truth masks are bit-identical for chunk
    sizes 32, 128 and 512 (the draws key off global observation ids)."""
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    ens = _small_ensemble(STACK)
    n = 520
    r = np.random.default_rng(2)
    sp = {"scint_dnu_d_mhz": r.uniform(1.0, 80.0, n).astype(np.float32),
          "rfi_imp_prob": 0.3, "sp_sigma": r.uniform(0.0, 2.0, n)}
    runs = []
    for cs in (32, 128, 512):
        parts = list(ens.iter_chunks(n, chunk_size=cs, seed=SEED,
                                     quantized=True, finite_mask=True,
                                     rfi_mask=True, scenario_params=sp))
        runs.append([np.concatenate([p[1][j] for p in parts])
                     for j in range(5)])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    # the float path carries the same mask
    parts = list(ens.iter_chunks(40, chunk_size=16, seed=SEED, rfi_mask=True,
                                 scenario_params={k: v[:40] if np.ndim(v) else v
                                                  for k, v in sp.items()}))
    mask = np.concatenate([p[1][1] for p in parts])
    np.testing.assert_array_equal(mask, runs[0][4][:40])


def test_fused_plain_equals_unfused_scenario_body(monkeypatch):
    """The fused route's plain version with the scenario factors equals the
    ensemble's unfused body bit for bit, on the hw sampler's stream — for
    every sp mode and for rfi alone."""
    from psrsigsim_torch.simulate import fold_pipeline_quantized

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    for labels in (STACK, ["single_pulse:powerlaw", "rfi", "scintillation"],
                   ["single_pulse:frb", "scintillation"], ["rfi"]):
        ens = _small_ensemble(labels, nph=128)
        idx = np.arange(5)
        keys, dms, norms = ens._prep_chunk(idx, SEED, None, None)
        rows = ens._rows(keys, norms, ens._prep_scenario(idx, None))
        for order in ("little", "big"):
            want = ens._unfused_packed(keys, dms, norms, order, rows)
            got = fold_pipeline_quantized(
                keys, dms, norms, ens._profiles, ens.cfg, freqs=ens._freqs,
                chan_ids=ens._chan_ids, byte_order=order, rows=rows)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            # and drawing the rows inside gives the same bytes
            again = fold_pipeline_quantized(
                keys, dms, norms, ens._profiles, ens.cfg, freqs=ens._freqs,
                chan_ids=ens._chan_ids, byte_order=order, scenario=labels)
            assert torch.equal(again[0], want[0])


def test_disabled_is_free(monkeypatch):
    """scenario=None never enters the engine, and a stack whose effects
    are identities (no modulation, no RFI, unit energies) writes the
    scenario-free bytes."""
    import psrsigsim_torch.scenarios.registry as reg

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    free = _small_ensemble(None)
    ident = _small_ensemble(STACK)
    want = free.run_quantized(8, seed=SEED, return_finite=True)
    got = ident.run_quantized(8, seed=SEED, return_finite=True,
                              scenario_params={"scint_mod": 0.0,
                                               "rfi_imp_prob": 0.0,
                                               "rfi_nb_prob": 0.0,
                                               "sp_sigma": 0.0})
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    def boom(*a, **k):
        raise AssertionError("the scenario engine ran without a scenario")

    monkeypatch.setattr(reg, "_draw", boom)   # every scenario draw
    again = free.run_quantized(8, seed=SEED, return_finite=True)
    for a, b in zip(again, want):
        assert torch.equal(a, b)
    list(free.iter_chunks(8, chunk_size=4, seed=SEED, quantized=True))
    free.run(2, seed=SEED)


def test_salted_retry_draws_the_salted_scenario(ens):
    """run_quantized_at(fold_salt=) re-draws the scenario from the salted
    key, as the JAX package's _prep_chunk(fold_salt=) gives it."""
    from psrsigsim_torch.scenarios import rfi_truth_mask
    from psrsigsim_torch.utils import fold_in, key, stage_key

    sp = _params()
    out = ens.run_quantized_at([1, 4], seed=SEED, fold_salt=77,
                               scenario_params=sp, return_rfi=True)
    keys = fold_in(stage_key(key(SEED, "cpu"), "user", torch.tensor([1, 4])),
                   77)
    prm = ens._prep_scenario(np.array([1, 4]), sp)
    want = rfi_truth_mask(keys, ens.scenario, prm, nsub=ens.cfg.nsub,
                          chan_ids=ens._chan_ids)
    assert torch.equal(out[4], want)
    main = ens.run_quantized_at([1, 4], seed=SEED, scenario_params=sp,
                                return_rfi=True)
    full = ens.run_quantized(N_OBS, seed=SEED, return_rfi=True,
                             scenario_params=sp)
    assert torch.equal(main[0], full[0][[1, 4]])
    assert torch.equal(main[4], full[3][[1, 4]])
    assert not torch.equal(out[0], main[0])


def test_scenario_params_validation(ens):
    from psrsigsim_torch.parallel import FoldEnsemble

    with pytest.raises(ValueError, match="unknown scenario parameter"):
        ens.run(2, scenario_params={"null_frac": 0.5})
    with pytest.raises(ValueError, match="shape"):
        ens.run(2, scenario_params={"scint_mod": [0.1, 0.2, 0.3]})
    free = FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                        device="cpu")
    with pytest.raises(ValueError, match="without a scenario"):
        free.run(2, scenario_params={"scint_mod": 0.5})
    with pytest.raises(ValueError, match="RFI scenario"):
        free.run_quantized(2, return_rfi=True)
    with pytest.raises(ValueError, match="RFI scenario"):
        next(free.iter_chunks(2, quantized=True, rfi_mask=True))
    with pytest.raises(ValueError, match="invalid scenario"):
        FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"), device="cpu",
                     scenario=["bogus"])


def test_truth_helpers_read_the_injection(ens):
    """rfi_truth_mask and energy_truth recompute what the injection drew;
    apply_pulse_effects / apply_additive_effects are the pipeline's steps."""
    from psrsigsim_torch.scenarios import registry as reg
    from psrsigsim_torch.simulate.pipeline import noise_level

    idx = np.arange(3)
    keys, dms, norms = ens._prep_chunk(idx, SEED, None, None)
    prm = ens._prep_scenario(idx, {"rfi_imp_prob": 0.5})
    rows = ens._rows(keys, norms, prm)
    cfg = ens.cfg
    assert torch.equal(reg.rfi_truth_mask(keys, ens.scenario, prm,
                                          nsub=cfg.nsub,
                                          chan_ids=ens._chan_ids), rows.mask)
    assert torch.equal(reg.energy_truth(keys, ens.scenario, prm,
                                        nsub=cfg.nsub), rows.energy)
    assert reg.energy_truth(keys, reg.parse_stack(["rfi"]), {},
                            nsub=cfg.nsub) is None
    block = torch.ones((3, cfg.meta.nchan, cfg.nsamp))
    pulse = reg.apply_pulse_effects(
        keys, block.clone(), ens.scenario, prm, nsub=cfg.nsub, nph=cfg.nph,
        freqs=ens._freqs_np, fcent_mhz=cfg.meta.fcent_mhz,
        sublen_s=cfg.nfold * cfg.period_s,
        f_lo_mhz=cfg.meta.fcent_mhz - cfg.meta.bw_mhz / 2)
    want = reg.apply_scenario_pulse(block.clone(), rows, cfg.nsub, cfg.nph)
    assert torch.equal(pulse, want)
    add = reg.apply_additive_effects(keys, block.clone(), ens.scenario, prm,
                                     nsub=cfg.nsub, nph=cfg.nph,
                                     chan_ids=ens._chan_ids,
                                     noise_level=noise_level(cfg, norms))
    assert torch.equal(add, reg.apply_scenario_additive(block.clone(), rows,
                                                        cfg.nsub, cfg.nph))


def test_study_trial_equals_ensemble_observation(monkeypatch):
    """A Monte-Carlo trial with scenario priors is the ensemble's
    observation with the trial's parameters, bit for bit."""
    from psrsigsim_torch.mc import LogUniform, Uniform

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    ens = _small_ensemble(["scintillation", "rfi", "single_pulse:powerlaw"])
    study = ens.to_mc_study({"scint_mod": Uniform(0.0, 1.0),
                             "rfi_imp_snr": Uniform(1.0, 9.0),
                             "sp_alpha": Uniform(1.5, 4.0),
                             "noise_scale": LogUniform(0.5, 2.0)}, seed=SEED)
    assert study._scenario == ens.scenario
    n = 6
    idx = np.arange(n)
    keys = study._trial_keys(idx)
    p = study._sample_params(keys, idx)
    block = study._trial_block(keys, p)[0]
    norms = (np.float32(ens.noise_norm) * p["noise_scale"].numpy()).astype(
        np.float64)
    want = ens.run(n, seed=SEED, noise_norms=norms, scenario_params={
        k: p[k].numpy() for k in ("scint_mod", "rfi_imp_snr", "sp_alpha")})
    assert torch.equal(block, want)
    fp = study.fingerprint(n)
    assert fp["scenarios"] == ["scintillation", "rfi",
                               "single_pulse:powerlaw"]
    assert set(fp["scenario_defaults"]) == {
        "scint_dnu_d_mhz", "scint_dt_d_s", "rfi_imp_prob", "rfi_nb_prob",
        "rfi_nb_snr", "sp_sigma", "sp_amp"}


# -- the kernel on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_scenario_kernel_matches_plain_version_on_card():
    """Every factor set on every route of the fused kernel, bit for bit
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops import fold_quantize as fq
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.utils import fold_in, key

    dev = torch.device("cuda")
    r = np.random.default_rng(4)
    for nph, nsub, modes, route in ((512, 6, ("chi2_wh", "chi2_wh"), "rows"),
                                    (1000, 3, ("chi2_wh", "chi2_1"), "staged"),
                                    (8192, 2, ("chi2_wh", "chi2_wh"),
                                     "two-pass")):
        assert fq.route(modes, nph, nsub) == route
        B, C = 2, 13
        keys = fold_in(key(9, "cpu"), torch.arange(2 * B))
        a = dict(
            seeds=rng_hw.seed_words(keys).reshape(2, B, 2).contiguous().to(dev),
            dfs=torch.full((2, B), 437.6, device=dev), modes=modes,
            prof=torch.tensor(r.normal(0.3, 0.4, (B, C, nph)),
                              dtype=torch.float32, device=dev),
            noise_norm=torch.tensor(r.uniform(0.5, 2.0, B),
                                    dtype=torch.float32, device=dev))
        fac = dict(
            gain=torch.tensor(r.exponential(1.0, (B, C, nsub)),
                              dtype=torch.float32, device=dev),
            energy=torch.tensor(r.lognormal(0.0, 1.0, (B, nsub)),
                                dtype=torch.float32, device=dev),
            level=torch.tensor(r.exponential(2000.0, (B, C, nsub)),
                               dtype=torch.float32, device=dev))
        for fx in range(8):
            kw = {k: v for j, (k, v) in enumerate(fac.items()) if fx >> j & 1}
            for order in ("little", "big"):
                got = fq.fold_quantize(**a, nsub=nsub, chan0=8, draw_norm=0.37,
                                       byte_order=order, **kw)
                want = fq.fold_quantize_plain(**a, nsub=nsub, chan0=8,
                                              draw_norm=0.37,
                                              byte_order=order, **kw)
                assert torch.equal(got[0], want[0]), (route, fx, order)
                assert torch.equal(got[1], want[1]), (route, fx, order)


# the scenario-draws kernel's cases: (observations, channel ids of the
# 64-channel band, subints, subint length in s, knobs) at BASELINE config
# 1's band; knobs are scalars or ranges drawn per observation
K10_CASES = {
    # the benchmark cell's chunk: 128 x 64 x 20 at 60 s
    "cell": (128, range(64), 20, 60.0, dict(
        dnu=50.0, dt=60.0, mod=(0.2, 1.0), imp_prob=(0.0, 0.5), imp_snr=5.0,
        nb_prob=0.1, nb_snr=3.0, noise=(0.5, 2.0), sigma=0.5,
        alpha=(0.5, 6.0), amp=10.0)),
    # single pulses: the time cell is one 5 ms period
    "single_pulse": (8, range(64), 600, 0.005, dict(
        dnu=(0.05, 500.0), dt=(0.01, 1.0), mod=(0.0, 1.0),
        imp_prob=(0.0, 1.0), imp_snr=(0.0, 10.0), nb_prob=(0.0, 1.0),
        nb_snr=(0.0, 10.0), noise=(0.5, 2.0), sigma=(0.0, 3.0),
        alpha=(0.5, 6.0), amp=(0.0, 50.0))),
    # a mesh position's channels, the cells anchored at the global floor
    "sub_band": (48, range(16, 48), 20, 60.0, dict(
        dnu=(0.05, 500.0), dt=(2.0, 2000.0), mod=(0.0, 1.0),
        imp_prob=(0.0, 1.0), imp_snr=(0.0, 10.0), nb_prob=(0.0, 1.0),
        nb_snr=(0.0, 10.0), noise=1.0, sigma=(0.0, 3.0), alpha=(0.5, 6.0),
        amp=(0.0, 50.0))),
    # the edges: no and saturated modulation, never and always RFI, a
    # scintillation bandwidth that clips the cell ids at 2**24 (and one
    # under the 1e-6 clamp)
    "edges": (6, range(64), 20, 60.0, dict(
        dnu=[1e-5, 1e-7, 50.0, 1e-5, 3.0, 1e-7],
        dt=[60.0, 1e-9, 60.0, 0.5, 60.0, 1e-3],
        mod=[0.0, 1.0, 0.0, 1.0, 0.5, 1.0],
        imp_prob=[0.0, 1.0, 1.0, 0.0, 0.5, 1.0],
        imp_snr=5.0, nb_prob=[0.0, 1.0, 0.0, 1.0, 0.1, 1.0], nb_snr=3.0,
        noise=[1.0, 2.0, 0.5, 1.0, 1.0, 3.0], sigma=[0.0, 5.0, 0.5, 1.0,
                                                     2.0, 0.1],
        alpha=[1.0, 1.05, 10.0, 0.5, 2.5, 1.5], amp=[0.0, 1.0, 10.0, 1e4,
                                                    -2.0, 3.0])),
}


def _k10_inputs(case):
    """Host stage keys, channel frequencies and ids, and the knobs of a
    :data:`K10_CASES` case (float32 scalars or per-observation arrays)."""
    from psrsigsim_torch.utils import fold_in, key, stage_key

    B, chans, nsub, sublen, knobs = K10_CASES[case]
    r = np.random.default_rng(sorted(K10_CASES).index(case))
    ids = np.asarray(chans, np.int64)
    freqs = (1180.0 + 400.0 / 64 * (ids + 0.5)).astype(np.float32)
    kn = {}
    for k, v in knobs.items():
        if isinstance(v, tuple):
            v = r.uniform(*v, B)
        kn[k] = (torch.tensor(np.asarray(v, np.float32)) if np.ndim(v)
                 else float(np.float32(v)))
    obs = fold_in(key(2**31 - 9, "cpu"), torch.arange(B))
    keys = {s: stage_key(obs, s) for s in ("scint", "rfi", "transient")}
    return keys, freqs, torch.from_numpy(ids), nsub, sublen, kn


def _k10_draws(case, dev):
    """Every draw of a case with its keys on ``dev``: the gains, the
    levels (bare and scaled) and mask, and the energies of each mode."""
    from psrsigsim_torch.ops import scenario as S

    keys, freqs, ids, nsub, sublen, kn = _k10_inputs(case)
    k = {s: v.to(dev) for s, v in keys.items()}
    out = {"gain": S.scint_gain(k["scint"], freqs, nsub, kn["dnu"], kn["dt"],
                                kn["mod"], 1380.0, sublen, f_lo_mhz=1180.0)}
    rfi = (kn["imp_prob"], kn["imp_snr"], kn["nb_prob"], kn["nb_snr"])
    out["level"], out["mask"] = S.rfi_levels(k["rfi"], ids, nsub, *rfi)
    out["scaled"], _ = S.rfi_levels(k["rfi"], ids, nsub, *rfi,
                                    noise_level=kn["noise"])
    for mode, par in (("lognormal", "sigma"), ("powerlaw", "alpha"),
                      ("frb", "amp")):
        out[mode] = S.pulse_energies(k["transient"], nsub, mode, kn[par])
    return out


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K10_CASES))
def test_scenario_draws_kernel_equals_the_host_route_on_card(case):
    """Keys on the card launch K10 (one launch a draw, counted), and its
    gains, levels, mask and energies are the host route's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops import scenario as S
    from psrsigsim_torch.ops import scenario_draws

    host = _k10_draws(case, "cpu")
    before = scenario_draws.launches
    card = _k10_draws(case, "cuda")
    assert scenario_draws.launches - before == len(card) - 1  # one rfi pair
    for name, want in host.items():
        got = card[name]
        assert got.device.type == "cuda" and got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        assert torch.equal(_bits(got), _bits(want)), (
            f"{case} {name}: {int((_bits(got) != _bits(want)).sum())} of "
            f"{want.numel()} differ")
    if case == "edges":
        keys, freqs, _, nsub, sublen, kn = _k10_inputs(case)
        cf, ct = S.scint_cells(freqs, nsub, kn["dnu"], kn["dt"], 1380.0,
                               sublen, 1180.0)
        assert int(cf.max()) == 2**24 and int(ct.max()) == 2**24
        assert host["mask"][1].all() and not host["mask"][0].any()
        assert torch.equal(host["gain"][0], torch.ones_like(host["gain"][0]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,nsub", [("powerlaw", 256), ("lognormal", 256),
                                       ("frb", 7), ("frb", 600)])
def test_scenario_draws_kernel_energies_over_a_million_draws(mode, nsub):
    """Every single-pulse mode over 2**20 draws or more (the power law's
    float64 pow rounded to float32 on both routes), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops import scenario as S
    from psrsigsim_torch.utils import fold_in, key, stage_key

    B = -(-2**20 // nsub)
    keys = stage_key(fold_in(key(12345, "cpu"), torch.arange(B)), "transient")
    par = torch.tensor(np.random.default_rng(nsub).uniform(
        0.5, 6.0, B).astype(np.float32))
    want = S.pulse_energies(keys, nsub, mode, par)
    got = S.pulse_energies(keys.cuda(), nsub, mode, par.cuda())
    diff = int((_bits(got) != _bits(want)).sum())
    assert diff == 0, f"{mode}: {diff} of {want.numel()} draws differ"


@pytest.mark.cuda
def test_scenario_rows_on_card_equal_the_host_rows():
    """scenario_rows with its factors bound for the card: the observation
    keys and parameters cross in one copy, K10 derives the stage keys and
    every effect launches it inside its span (four launches, counted as
    scenario.card_launches), and the rows are the host's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.runtime.telemetry import StageTimers

    e = _small_ensemble(STACK)
    idx = np.arange(128)
    keys, _, norms = e._prep_chunk(idx, SEED, None, None)
    prm = e._prep_scenario(idx, _cell_knobs(len(idx)))
    want = e._rows(keys, norms, prm)
    t = StageTimers()
    with t.span("dispatch"):
        got = e._rows(keys, norms.cuda(), prm)
    assert t.counter("scenario.card_launches") == 4
    assert t.counter("scenario.scint_keys") == 0
    for name in ("gain", "energy", "level", "mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.device.type == "cuda", name
        assert torch.equal(_bits(g), _bits(w)), name


def _cell_knobs(n):
    r = np.random.default_rng(21)
    return {"scint_mod": r.uniform(0.2, 1.0, n).astype(np.float32),
            "rfi_imp_prob": r.uniform(0.0, 0.5, n).astype(np.float32)}


def test_host_keys_take_the_host_route():
    """Factors bound for the host are drawn on the host: no K10 launch, no
    card launch counted, the distinct scintle keys counted instead."""
    from psrsigsim_torch.ops import scenario_draws
    from psrsigsim_torch.runtime.telemetry import StageTimers

    e = _small_ensemble(STACK)
    idx = np.arange(16)
    keys, _, norms = e._prep_chunk(idx, SEED, None, None)
    before = scenario_draws.launches
    t = StageTimers()
    with t.span("dispatch"):
        rows = e._rows(keys, norms, e._prep_scenario(idx, _cell_knobs(16)))
    assert scenario_draws.launches == before
    assert t.counter("scenario.card_launches") == 0
    assert t.counter("scenario.scint_keys") > 0
    assert all(getattr(rows, n).device.type == "cpu"
               for n in ("gain", "energy", "level", "mask"))


def test_card_packing_round_trips():
    """scenario_draws.to_card's one buffer: the observation keys' words and
    every parameter column read back as they went in (on the host, where
    the copy is the identity), a value for all as one element, and the
    kernel's columns take what is already there without a copy."""
    from psrsigsim_torch.ops import scenario_draws as sd
    from psrsigsim_torch.utils import fold_in, key

    cpu = torch.device("cpu")
    ok = fold_in(key(7, "cpu"), torch.arange(15)).reshape(5, 3, 2)
    p = [0.25, torch.arange(15, dtype=torch.float32).view(5, 3) / 3,
         np.float32(2.0**-20), np.arange(3, dtype=np.float64)]
    keys, cols = sd.to_card(p, (5, 3), cpu, ok)
    assert torch.equal(keys, ok) and len(cols) == 4
    assert torch.equal(cols[0], torch.tensor([0.25]))
    assert torch.equal(cols[1], p[1])
    assert torch.equal(cols[2], torch.tensor([2.0**-20]))
    assert torch.equal(cols[3], torch.arange(3.0).expand(5, 3))
    assert sd.to_card([], (5, 3), cpu) == (None, [])
    assert sd.to_card([1.5], (5, 3), cpu)[0] is None
    got = sd._columns(cols + [3.0], (5, 3), cpu)
    assert [s for _, s in got] == [0, 1, 0, 1, 0]
    assert all(got[j][0] is cols[j] for j in range(4))
    assert torch.equal(got[4][0], torch.tensor([3.0]))


def test_fold_quantize_checks_factors():
    from psrsigsim_torch.ops import fold_quantize as fq
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.utils import fold_in, key

    B, C, nph, nsub = 2, 8, 64, 3
    seeds = rng_hw.seed_words(fold_in(key(1, "cpu"), torch.arange(4))).reshape(
        2, B, 2).contiguous()
    args = (seeds, torch.full((2, B), 437.6), ("chi2_wh", "chi2_wh"),
            torch.ones((B, C, nph)), torch.ones(B))
    with pytest.raises(ValueError, match="gain"):
        fq.fold_quantize(*args, nsub=nsub, gain=torch.ones((B, nsub)))
    with pytest.raises(ValueError, match="energy"):
        fq.fold_quantize(*args, nsub=nsub, energy=torch.ones((B, C, nsub)))
    with pytest.raises(ValueError, match="level"):
        fq.fold_quantize(*args, nsub=nsub,
                         level=torch.ones((B, C, nsub), dtype=torch.float64))
    # factors of one: the scenario-free codes
    free = fq.fold_quantize(*args, nsub=nsub)
    ones = fq.fold_quantize(*args, nsub=nsub, gain=torch.ones((B, C, nsub)),
                            energy=torch.ones((B, nsub)),
                            level=torch.zeros((B, C, nsub)))
    assert torch.equal(free[0], ones[0])


if __name__ == "__main__":
    _child(sys.argv[1])
