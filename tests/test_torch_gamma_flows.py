"""The exact-gamma χ² branch through the port's pipelines and flows,
against the JAX package, on the CPU.

Every entry point that the JAX package routes to ``jax.random.gamma`` —
Nfold below 50, or ``PSS_EXACT_CHI2=1`` — runs in both packages on the same
objects and seeds; the port runs on ``device="cpu"``.  Tolerances and why:

* the object-oriented draws (``make_pulses`` in fold mode at Nfold 20 and
  in SEARCH mode under the hatch, ``Receiver.radiometer_noise`` and
  ``Pulsar.null`` at Nfold 20): bit-exact where the reference is a normal
  number — the gamma draws are jax's (tests/test_torch_gamma.py) and the
  kernels' arithmetic XLA's, the radiometer noise with the constants XLA
  folds into its scale — and within 1e-30 of the peak below float32 tiny,
  where XLA flushes a subnormal portrait value (P8).
* the pipelines (``fold_pipeline``, ``FoldEnsemble.run``/``run_quantized``/
  ``iter_chunks`` and its PSRFITS export, ``single_pipeline``, ``MultiPulsarFoldEnsemble``, the
  Monte-Carlo study, the service and the dataset factory): their fields are
  those draws and the Fourier shift rounds apart by FFT ulps — float
  blocks within rtol 1e-5 plus 1e-5 of the peak, codes within 1 LSB on at
  most 1%, study rows as tests/test_torch_mc.py holds them, dataset labels
  byte for byte (the fold pipeline's gates).

Against itself: the codes are the same bits for any chunk size, and
``fused_route`` declines these configurations (the fused kernel has no
gamma mode).  Reference values come from a child process (this file run as
a script) that applies the JAX-version shims R1 and R2.
"""

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

SEED = 3
N_OBS = 4
TINY = float(np.finfo(np.float32).tiny)
#: the Monte-Carlo study, the served request and the dataset at Nfold 20
#: (0.1 s subints of a 5 ms pulsar) or under the hatch
MC_SUBLEN = 0.1
N_MC = 6
SERVE_SPEC = {"nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
              "sample_rate_mhz": 0.2048, "sublen_s": 0.1, "tobs_s": 0.2,
              "period_s": 0.005, "smean_jy": 0.05, "seed": 3, "dm": 10.0}
DATASET_SPEC = {"nchan": 2, "fcent_mhz": 1400.0, "bw_mhz": 200.0,
                "sample_rate_mhz": 0.2048, "tobs_s": 0.02,
                "period_s": 0.005, "smean_jy": 0.05, "seed": 1,
                "n_records": 3, "dm": 10, "noise_scale": 1}


def _fold_geometry(pkg, hatch=False):
    """The README's J1713+0747 fold geometry cut to 16 channels and 4
    subints: 0.0914 s subints (Nfold 20), or 2 s (Nfold 437.6) for the
    hatch cases."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu
                                       else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    sublen = 2.0 if hatch else 0.0914
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=16, sample_rate=0.2048,
                             fold=True, sublen=sublen)
    psr = P.Pulsar(0.00457, 0.03, P.GaussProfile(peak=0.5, width=0.02),
                   name="J1713+0747", seed=0)
    sig._tobs = U.make_quant(4 * sublen, "s")
    sig._dm = U.make_quant(15.99, "pc/cm^3")
    return sig, psr, T.GBT(), "Lband_GUPPI"


def _oo_flows(pkg):
    """The object-oriented draws at Nfold 20 (and SEARCH under the hatch)
    in package ``pkg``: a dict of arrays."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu
                                       else ".models.telescope"))
    kw = {} if tpu else {"device": "cpu"}
    host = np.asarray if tpu else (lambda t: t.numpy())
    out = {}
    sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=8, sample_rate=0.2048,
                             fold=True, sublen=0.0914, **kw)
    psr = P.Pulsar(0.00457, 0.03, P.GaussProfile(peak=0.5, width=0.02),
                   name="J1713+0747", seed=2)
    psr.make_pulses(sig, tobs=0.3656)
    out["fold_pulses"] = host(sig.data)
    out["fold_nfold"] = np.float64(sig.Nfold)
    T.Receiver(fcent=1400, bandwidth=400, name="R", seed=11).radiometer_noise(
        sig, psr)
    out["fold_noise"] = host(sig.data)
    psr.null(sig, 0.5)
    out["fold_null"] = host(sig.data)
    os.environ["PSS_EXACT_CHI2"] = "1"
    try:
        sig = S.FilterBankSignal(1400.0, 400.0, Nsubband=8,
                                 sample_rate=0.2048, fold=False, **kw)
        psr = P.Pulsar(0.005, 0.03, P.GaussProfile(peak=0.5, width=0.05),
                       name="S", seed=4)
        psr.make_pulses(sig, tobs=0.05)
        out["search_hatch_pulses"] = host(sig.data)
    finally:
        del os.environ["PSS_EXACT_CHI2"]
    return out


def _multi_workloads(pkg):
    from test_torch_multipulsar import _workload

    return [_workload(pkg, 0.005, 10.0, sublen=0.5),
            _workload(pkg, 0.005, 25.0, width=0.06, sublen=0.1)]


def _search_objects(pkg):
    from test_torch_search import _objects

    return _objects(pkg, 8, 0.1)


def _export_template():
    from test_torch_export import TEMPLATE

    return TEMPLATE


def _sim_config():
    from test_torch_mc import DM_NS, SIM_CONFIG

    return dict(SIM_CONFIG, sublen=MC_SUBLEN), DM_NS


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.datasets import DatasetFactory, DatasetReader
    from psrsigsim_tpu.mc import MonteCarloStudy
    from psrsigsim_tpu.parallel import (FoldEnsemble, MultiPulsarFoldEnsemble,
                                        make_mesh)
    from psrsigsim_tpu.serve import SimulationService
    from psrsigsim_tpu.simulate import (Simulation, build_fold_config,
                                        build_single_config, fold_pipeline,
                                        single_pipeline)
    from psrsigsim_tpu.utils.rng import stage_key

    res, meta = {}, {}
    for hatch in (False, True):
        tag = "hatch" if hatch else "nf20"
        if hatch:
            os.environ["PSS_EXACT_CHI2"] = "1"
        geom = _fold_geometry("psrsigsim_tpu", hatch)
        if not hatch:
            cfg, prof, nn = build_fold_config(*geom)
            freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
            res["fold_nfold"] = np.float64(cfg.nfold)
            res["fold_pipe"] = np.asarray(fold_pipeline(
                jax.random.key(11), np.float32(15.99), np.float32(nn), prof,
                cfg, freqs=jnp.asarray(freqs),
                chan_ids=jnp.arange(freqs.shape[0])))
        ens = FoldEnsemble(*geom)
        if not hatch:
            from psrsigsim_tpu.io import export_ensemble_psrfits

            export_ensemble_psrfits(
                ens, N_OBS, os.path.join(os.path.dirname(out), "export"),
                _export_template(), ens.pulsar, seed=SEED, chunk_size=2,
                writers=1, pipeline_depth=0)
        res[f"ens_{tag}_block"] = np.asarray(ens.run(N_OBS, seed=SEED))
        d, s, o = ens.run_quantized(N_OBS, seed=SEED)
        res[f"ens_{tag}_data"], res[f"ens_{tag}_scl"], res[f"ens_{tag}_offs"] \
            = map(np.asarray, (d, s, o))
        os.environ.pop("PSS_EXACT_CHI2", None)

    res.update({f"oo_{n}": v for n, v in _oo_flows("psrsigsim_tpu").items()})

    sim, priors = _sim_config()
    study = MonteCarloStudy.from_simulation(Simulation(psrdict=sim), priors,
                                            seed=SEED)
    res["mc_metrics"] = study.run(N_MC, chunk_size=N_MC).metrics
    meta["mc_names"] = list(study.metric_names)
    svc = SimulationService(cache_dir=None, widths=(1,))
    try:
        rid, _ = svc.submit(SERVE_SPEC)
        res["served"] = np.asarray(svc.result(rid, timeout=600))
    finally:
        svc.close()

    os.environ["PSS_EXACT_CHI2"] = "1"
    ens = MultiPulsarFoldEnsemble(_multi_workloads("psrsigsim_tpu"),
                                  mesh=make_mesh((1, 1)))
    for i, a in enumerate(ens.run(epochs=2, seed=0)):
        res[f"multi_{i}"] = np.asarray(a)
    # single_pipeline jitted, as the pipelines run it: df = 1 is a static
    # alpha = 0.5, the boost's power a square
    cfg, prof, nn = build_single_config(*_search_objects("psrsigsim_tpu"),
                                        null_frac=0.2)
    keys = jax.vmap(lambda i: stage_key(jax.random.key(SEED), "user", i))(
        jnp.arange(2))
    res["search_keys"] = np.asarray(jax.random.key_data(keys))
    freqs = jnp.asarray(cfg.meta.dat_freq_mhz(), jnp.float32)
    res["search_block"] = np.asarray(jax.jit(jax.vmap(
        lambda k, d, s: single_pipeline(k, d, s, jnp.asarray(prof), cfg,
                                        freqs=freqs,
                                        chan_ids=jnp.arange(8))))(
        keys, jnp.asarray([12.0, 30.0], jnp.float32),
        jnp.asarray([nn, 1.3 * nn], jnp.float32)))
    corpus = os.path.join(os.path.dirname(out), "corpus")
    DatasetFactory(DATASET_SPEC).run(corpus, chunk_size=3)
    reader = DatasetReader(corpus)
    for i in range(DATASET_SPEC["n_records"]):
        res[f"record_{i}"] = np.frombuffer(reader.record_bytes(i), np.uint8)
        res[f"tile_{i}"] = reader.read_index(i)["tile"]
    os.environ.pop("PSS_EXACT_CHI2", None)
    np.savez(out, **res)
    with open(os.path.join(os.path.dirname(out), "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_gamma_flows") / "ref.npz"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        res = dict(z)
    with open(out.parent / "meta.json") as fh:
        res.update(json.load(fh))
    res["export_dir"] = str(out.parent / "export")
    return res


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_CHI2", "PSS_EXACT_SHIFT"):
        monkeypatch.delenv(k, raising=False)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _codes_close(got, want):
    diff = got.astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 1e-2


# -- (c) the fold pipeline and the ensemble ------------------------------------


@pytest.fixture(scope="module")
def nf20():
    from psrsigsim_torch.parallel import FoldEnsemble

    return FoldEnsemble(*_fold_geometry("psrsigsim_torch"), device="cpu")


def test_fold_pipeline_at_nfold_20_matches_reference(ref):
    from psrsigsim_torch.simulate import build_fold_config, fold_pipeline
    from psrsigsim_torch.simulate.pipeline import fused_route
    from psrsigsim_torch.utils import key

    cfg, prof, nn = build_fold_config(*_fold_geometry("psrsigsim_torch"))
    assert cfg.nfold == ref["fold_nfold"] and cfg.nfold < 50
    assert not fused_route(cfg, "cuda")
    got = fold_pipeline(key(11, device="cpu"), 15.99, nn, prof, cfg,
                        device="cpu")
    _close(got, ref["fold_pipe"])


@pytest.mark.parametrize("hatch", [False, True])
def test_ensemble_matches_reference(ref, monkeypatch, nf20, hatch):
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.simulate.pipeline import fused_route

    tag = "hatch" if hatch else "nf20"
    if hatch:
        monkeypatch.setenv("PSS_EXACT_CHI2", "1")
        ens = FoldEnsemble(*_fold_geometry("psrsigsim_torch", True),
                           device="cpu")
        assert ens.cfg.nfold > 50
    else:
        ens = nf20
    assert not fused_route(ens.cfg, "cuda")
    _close(ens.run(N_OBS, seed=SEED), ref[f"ens_{tag}_block"])
    d, s, o = ens.run_quantized(N_OBS, seed=SEED)
    _codes_close(d.numpy(), ref[f"ens_{tag}_data"])
    np.testing.assert_allclose(s.numpy(), ref[f"ens_{tag}_scl"], rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), ref[f"ens_{tag}_offs"], rtol=1e-5)
    # iter_chunks at two chunk sizes: the same codes, bit for bit
    for chunk in (1, 3):
        chunks = list(ens.iter_chunks(N_OBS, chunk_size=chunk, seed=SEED,
                                      quantized=True, byte_order="little"))
        got = np.concatenate([c[1][0] for c in chunks])
        np.testing.assert_array_equal(got, d.numpy())


def test_export_at_nfold_20_matches_reference(ref, nf20, tmp_path):
    """iter_chunks -> PSRFITS at Nfold 20, against the reference's export
    of the same seed: the files' bytes outside the payload equal, the codes
    within the ensemble bound (tests/test_torch_export.py)."""
    from test_torch_export import _fits_names, _payload_flips

    from psrsigsim_torch.io import export_ensemble_psrfits

    out = str(tmp_path / "export")
    export_ensemble_psrfits(nf20, N_OBS, out, _export_template(),
                            nf20.pulsar, seed=SEED, chunk_size=2, writers=1,
                            pipeline_depth=0)
    names = _fits_names(out)
    assert names == _fits_names(ref["export_dir"]) and len(names) == N_OBS
    flips = total = 0
    for n in names:
        f, t = _payload_flips(os.path.join(out, n),
                              os.path.join(ref["export_dir"], n))
        flips += f
        total += t
    assert flips <= 1e-2 * total


def test_hw_route_declines_the_fused_kernel_for_small_df(monkeypatch, nf20):
    """With the card's sampler selected the configuration still takes the
    unfused body (whose fields are the exact gamma draws), and the fused
    entry point refuses it instead of drawing another distribution."""
    from psrsigsim_torch.simulate.pipeline import (fold_pipeline_quantized,
                                                   fused_route)

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    assert not fused_route(nf20.cfg, "cuda")
    with pytest.raises(ValueError, match="exact gamma"):
        fold_pipeline_quantized(torch.zeros((1, 2), dtype=torch.int64),
                                torch.zeros(1), torch.ones(1),
                                nf20._profiles, nf20.cfg, device="cpu")


# -- (d) the object-oriented flow ---------------------------------------------


@pytest.fixture(scope="module")
def oo():
    return _oo_flows("psrsigsim_torch")


@pytest.mark.parametrize("name", ["fold_pulses", "fold_noise", "fold_null",
                                  "search_hatch_pulses"])
def test_object_oriented_draws_match_reference(ref, oo, name):
    if name == "fold_pulses":
        assert oo["fold_nfold"] == ref["oo_fold_nfold"] < 50
    got, want = oo[name], ref[f"oo_{name}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    normal = np.abs(want) >= TINY
    np.testing.assert_array_equal(got[normal].view(np.int32),
                                  want[normal].view(np.int32))
    assert (np.abs(got - want)[~normal].max(initial=0)
            <= 1e-30 * np.abs(want).max())


# -- (e) SEARCH under the hatch, (f) the multi-pulsar ensemble -------------------


def test_single_pipeline_under_the_hatch_matches_reference(ref, monkeypatch):
    from psrsigsim_torch.simulate import build_single_config, single_pipeline
    from psrsigsim_torch.utils import as_key

    monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    cfg, prof, nn = build_single_config(*_search_objects("psrsigsim_torch"),
                                        null_frac=0.2)
    got = single_pipeline(as_key(ref["search_keys"], device="cpu"),
                          torch.tensor([12.0, 30.0]),
                          torch.tensor([nn, 1.3 * nn], dtype=torch.float32),
                          prof, cfg, device="cpu")
    _close(got, ref["search_block"])


def test_multipulsar_under_the_hatch_matches_reference(ref, monkeypatch):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    work = _multi_workloads("psrsigsim_torch")
    assert min(w[0].nfold for w in work) < 50
    got = MultiPulsarFoldEnsemble(work, device="cpu").run(epochs=2, seed=0)
    for i, a in enumerate(got):
        _close(a, ref[f"multi_{i}"])


# -- (g) the Monte-Carlo study, the service, the dataset factory -----------------


def test_mc_study_at_nfold_20_matches_reference(ref):
    from test_torch_mc import _rows_close

    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.simulate import Simulation

    sim, priors = _sim_config()
    study = MonteCarloStudy.from_simulation(
        Simulation(psrdict=sim, device="cpu"), priors, seed=SEED)
    assert study.cfg.nfold < 50
    got = study.run(N_MC, chunk_size=3).metrics
    names = list(study.metric_names)
    assert names == ref["mc_names"]
    np.testing.assert_array_equal(got[:, 0], ref["mc_metrics"][:, 0])
    _rows_close(got, ref["mc_metrics"], names)


def test_served_request_at_nfold_20_matches_reference(ref):
    from psrsigsim_torch.serve import SimulationService

    svc = SimulationService(cache_dir=None, widths=(1,), device="cpu")
    try:
        rid, _ = svc.submit(SERVE_SPEC)
        got = svc.result(rid, timeout=300)
    finally:
        svc.close()
    want = ref["served"]
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want)


def test_dataset_chunk_under_the_hatch_matches_reference(ref, monkeypatch,
                                                         tmp_path):
    from psrsigsim_torch.datasets import DatasetFactory, DatasetReader

    monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    out = str(tmp_path / "corpus")
    DatasetFactory(DATASET_SPEC, device="cpu").run(out, chunk_size=3)
    reader = DatasetReader(out)
    for i in range(DATASET_SPEC["n_records"]):
        got = reader.read_index(i)
        gb = reader.record_bytes(i)
        wb = ref[f"record_{i}"].tobytes()
        # prefix, index and labels byte for byte; the tile within the FFT
        # tolerance
        tile_bytes = got["tile"].nbytes
        assert gb[:len(gb) - tile_bytes] == wb[:len(wb) - tile_bytes]
        _close(got["tile"], ref[f"tile_{i}"])


if __name__ == "__main__":
    _child(sys.argv[1])
