"""The port's multi-pulsar fold ensemble (``MultiPulsarFoldEnsemble``,
``fold_pipeline_hetero``) against the JAX package, and against itself, on
the CPU.

Population: the JAX package's own test population
(tests/test_multipulsar.py): five pulsars of 8 channels at 0.2048 MHz,
2 x 0.5 s subints, periods 5 and 10 ms (1024 and 2048 bins, two buckets),
distinct widths, DMs and fluxes.  The reference's ensemble runs on a
one-device mesh (its results are mesh-invariant by its own tests).
Tolerances and why:

* the keys, ``choose_nbin``, the bucketing and the staged configurations:
  the same host arithmetic, equal;
* the χ² fields (threefry, a per-observation df, Wilson–Hilferty or
  ``z²`` selected per row): bit-exact (P2, P3);
* the blocks: within rtol 1e-5 plus 1e-5 of the peak — the envelope
  shift's FFTs and its double-float ramp round apart by ulps (the fold
  pipeline's gate, tests/test_torch_pipeline.py).

Against itself: a run split over ``epoch_start``, any ``epoch_chunk`` and
any companions in a pulsar's bucket give the same bits, on both samplers.
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

# (period_s, dm, width, smean): tests/test_multipulsar.py's population
POP = [(0.005, 10.0, 0.03, 0.4), (0.005, 25.0, 0.06, 0.8),
       (0.010, 40.0, 0.04, 0.6), (0.005, 55.0, 0.08, 1.2),
       (0.010, 70.0, 0.05, 0.2)]
EPOCHS = 4
NBIN_CASES = [(1000, "pow2"), (1024, "pow2"), (1, "pow2"), (3000, 2048),
              (1000, [1024, 2048, 4096]), (3000, [4096, 1024, 2048]),
              (5000, [1024, 2048, 4096])]
# Simulation parameters of from_simulations(pad_nbin=[1024, 2048]):
# natural resolutions 819, 1228 and 1843 bins
SIM_PERIODS = [0.004, 0.006, 0.009]
SIM = {"fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 0.2048,
       "Nchan": 8, "fold": True, "sublen": 0.5, "tobs": 1.0, "Smean": 0.5,
       "profiles": [0.5, 0.05, 1.0], "name": "P", "dm": 30.0,
       "tscope_name": "demo", "aperture": 20.0, "area": 5500.0,
       "Tsys": 35.0, "system_name": "sys", "rcvr_fcent": 1400.0,
       "rcvr_bw": 400.0, "rcvr_name": "R", "backend_samprate": 0.2048,
       "backend_name": "B", "seed": 3}


def _workload(pkg, period_s, dm, width=0.05, smean=0.5, sublen=0.5):
    """One pulsar's fold workload from either package (the JAX test's
    ``_workload``)."""
    import importlib

    tpu = pkg == "psrsigsim_tpu"
    S = importlib.import_module(pkg + ".signal")
    P = importlib.import_module(pkg + (".pulsar" if tpu else ".models.pulsar"))
    T = importlib.import_module(pkg + (".telescope" if tpu
                                       else ".models.telescope"))
    U = importlib.import_module(pkg + ".utils")
    build = importlib.import_module(pkg + ".simulate").build_fold_config
    sig = S.FilterBankSignal(1400, 400, Nsubband=8, sample_rate=0.2048,
                             sublen=sublen, fold=True)
    psr = P.Pulsar(period_s, smean, P.GaussProfile(width=width), name="T")
    sig._tobs = U.make_quant(1.0, "s")
    t = T.Telescope(20.0, area=5500.0, Tsys=35.0, name="S")
    t.add_system("sys", T.Receiver(fcent=1400, bandwidth=400, name="R"),
                 T.Backend(samprate=0.2048, name="B"))
    cfg, profiles, noise_norm = build(sig, psr, t, "sys")
    return (cfg, profiles, noise_norm, dm)


def _population(pkg):
    return [_workload(pkg, p, d, width=w, smean=s) for p, d, w, s in POP]


def _sims(pkg, device=None):
    import importlib

    Simulation = importlib.import_module(pkg + ".simulate").Simulation
    kw = {} if device is None else {"device": device}
    return [Simulation(psrdict=dict(SIM, period=p, dm=20.0 + 10 * i), **kw)
            for i, p in enumerate(SIM_PERIODS)]


def _hetero_inputs(workloads, members=(0, 1)):
    """Per-observation inputs of two pulsars of one bucket."""
    w = [workloads[i] for i in members]
    return dict(
        dm=np.asarray([d for _, _, _, d in w], np.float32),
        norm=np.asarray([n for _, _, n, _ in w], np.float32),
        nfold=np.asarray([c.nfold for c, _, _, _ in w], np.float32),
        draw_norm=np.asarray([c.draw_norm for c, _, _, _ in w], np.float32),
        dt=np.asarray([c.dt_ms for c, _, _, _ in w], np.float32),
        prof=np.stack([np.asarray(p, np.float32) for _, p, _, _ in w]),
        freqs=np.stack([np.asarray(c.meta.dat_freq_mhz(), np.float32)
                        for c, _, _, _ in w]))


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops.stats import chan_chi2_field
    from psrsigsim_tpu.parallel import MultiPulsarFoldEnsemble, make_mesh
    from psrsigsim_tpu.simulate import fold_pipeline_hetero
    from psrsigsim_tpu.utils.rng import stage_key

    res, meta = {}, {}
    meta["nbin"] = [MultiPulsarFoldEnsemble.choose_nbin(n, p)
                    for n, p in NBIN_CASES]
    work = _population("psrsigsim_tpu")
    meta["cfgs"] = [dataclasses.asdict(c) for c, _, _, _ in work]
    meta["norms"] = [float(n) for _, _, n, _ in work]
    mesh = make_mesh((1, 1))
    ens = MultiPulsarFoldEnsemble(work, mesh=mesh)
    meta["n_buckets"] = ens.n_buckets
    for i, a in enumerate(ens.run(epochs=EPOCHS, seed=0)):
        res[f"run_{i}"] = np.asarray(a)

    # fold_pipeline_hetero: two pulsars of the 1024-bin bucket, their own
    # and the configuration's sample spacing; and its chi2 fields
    cfg = work[0][0]
    h = _hetero_inputs(work)
    keys = jax.vmap(lambda i: stage_key(jax.random.key(4), "user", i))(
        jnp.arange(2))
    res["keys"] = np.asarray(jax.random.key_data(keys))
    chan_ids = jnp.arange(8)
    for label, dts in (("dt", h["dt"]), ("static_dt", None)):
        res[f"hetero_{label}"] = np.asarray(jax.jit(jax.vmap(
            lambda k, d, n, f, dn, p, fr, dt: fold_pipeline_hetero(
                k, d, n, f, dn, p, cfg, freqs=fr, chan_ids=chan_ids,
                dt_ms=dt),
            in_axes=(0,) * 7 + (None if dts is None else 0,)))(
                keys, h["dm"], h["norm"], h["nfold"], h["draw_norm"],
                h["prof"], h["freqs"], dts))
    for stage in ("pulse", "noise"):
        res[f"field_{stage}"] = np.asarray(jax.jit(jax.vmap(
            lambda k, f, s=stage: chan_chi2_field(
                stage_key(k, s), chan_ids, f, 0, cfg.nsamp, aligned=True)))(
                    keys, jnp.asarray([h["nfold"][0], 1.0], jnp.float32)))

    sims = _sims("psrsigsim_tpu")
    ens = MultiPulsarFoldEnsemble.from_simulations(sims, mesh=mesh,
                                                   pad_nbin=[1024, 2048])
    meta["sim_cfgs"] = [dataclasses.asdict(w[0]) for w in ens.workloads]
    meta["sim_dms"] = [float(w[3]) for w in ens.workloads]
    meta["sim_buckets"] = ens.n_buckets
    for i, a in enumerate(ens.run(epochs=2, seed=1)):
        res[f"sim_{i}"] = np.asarray(a)

    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multipulsar")
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


@pytest.fixture(scope="module")
def population():
    return _population("psrsigsim_torch")


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _ensemble(workloads, **kw):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    return MultiPulsarFoldEnsemble(workloads, device="cpu", **kw)


def test_choose_nbin_matches_reference(ref):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    got = [MultiPulsarFoldEnsemble.choose_nbin(n, p) for n, p in NBIN_CASES]
    assert got == ref["nbin"] == [1024, 1024, 1, 2048, 1024, 4096, 4096]
    with pytest.raises(ValueError, match="pow2"):
        MultiPulsarFoldEnsemble.choose_nbin(100, "next")
    with pytest.raises(ValueError, match="empty"):
        MultiPulsarFoldEnsemble.choose_nbin(100, [])


def test_buckets_shapes_and_configs(ref, population):
    assert [dataclasses.asdict(c) for c, _, _, _ in population] == ref["cfgs"]
    assert [n for _, _, n, _ in population] == ref["norms"]
    ens = _ensemble(population)
    assert ens.n_buckets == ref["n_buckets"] == 2
    out = ens.run(3, seed=0)
    assert len(out) == 5
    assert out[0].shape == (3, 8, 2 * 1024)
    assert out[2].shape == (3, 8, 2 * 2048)
    assert all(bool(torch.isfinite(a).all()) for a in out)


def test_run_matches_reference(ref, population):
    out = _ensemble(population).run(EPOCHS, seed=0)
    for i, a in enumerate(out):
        _close(a, ref[f"run_{i}"])


def _keys(ref):
    from psrsigsim_torch.utils import as_key

    return as_key(ref["keys"], "cpu")


def test_hetero_fields_are_exact(ref, population):
    """Both χ² fields of a heterogeneous observation take the
    per-observation df (here one Nfold and one df = 1): bit-exact."""
    from psrsigsim_torch.simulate.pipeline import _chan_chi2
    from psrsigsim_torch.utils import stage_key

    cfg = population[0][0]
    dfs = torch.tensor([cfg.nfold, 1.0], dtype=torch.float32)
    for stage in ("pulse", "noise"):
        got = _chan_chi2(stage_key(_keys(ref), stage), torch.arange(8), dfs,
                         cfg.nsamp)
        assert got.numpy().tobytes() == ref[f"field_{stage}"].tobytes()


@pytest.mark.parametrize("label", ["dt", "static_dt"])
def test_fold_pipeline_hetero_matches_reference(ref, population, label):
    from psrsigsim_torch.simulate import fold_pipeline_hetero

    h = _hetero_inputs(population)
    t = {k: torch.from_numpy(v) for k, v in h.items()}
    got = fold_pipeline_hetero(
        _keys(ref), t["dm"], t["norm"], t["nfold"], t["draw_norm"], t["prof"],
        population[0][0], freqs=t["freqs"],
        dt_ms=t["dt"] if label == "dt" else None, device="cpu")
    _close(got, ref[f"hetero_{label}"])


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
def test_epoch_splits_and_chunks_change_no_draw(monkeypatch, population,
                                               sampler):
    """``run(4)`` equals ``run(2)`` + ``run(2, epoch_start=2)`` and
    ``epoch_chunk=1`` bit for bit (on ``hw`` the sampler's plain
    version)."""
    monkeypatch.setenv("PSS_SAMPLER", sampler)
    whole = _ensemble(population).run(EPOCHS, seed=3)
    ens = _ensemble(population)
    first, second = ens.run(2, seed=3), ens.run(2, seed=3, epoch_start=2)
    chunked = _ensemble(population, epoch_chunk=1).run(EPOCHS, seed=3)
    for i in range(len(population)):
        assert torch.equal(torch.cat([first[i], second[i]]), whole[i])
        assert torch.equal(chunked[i], whole[i])


def _pulsar_epoch_inputs(population, epochs=3):
    """Two pulsars of one bucket as the ensemble stages them: keys ``(P,
    E)``, per-pulsar columns ``(P, 1)``, portraits ``(P, 1, C, Nph)`` and
    frequencies ``(P, 1, C)``."""
    from psrsigsim_torch.utils import fold_in, key, stage_key

    h = {k: torch.from_numpy(v) for k, v in
         _hetero_inputs(population).items()}
    keys = fold_in(stage_key(key(4, "cpu"), "user",
                             torch.arange(2))[:, None, :],
                   torch.arange(epochs)[None, :])
    cols = {k: h[k][:, None] for k in ("dm", "norm", "nfold", "draw_norm",
                                       "dt")}
    return keys, cols, h["prof"][:, None], h["freqs"][:, None]


def test_fold_front_shifts_each_pulsar_once(population):
    """``_fold_front`` keeps DM's, dt's and the portrait's own shape: ``(P,
    1)`` columns give a ``(P, 1, C, Nph)`` shifted portrait against ``(P,
    E)`` keys, and one delay row per pulsar (per observation on demand)."""
    from psrsigsim_torch.simulate.pipeline import _fold_front

    keys, c, prof, freqs = _pulsar_epoch_inputs(population)
    cfg = population[0][0]
    f = _fold_front(keys, c["dm"], c["norm"], prof, cfg, freqs, None, None,
                    "cpu", dt_ms=c["dt"])
    P, E, C = 2, keys.shape[1], cfg.meta.nchan
    assert f.lead == (P, E)
    assert f.prof.shape == (P, 1, C, cfg.nph)
    assert f.delays_ms.shape == (P, 1, C)
    assert f.dt.shape == (P, 1, 1, 1)
    assert f.obs_delays_ms().shape == (P, E, C)
    assert f.noise_norm.shape == (P, E)
    with pytest.raises(ValueError, match="broadcast"):
        _fold_front(keys, torch.zeros(P, E + 1), c["norm"], prof, cfg, freqs,
                    None, None, "cpu", dt_ms=c["dt"])


def test_hetero_per_pulsar_columns_equal_per_epoch_ones(population):
    """``_fold_pipeline_hetero`` with ``(P, 1)`` DMs and sample spacings
    equals, bit for bit, the same call with both expanded to the keys'
    ``(P, E)``: a row's shift does not depend on how many rows share it."""
    from psrsigsim_torch.simulate.pipeline import _fold_pipeline_hetero

    keys, c, prof, freqs = _pulsar_epoch_inputs(population)
    cfg = population[0][0]
    lead = keys.shape[:-1]

    def run(dm, dt):
        return _fold_pipeline_hetero(keys, dm, c["norm"], c["nfold"],
                                     c["draw_norm"], prof, cfg, freqs, None,
                                     None, dt, "cpu")

    shared = run(c["dm"], c["dt"])
    expanded = run(c["dm"].expand(lead).contiguous(),
                   c["dt"].expand(lead).contiguous())
    assert shared.shape == lead + (cfg.meta.nchan, cfg.nsamp)
    assert torch.equal(shared, expanded)


def _count_shifts(monkeypatch):
    """Rows the tensor branch of ``fourier_shift`` shifts, wherever it is
    called from."""
    from psrsigsim_torch.ops import shift

    rows = []
    inner = shift.envelope_shift

    def counted(spec, shifts, dt, n):
        out = inner(spec, shifts, dt, n)
        rows.append(out.numel() // (n // 2 + 1))
        return out

    monkeypatch.setattr(shift, "envelope_shift", counted)
    return rows


def test_staged_buckets_shift_each_portrait_once(monkeypatch, population):
    """The ensemble shifts each bucket's portraits when it stages the
    bucket, one row a pulsar and channel; later runs shift nothing."""
    rows = _count_shifts(monkeypatch)
    ens = _ensemble(population, epoch_chunk=1)
    ens.run(2, seed=0)
    nchan = population[0][0].meta.nchan
    assert sorted(rows) == sorted(len(m) * nchan
                                  for m in ens._buckets.values())
    rows.clear()
    ens.run(3, seed=1, epoch_start=2)
    assert rows == []


def test_staged_portraits_equal_the_fronts_shift(population):
    """A bucket's blocks from the staged, shifted portraits equal, bit for
    bit, ``_fold_pipeline_hetero`` shifting the raw portraits itself."""
    from psrsigsim_torch.simulate.pipeline import _fold_pipeline_hetero
    from psrsigsim_torch.utils import fold_in, key, stage_key

    ens = _ensemble(population)
    out = ens.run(2, seed=6, epoch_start=3)
    for members in ens._buckets.values():
        w = [population[i] for i in members]
        cfg = w[0][0]
        keys = fold_in(stage_key(key(6, "cpu"), "user",
                                 torch.as_tensor(members))[:, None, :],
                       torch.arange(3, 5)[None, :])

        def col(v):
            """Per-pulsar values ``(P, 1, ...)``, as the ensemble stages
            them."""
            return torch.as_tensor(np.asarray(v, np.float32))[:, None]

        want = _fold_pipeline_hetero(
            keys, col([d for *_, d in w]), col([n for _, _, n, _ in w]),
            col([c.nfold for c, *_ in w]), col([c.draw_norm for c, *_ in w]),
            col(np.stack([p for _, p, _, _ in w])), cfg,
            col(np.stack([c.meta.dat_freq_mhz() for c, *_ in w])),
            None, None, col([c.dt_ms for c, *_ in w]), "cpu")
        for slot, i in enumerate(members):
            assert torch.equal(out[i], want[slot])


def test_rows_do_not_depend_on_bucket_companions(population):
    """Pulsar 0 keeps its global index; its bucket's other members change
    (pulsars 1 and 3 swapped for 2048-bin ones): its rows are the same
    bits."""
    whole = _ensemble(population).run(2, seed=5)
    other = [population[0], population[2], population[2], population[4],
             population[4]]
    alone = _ensemble(other).run(2, seed=5)
    assert torch.equal(alone[0], whole[0])
    assert torch.equal(alone[4], whole[4])


def test_small_nfold_is_refused(population):
    from psrsigsim_torch.simulate import fold_pipeline_hetero
    from psrsigsim_torch.utils import key, stage_key

    short = _workload("psrsigsim_torch", 0.005, 10.0, sublen=0.1)
    assert short[0].nfold < 50
    with pytest.raises(ValueError, match="Nfold"):
        _ensemble([population[0], short]).run(1)
    cfg, prof, nn, _ = short
    keys = stage_key(key(0, "cpu"), "user", torch.arange(1))
    with pytest.raises(ValueError, match="Nfold"):
        fold_pipeline_hetero(keys, 10.0, nn, cfg.nfold, cfg.draw_norm, prof,
                             cfg, device="cpu")


def test_from_simulations_matches_reference(ref):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    ens = MultiPulsarFoldEnsemble.from_simulations(
        _sims("psrsigsim_torch", "cpu"), pad_nbin=[1024, 2048])
    assert ens.device.type == "cpu"
    assert [dataclasses.asdict(w[0]) for w in ens.workloads] == \
        ref["sim_cfgs"]
    assert [w[3] for w in ens.workloads] == ref["sim_dms"]
    assert ens.n_buckets == ref["sim_buckets"] == 2
    assert [w[0].nph for w in ens.workloads] == [1024, 2048, 2048]
    for i, a in enumerate(ens.run(2, seed=1)):
        _close(a, ref[f"sim_{i}"])


def test_mesh_and_missing_card_raise(monkeypatch, population):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    from psrsigsim_torch.parallel import make_mesh

    # mesh= takes a Mesh (tests/test_torch_mesh.py holds the blocks across
    # mesh shapes)
    with pytest.raises(TypeError, match="Mesh"):
        MultiPulsarFoldEnsemble(population, mesh=object(), device="cpu")
    ens = MultiPulsarFoldEnsemble(population,
                                  mesh=make_mesh((2, 1), ["cpu"] * 2))
    assert len(ens.run(1)) == len(population)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiPulsarFoldEnsemble(population)


@pytest.mark.cuda
def test_multipulsar_on_the_card_matches_the_host(population):
    """On the card: two sampler launches per bucket and epoch chunk
    (``chi2_sel`` rows), blocks within the fold bound of the host's
    (``PSS_SAMPLER=hw``)."""
    from psrsigsim_torch.ops import rng_hw
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng_hw.rng_field.launches = 0
    card = MultiPulsarFoldEnsemble(population, epoch_chunk=1,
                                   device="cuda").run(2, seed=0)
    assert rng_hw.rng_field.launches == 2 * 2 * 2
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        host = _ensemble(population).run(2, seed=0)
    finally:
        os.environ.pop("PSS_SAMPLER")
    for a, b in zip(card, host):
        _close(a.cpu(), b.numpy())


if __name__ == "__main__":
    _child(sys.argv[1])
