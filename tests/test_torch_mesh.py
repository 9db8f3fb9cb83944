"""The port's single-process meshes (``parallel/mesh.py``,
``parallel/_collectives.py``) and ``mesh=`` through every entry point that
takes one — ``FoldEnsemble``, ``MultiPulsarFoldEnsemble``,
``MonteCarloStudy``, ``RecordSampler``/``DatasetFactory``, the
``Simulation`` façade and the exports — on the CPU.

A mesh position is a device, and a device may repeat, so the tests hold
any shard count on the host.  What is held:

* the guards: a shape that does not tile the devices, a non-``Mesh``
  argument (``TypeError``), a ``device=`` that is not the mesh's first,
  ``Nchan`` not dividing over the chan axis, the study's chan axis above
  1, and on the sampler kernel's path (``PSS_SAMPLER=hw``, its plain
  version here) a chan shard that starts inside an 8-channel group;
* the collectives against their ``lax`` definitions (numpy);
* invariance: every mesh shape gives the mesh-free run's bytes — the fold
  ensemble's codes, scales, offsets, finite and RFI masks and float
  blocks, ``iter_chunks`` and ``run_quantized_at`` (padded to the obs
  shards and trimmed), the multi-pulsar ensemble's blocks, the study's
  metric rows and histograms, the dataset corpus, the PSRFITS files of a
  bare and a supervised export (``integrity=`` kept) — on the threefry
  stream and on the kernel's stream.  Draws are keyed by global
  observation and channel and every stage is per observation and per
  channel, so nothing needs a tolerance;
* against the JAX package on its own meshes of virtual devices — (2, 1),
  (1, 2) and (2, 2), and (2, 1), (4, 1) for the study — on the threefry
  stream: the fold ensemble's ``run``, ``run_quantized``,
  ``run_quantized_at`` and ``iter_chunks`` (their chunk starts, which
  show the rounding to the obs shards, equal), the multi-pulsar blocks,
  the study's rows and a dataset corpus (its summary, manifest and shard
  indexes equal), at the tolerances of the mesh-free parity tests: float
  blocks within rtol 1e-5 (tests/test_torch_pipeline.py; with a floor of
  1e-5 of the peak for the multi-pulsar blocks and the SEARCH tiles,
  tests/test_torch_multipulsar.py and tests/test_torch_datasets.py), int16
  codes at most 1 LSB apart on at most 1% of codes with DAT_SCL/DAT_OFFS
  within rtol 1e-5, finite flags, sampled parameters and record labels
  bit for bit, study residuals within 2e-6 turns and sigma/amplitude
  within rtol 1e-4 (tests/test_torch_mc.py).  The two FFT libraries'
  ulps are the only difference.  Reference values come from a child
  process (this file run as a script) with 8 virtual XLA CPU devices and
  the JAX-version shims R1 and R2.

The ``cuda``-marked cases run the same on the card (``-m cuda``).
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

from test_torch_seqshard import child_env8  # noqa: E402
from test_torch_toa import shims  # noqa: E402

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 1)]
# held against the JAX package's own meshes (the study's chan axis is 1)
REF_SHAPES = [(2, 1), (1, 2), (2, 2)]
REF_STUDY_SHAPES = [(2, 1), (4, 1)]
N_REF, CHUNK_REF, SEED_REF = 5, 3, 3
AT_REF = [4, 1, 3]
N_TRIALS_REF, STUDY_CHUNK_REF = 7, 3
CORPUS_CHUNK_REF = 3


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_EPHEM"):
        monkeypatch.delenv(k, raising=False)


def mesh(shape, device="cpu"):
    from psrsigsim_torch.parallel import make_mesh

    return make_mesh(shape, [device] * (shape[0] * shape[1]))


def _objects(nchan=16):
    """A small fold geometry: ``nchan`` channels over 400 MHz at 1380
    MHz, 256 bins of a 5 ms pulsar, 4 x 0.5 s subints."""
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.utils import make_quant

    sig = FilterBankSignal(1380, 400, Nsubband=nchan, sample_rate=0.0512,
                           sublen=0.5, fold=True)
    psr = Pulsar(0.005, 0.05, GaussProfile(width=0.05), name="M", seed=0)
    sig._tobs = make_quant(2.0, "s")
    sig._dm = make_quant(12.0, "pc/cm^3")
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="S")
    tel.add_system("Sys", Receiver(fcent=1380, bandwidth=400, name="R"),
                   Backend(samprate=12.5, name="B"))
    return sig, psr, tel, "Sys"


def _ensemble(shape=None, device="cpu", **kw):
    from psrsigsim_torch.parallel import FoldEnsemble

    m = None if shape is None else mesh(shape, device)
    return FoldEnsemble(*_objects(), device=device, mesh=m, **kw)


# -- the mesh and its guards -----------------------------------------------------


def test_make_mesh_shapes_and_repeated_devices():
    from psrsigsim_torch.parallel import CHAN_AXIS, OBS_AXIS, Mesh, make_mesh

    m = make_mesh((2, 3), ["cpu"] * 6)
    assert isinstance(m, Mesh)
    assert m.axis_names == (OBS_AXIS, CHAN_AXIS)
    assert m.shape[OBS_AXIS] == 2 and m.shape[CHAN_AXIS] == 3
    assert m.devices.shape == (2, 3) and m.size == 6
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert make_mesh(devices=["cpu"] * 4).shape[OBS_AXIS] == 4
    assert m == make_mesh((2, 3), ["cpu"] * 6) and len({m, mesh((2, 3))}) == 1
    with pytest.raises(ValueError, match="does not tile"):
        make_mesh((2, 2), ["cpu"] * 3)


def test_default_devices_need_a_card(monkeypatch):
    from psrsigsim_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_sharding_helpers():
    from psrsigsim_torch.parallel import (batch_sharding, replicated_sharding,
                                          shard_batch)

    m = mesh((2, 2))
    assert batch_sharding(m).spec == ("obs", "chan", None)
    assert batch_sharding(m, batch_ndim=2).spec == ("obs", None, "chan", None)
    assert replicated_sharding(m).spec == ()
    parts = shard_batch(np.arange(6), m)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [0, 1, 2],
                                           [3, 4, 5], [3, 4, 5]]
    assert [int(p) for p in shard_batch(np.float32(2.5), m)] == [2] * 4
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(np.arange(5), m)


def test_distributed_init_single_process_only():
    """One process needs no setup; more join a pod through init_pod, which
    refuses a missing or impossible process id before it binds anything
    (the pod itself: tests/test_torch_pod.py)."""
    from psrsigsim_torch.parallel import distributed_init
    from psrsigsim_torch.runtime import dist

    assert distributed_init() is None
    assert distributed_init(num_processes=1) is None
    prev = dist._pod
    try:
        dist._pod = dist._SOLO
        with pytest.raises(ValueError, match="process id"):
            distributed_init("localhost:1234", num_processes=2)
        with pytest.raises(ValueError, match="outside a pod"):
            distributed_init("localhost:1234", num_processes=2,
                             process_id=2)
        assert not dist.is_pod() and dist.pod_channel() is None
    finally:
        dist._pod = prev


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (-1, -2)])
def test_all_to_all_is_laxs(split, concat):
    """Shard ``j`` receives block ``j`` of every shard's split axis,
    concatenated in shard order — ``lax.all_to_all(..., tiled=True)``."""
    from psrsigsim_torch.parallel._collectives import all_to_all

    n = 4
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((8, 12)).astype(np.float32)
             for _ in range(n)]
    got = all_to_all([torch.from_numpy(p) for p in parts], split, concat,
                     [torch.device("cpu")] * n)
    for j in range(n):
        want = np.concatenate([np.split(p, n, axis=split)[j] for p in parts],
                              axis=concat)
        assert np.array_equal(got[j].numpy(), want), j


def test_ppermute_ring_and_zeros():
    from psrsigsim_torch.parallel._collectives import gather_grid, ppermute

    devs = [torch.device("cpu")] * 3
    parts = [torch.full((2,), float(i)) for i in range(3)]
    fwd = ppermute(parts, [(i, (i + 1) % 3) for i in range(3)], devs)
    assert [float(p[0]) for p in fwd] == [2.0, 0.0, 1.0]
    partial = ppermute(parts, [(0, 1)], devs)
    assert [p.tolist() for p in partial] == [[0.0, 0.0], [0.0, 0.0],
                                             [0.0, 0.0]]
    grid = [[torch.full((1, 2), 10.0 * i + j) for j in range(3)]
            for i in range(2)]
    assert gather_grid(grid, (0, 1), devs[0]).tolist() == [
        [0, 0, 1, 1, 2, 2], [10, 10, 11, 11, 12, 12]]


def test_ensemble_mesh_guards(monkeypatch):
    from psrsigsim_torch.parallel import FoldEnsemble, make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        FoldEnsemble(*_objects(), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="conflicts"):
        FoldEnsemble(*_objects(), device="cuda", mesh=mesh((2, 1)))
    with pytest.raises(ValueError, match="divisible"):
        _ensemble((1, 3))
    ens = FoldEnsemble(*_objects(), mesh=mesh((2, 1)))
    assert ens.device == torch.device("cpu")
    from psrsigsim_torch.parallel import make_seq_mesh

    with pytest.raises(ValueError, match="axes"):
        FoldEnsemble(*_objects(), mesh=make_seq_mesh(devices=["cpu"]))
    assert make_mesh((1, 1), ["cpu"]).first_device == torch.device("cpu")


@pytest.mark.parametrize("shape", [(1, 4), (2, 8)])
def test_kernel_stream_refuses_chan_shards_inside_a_group(monkeypatch, shape):
    """On the sampler kernel's stream a chan shard of 4 or 2 channels
    would start inside an 8-channel group and draw another stream: it
    raises, naming the rule; the threefry stream keys each channel and
    takes the same mesh."""
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    with pytest.raises(ValueError, match="8-channel group"):
        _ensemble(shape)
    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    ens = _ensemble(shape)
    # the sampler is chosen per run: switching to the kernel later raises
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    with pytest.raises(ValueError, match="8-channel group"):
        ens.run(2)


# -- the fold ensemble ------------------------------------------------------------


@pytest.fixture(scope="module", params=["threefry", "hw"])
def baseline(request):
    """The mesh-free ensemble's outputs on each stream."""
    os.environ["PSS_SAMPLER"] = request.param
    try:
        ens = _ensemble()
        out = dict(q=ens.run_quantized(5, seed=3, return_finite=True),
                   f=ens.run(5, seed=3),
                   at=ens.run_quantized_at([4, 1, 3], seed=3,
                                           byte_order="big"),
                   chunks=list(ens.iter_chunks(5, chunk_size=2, seed=3,
                                               quantized=True,
                                               finite_mask=True)))
    finally:
        os.environ.pop("PSS_SAMPLER")
    return request.param, out


@pytest.mark.parametrize("shape", SHAPES)
def test_fold_ensemble_mesh_invariance(monkeypatch, baseline, shape):
    """``run_quantized`` (codes, DAT_SCL, DAT_OFFS, finite), ``run``,
    ``run_quantized_at`` and ``iter_chunks`` on every mesh shape: the
    mesh-free bytes (5 observations: padded to the obs shards, trimmed)."""
    sampler, want = baseline
    monkeypatch.setenv("PSS_SAMPLER", sampler)
    ens = _ensemble(shape)
    for got, exp in zip(ens.run_quantized(5, seed=3, return_finite=True),
                        want["q"]):
        assert torch.equal(got, exp)
    assert torch.equal(ens.run(5, seed=3), want["f"])
    for got, exp in zip(ens.run_quantized_at([4, 1, 3], seed=3,
                                             byte_order="big"), want["at"]):
        assert torch.equal(got, exp)
    chunks = list(ens.iter_chunks(5, chunk_size=2, seed=3, quantized=True,
                                  finite_mask=True))
    step = 2 + (-2) % shape[0]
    assert [s for s, _ in chunks] == list(range(0, 5, step))
    for k in range(4):
        got = np.concatenate([b[k] for _, b in chunks])
        exp = np.concatenate([b[k] for _, b in want["chunks"]])
        assert np.array_equal(got, exp), k


def test_scenario_ensemble_mesh_invariance():
    """A scenario's factors are drawn once for the batch and cut per
    position: the RFI truth mask and the codes equal the mesh-free run's."""
    stack = ["scintillation", "rfi", "single_pulse:frb"]
    params = {"rfi_imp_prob": 0.6, "scint_dnu_d_mhz": 40.0}
    want = _ensemble(scenario=stack).run_quantized(
        5, seed=2, return_rfi=True, scenario_params=params)
    got = _ensemble((2, 2), scenario=stack).run_quantized(
        5, seed=2, return_rfi=True, scenario_params=params)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the multi-pulsar ensemble, the study, the sampler -----------------------------


@pytest.mark.parametrize("sampler,shape", [("threefry", (2, 1)),
                                           ("threefry", (3, 2)),
                                           ("hw", (2, 1)), ("hw", (1, 1))])
def test_multipulsar_mesh_invariance(monkeypatch, sampler, shape):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
    from test_torch_multipulsar import _population

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    pop = _population("psrsigsim_torch")
    want = MultiPulsarFoldEnsemble(pop, device="cpu", epoch_chunk=2).run(3)
    ens = MultiPulsarFoldEnsemble(pop, mesh=mesh(shape), epoch_chunk=2)
    for a, b in zip(ens.run(3), want):
        assert torch.equal(a, b)


def test_multipulsar_mesh_guards(monkeypatch):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
    from test_torch_multipulsar import _population

    pop = _population("psrsigsim_torch")
    with pytest.raises(ValueError, match="divisible"):
        MultiPulsarFoldEnsemble(pop, mesh=mesh((1, 3)))
    with pytest.raises(TypeError, match="Mesh"):
        MultiPulsarFoldEnsemble(pop, mesh=object(), device="cpu")
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    with pytest.raises(ValueError, match="8-channel group"):
        MultiPulsarFoldEnsemble(pop, mesh=mesh((1, 2))).run(1)


def test_study_rows_bit_identical_across_obs_shards():
    from psrsigsim_torch.mc import MonteCarloStudy

    ens = _ensemble()
    priors = {"dm": {"dist": "uniform", "lo": 10.0, "hi": 20.0},
              "noise_scale": {"dist": "loguniform", "lo": 0.5, "hi": 2.0}}
    want = ens.to_mc_study(priors, seed=1).run(7, chunk_size=4)
    for shape in ((2, 1), (3, 1)):
        st = MonteCarloStudy(ens.cfg, ens._profiles_np, ens.noise_norm,
                             priors, seed=1, dm=ens.dm, mesh=mesh(shape))
        got = st.run(7, chunk_size=4)
        assert np.array_equal(got.metrics, want.metrics), shape
        assert np.array_equal(got.hist, want.hist), shape
    # the ensemble's bridge forwards its mesh
    assert _ensemble((2, 1)).to_mc_study(priors).mesh == mesh((2, 1))
    with pytest.raises(ValueError, match="chan axis 1"):
        MonteCarloStudy(ens.cfg, ens._profiles_np, ens.noise_norm, priors,
                        mesh=mesh((1, 2)))
    with pytest.raises(ValueError, match="divisible"):
        MonteCarloStudy(ens.cfg, ens._profiles_np, ens.noise_norm, priors,
                        mesh=mesh((1, 3)))


def _corpus(out_dir):
    from test_torch_datasets import _corpus as corpus

    return corpus(out_dir)


@pytest.mark.parametrize("sampler", ["threefry", "hw"])
def test_dataset_corpus_byte_identical_across_meshes(monkeypatch, tmp_path,
                                                     sampler):
    from psrsigsim_torch.datasets import DatasetFactory
    from test_torch_datasets import SMALL

    monkeypatch.setenv("PSS_SAMPLER", sampler)
    DatasetFactory(SMALL, device="cpu").run(str(tmp_path / "a"), chunk_size=5)
    want = _corpus(str(tmp_path / "a"))
    for shape in ((2, 1), (1, 2), (2, 2)):
        out = str(tmp_path / f"m{shape[0]}{shape[1]}")
        DatasetFactory(SMALL, mesh=mesh(shape)).run(out, chunk_size=5)
        assert _corpus(out) == want, shape
    fac = DatasetFactory(SMALL, mesh=mesh((2, 1)))
    assert fac.sampler.chunk_width(5) == 6
    one = fac.sampler.record_host(7)
    assert one["tile"].shape == (2, fac.sampler.cfg.nsamp)


# -- the exports and the façade ---------------------------------------------------


def _fits(out):
    names = sorted(n for n in os.listdir(out) if n.endswith(".fits"))
    out_bytes = {}
    for n in names:
        with open(os.path.join(out, n), "rb") as fh:
            out_bytes[n] = fh.read()
    return out_bytes


def test_meshed_exports_are_byte_identical(tmp_path):
    """A bare and a supervised export (with ``integrity=`` and a full
    audit) of an ensemble on a (2, 2) mesh write the mesh-free files;
    chunks pad to the obs shards."""
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.runtime import supervised_export
    from test_torch_export import SEED, TEMPLATE, _ref_ensemble

    base = _ref_ensemble("psrsigsim_torch", device="cpu")
    sig, psr, tel, system = __import__(
        "test_torch_export")._geometry("psrsigsim_torch")
    from psrsigsim_torch.parallel import FoldEnsemble

    meshed = FoldEnsemble(sig, psr, tel, system, mesh=mesh((2, 2)))
    kw = dict(seed=SEED, chunk_size=3, writers=1)
    export_ensemble_psrfits(base, 5, str(tmp_path / "a"), TEMPLATE,
                            base.pulsar, **kw)
    export_ensemble_psrfits(meshed, 5, str(tmp_path / "b"), TEMPLATE,
                            meshed.pulsar, **kw)
    want = _fits(str(tmp_path / "a"))
    assert len(want) == 5 and _fits(str(tmp_path / "b")) == want
    res = supervised_export(meshed, 5, str(tmp_path / "c"), TEMPLATE,
                            meshed.pulsar, integrity=1.0, **kw)
    assert _fits(str(tmp_path / "c")) == want
    assert res is not None


def test_simulation_forwards_the_mesh(tmp_path):
    from psrsigsim_torch.simulate import Simulation
    from test_torch_mc import SIM_CONFIG

    sim = Simulation(psrdict=dict(SIM_CONFIG), device="cpu")
    want = sim.to_ensemble().run_quantized(3, seed=1)
    ens = sim.to_ensemble(mesh=mesh((2, 2)))
    assert ens.mesh == mesh((2, 2))
    for a, b in zip(ens.run_quantized(3, seed=1), want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Mesh"):
        sim.to_ensemble(mesh=object())
    r0 = sim.run_mc_study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 9.0}},
                          5, seed=2, chunk_size=2)
    r1 = sim.run_mc_study({"dm": {"dist": "uniform", "lo": 5.0, "hi": 9.0}},
                          5, seed=2, chunk_size=2, mesh=mesh((2, 1)))
    assert np.array_equal(r0.metrics, r1.metrics)


# -- against the JAX package -------------------------------------------------------


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _child(out):
    """The reference's meshed entry points on meshes of virtual devices."""
    shims()
    import jax

    from psrsigsim_tpu.datasets import DatasetFactory
    from psrsigsim_tpu.mc import MonteCarloStudy
    from psrsigsim_tpu.parallel import (FoldEnsemble, MultiPulsarFoldEnsemble,
                                        make_mesh)
    from psrsigsim_tpu.simulate import Simulation
    from test_torch_datasets import PARITY
    from test_torch_mc import DM_NS, SIM_CONFIG
    from test_torch_multipulsar import _population
    from test_torch_pipeline import _geometry

    devs = jax.devices()
    assert len(devs) == 8
    res, meta = {}, {"summary": {}}

    def on(shape):
        return make_mesh(shape, devs[:shape[0] * shape[1]])

    for shape in REF_SHAPES:
        tag = _tag(shape)
        ens = FoldEnsemble(*_geometry("psrsigsim_tpu", "readme16"),
                           mesh=on(shape))
        for k, a in enumerate(ens.run_quantized(N_REF, seed=SEED_REF,
                                                return_finite=True)):
            res[f"{tag}_q{k}"] = np.asarray(a)
        res[f"{tag}_f"] = np.asarray(ens.run(N_REF, seed=SEED_REF))
        for k, a in enumerate(ens.run_quantized_at(AT_REF, seed=SEED_REF)):
            res[f"{tag}_at{k}"] = np.asarray(a)
        chunks = list(ens.iter_chunks(N_REF, chunk_size=CHUNK_REF,
                                      seed=SEED_REF, quantized=True,
                                      finite_mask=True))
        res[f"{tag}_starts"] = np.asarray([s for s, _ in chunks])
        for k in range(4):
            res[f"{tag}_c{k}"] = np.concatenate(
                [np.asarray(b[k]) for _, b in chunks])
        mp = MultiPulsarFoldEnsemble(_population("psrsigsim_tpu"),
                                     mesh=on(shape), epoch_chunk=2).run(3)
        for p, a in enumerate(mp):
            res[f"{tag}_mp{p}"] = np.asarray(a)
        meta["summary"][tag] = {k: v for k, v in DatasetFactory(
            PARITY, mesh=on(shape)).run(
                os.path.join(out, f"corpus_{tag}"),
                chunk_size=CORPUS_CHUNK_REF).items() if k != "telemetry"}
    for shape in REF_STUDY_SHAPES:
        study = MonteCarloStudy.from_simulation(
            Simulation(psrdict=dict(SIM_CONFIG)), DM_NS, seed=SEED_REF,
            mesh=on(shape))
        r = study.run(N_TRIALS_REF, chunk_size=STUDY_CHUNK_REF)
        res[f"study{_tag(shape)}_metrics"] = np.asarray(r.metrics)
        res[f"study{_tag(shape)}_hist"] = np.asarray(r.hist)
        meta["metric_names"] = list(study.metric_names)
    np.savez(os.path.join(out, "ref.npz"), **res)
    with open(os.path.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mesh")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env8(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        res = dict(z)
    with open(out / "meta.json") as fh:
        res.update(json.load(fh))
    res["dir"] = str(out)
    return res


def _packed_close(got, want):
    """A quantized triple (+ finite flags) at the mesh-free parity
    tolerance (tests/test_torch_pipeline.py)."""
    from test_torch_pipeline import _codes_close

    got = [g.numpy() if isinstance(g, torch.Tensor) else g for g in got]
    assert [g.shape for g in got] == [w.shape for w in want]
    _codes_close(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    if len(got) > 3:
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_fold_ensemble_mesh_matches_reference(ref, shape):
    """The same obs padding, chan slabs (global channel ids) and chunk
    rounding as the reference on its mesh of the same shape."""
    from psrsigsim_torch.parallel import FoldEnsemble
    from test_torch_pipeline import _geometry

    tag = _tag(shape)
    ens = FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                       mesh=mesh(shape))
    _packed_close(ens.run_quantized(N_REF, seed=SEED_REF, return_finite=True),
                  [ref[f"{tag}_q{k}"] for k in range(4)])
    np.testing.assert_allclose(ens.run(N_REF, seed=SEED_REF).numpy(),
                               ref[f"{tag}_f"], rtol=1e-5)
    _packed_close(ens.run_quantized_at(AT_REF, seed=SEED_REF),
                  [ref[f"{tag}_at{k}"] for k in range(4)])
    chunks = list(ens.iter_chunks(N_REF, chunk_size=CHUNK_REF, seed=SEED_REF,
                                  quantized=True, finite_mask=True))
    np.testing.assert_array_equal([s for s, _ in chunks], ref[f"{tag}_starts"])
    _packed_close([np.concatenate([b[k] for _, b in chunks])
                   for k in range(4)],
                  [ref[f"{tag}_c{k}"] for k in range(4)])


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_multipulsar_mesh_matches_reference(ref, shape):
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
    from test_torch_multipulsar import _close, _population

    got = MultiPulsarFoldEnsemble(_population("psrsigsim_torch"),
                                  mesh=mesh(shape), epoch_chunk=2).run(3)
    assert len(got) == sum(k.startswith(f"{_tag(shape)}_mp") for k in ref)
    for p, a in enumerate(got):
        _close(a, ref[f"{_tag(shape)}_mp{p}"])


@pytest.mark.parametrize("shape", REF_STUDY_SHAPES)
def test_study_mesh_matches_reference(ref, shape):
    """Rows and histograms of a study whose chunks pad to the obs shards
    as the reference's do."""
    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.simulate import Simulation
    from test_torch_mc import DM_NS, SIM_CONFIG, _rows_close

    study = MonteCarloStudy.from_simulation(
        Simulation(psrdict=dict(SIM_CONFIG), device="cpu"), DM_NS,
        seed=SEED_REF, mesh=mesh(shape))
    res = study.run(N_TRIALS_REF, chunk_size=STUDY_CHUNK_REF)
    names = list(study.metric_names)
    assert names == ref["metric_names"]
    got, want = res.metrics, ref[f"study{_tag(shape)}_metrics"]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    tol = _rows_close(got, want, names)
    # a count moves bin only for a trial within the tolerance of an edge
    whist = ref[f"study{_tag(shape)}_hist"]
    flips = 0
    for j, name in enumerate(names):
        lo, hi = res.hist_ranges[name]
        nb = res.hist.shape[1]
        edges = np.linspace(lo, hi, nb + 1)

        def bins(v):
            return np.clip(np.floor((v - lo) / (hi - lo) * nb), 0, nb - 1)

        for i in np.nonzero(bins(got[:, j]) != bins(want[:, j]))[0]:
            kind, t = tol.get(name, ("abs", 0.0))
            t = t * abs(want[i, j]) if kind == "rel" else t
            assert np.abs(edges - want[i, j]).min() <= t, (name, i)
            flips += 1
        assert int(res.hist[j].sum()) == int(whist[j].sum()) == N_TRIALS_REF
    assert np.abs(res.hist - whist).sum() // 2 <= flips


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_dataset_mesh_matches_reference(ref, tmp_path, shape):
    """The corpus of the reference's meshed factory: summary (commits by
    the rounded chunk), manifest and shard indexes equal; per record the
    prefix and every label byte equal, the tile within the FFT
    tolerance."""
    from psrsigsim_torch.datasets import DatasetFactory, DatasetReader
    from test_torch_datasets import PARITY

    tag = _tag(shape)
    out = str(tmp_path / "port")
    summary = DatasetFactory(PARITY, mesh=mesh(shape)).run(
        out, chunk_size=CORPUS_CHUNK_REF)
    assert {k: v for k, v in summary.items() if k != "telemetry"} == \
        ref["summary"][tag]
    want_dir = os.path.join(ref["dir"], f"corpus_{tag}")
    for name in ("dataset_manifest.json",
                 *[f"shard-{s:05d}.index.json"
                   for s in range(PARITY["shards"])]):
        with open(os.path.join(out, name)) as a, \
                open(os.path.join(want_dir, name)) as b:
            assert json.load(a) == json.load(b), name
    got, want = DatasetReader(out), DatasetReader(want_dir)
    for i in range(PARITY["n_records"]):
        assert got.record_bytes(i)[:24] == want.record_bytes(i)[:24], i
        g, w = got.read_index(i), want.read_index(i)
        for name, _, _ in got.layout:
            if name == "tile":
                np.testing.assert_allclose(
                    g[name], w[name], rtol=1e-5,
                    atol=1e-5 * np.abs(w[name]).max())
            else:
                assert g[name].tobytes() == w[name].tobytes(), (i, name)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 8)])
def test_card_fold_ensemble_mesh_bit_equal(card, shape):
    """On one card, a mesh of repeated cuda:0 positions: the fused kernel
    once per position per chunk, codes and floats bit-equal."""
    from psrsigsim_torch.ops import fold_quantize as fq
    from psrsigsim_torch.parallel import FoldEnsemble

    objs = _objects(nchan=64)
    want_q = FoldEnsemble(*objs, device="cuda").run_quantized(8, seed=1)
    want_f = FoldEnsemble(*objs, device="cuda").run(4, seed=1)
    ens = FoldEnsemble(*objs, mesh=mesh(shape, "cuda:0"))
    fq.fold_quantize.launches = 0
    got = ens.run_quantized(8, seed=1)
    assert fq.fold_quantize.launches == shape[0] * shape[1]
    for a, b in zip(got, want_q):
        assert torch.equal(a, b)
    assert torch.equal(ens.run(4, seed=1), want_f)


@pytest.mark.cuda
def test_card_chan_group_guard(card):
    from psrsigsim_torch.parallel import FoldEnsemble

    with pytest.raises(ValueError, match="8-channel group"):
        FoldEnsemble(*_objects(nchan=64), mesh=mesh((1, 16), "cuda:0"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 8])
def test_card_seq_search_bit_equal(card, n):
    import dataclasses

    from psrsigsim_torch.parallel import make_seq_mesh, seq_sharded_search
    from psrsigsim_torch.simulate import single_pipeline
    from psrsigsim_torch.utils import key
    from test_torch_seqshard import _cfg

    cfg, prof, nn = _cfg("psrsigsim_torch", 0.2)
    for mode in ("envelope", "fft"):
        c = dataclasses.replace(cfg, shift_mode=mode)
        want = single_pipeline(key(7, "cpu"), torch.tensor(15.0),
                               torch.tensor(nn), prof, c, device="cuda")
        got = seq_sharded_search(c, make_seq_mesh(devices=["cuda:0"] * n))(
            key(7, "cpu"), 15.0, nn, prof)
        if mode == "envelope":
            assert torch.equal(got, want)
        else:
            l2 = float(torch.sqrt((want.double() ** 2).mean()
                                  * want.shape[-1]))
            assert float((got - want).abs().max()) < 1e-5 * l2


if __name__ == "__main__":
    _child(sys.argv[1])
