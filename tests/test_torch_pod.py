"""The port's pods (psrsigsim_torch/runtime/dist.py and the pod adoption)
against the JAX package's tests/test_pod.py, class by class, on the CPU.

Layers, cheapest first:

* the single-process fallback: ``init_pod`` unconfigured is a no-op, and
  ``put_sharded``/``device_get`` solo equal plain placement, bit for bit;
* the registry/cache key audit across a SIMULATED 2-process topology
  (``fake_pod_for_tests``): keys fork on topology, never on the process
  id, and a follower refuses the leader-only entry points;
* the channel: an unauthenticated hello never fills a slot, an
  authenticated pair bootstraps, and two processes whose exchanges differ
  (another chunk, another shape) raise "out of lockstep" instead of
  assembling the wrong result;
* the real thing: local CPU pods (``psrsigsim_torch/tools/pod_runner.py``,
  the counterpart of the JAX package's tests/pod_runner.py) at host counts
  1, 2 and 4 over 4 mesh positions give bit-identical hashes for the
  ensemble (float, quantized, chunked), the study, the dataset records and
  the served profiles, over the channel fetch and over
  ``torch.distributed`` (gloo); and a 2-process pod's ``run_quantized``
  against the JAX package's single-process run on the same seed, within
  the port's export bound (DAT_SCL/DAT_OFFS rtol 1e-5, codes within 1 LSB
  on at most 1% of cells: the two FFT libraries differ by ulps).

The geometry is the JAX package's tests/fault_runner.py ``SIM_CONFIG`` (4
channels, 2 x 0.5 s subints), copied into pod_runner.py.  Every spawned
process has a timeout and one host thread.  The killed-follower and fleet
group proofs are in tests/test_torch_pod_groups.py.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
POD_RUNNER = os.path.join(ROOT, "psrsigsim_torch", "tools", "pod_runner.py")
sys.path.insert(0, HERE)

pytestmark = pytest.mark.faults


def pod_runner():
    """The port's pod driver, loaded from its file under a name of its own
    (the JAX package's tests/pod_runner.py is ``pod_runner`` on this
    path)."""
    import importlib.util

    mod = sys.modules.get("psrsigsim_torch_pod_runner")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "psrsigsim_torch_pod_runner", POD_RUNNER)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["psrsigsim_torch_pod_runner"] = mod
    return mod


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("PSS_SAMPLER", "PSS_EPHEM", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY", "PSS_POD_FETCH", "PSS_POD_COORDINATOR",
              "PSS_POD_NUM_PROCESSES", "PSS_POD_PROCESS_ID",
              "PSS_POD_CHANNEL_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


@pytest.fixture
def dist():
    from psrsigsim_torch.runtime import dist

    return dist


@pytest.fixture
def fake_pod(dist):
    """Install a simulated pod topology; always restore the real one."""
    installed = []

    def _install(num_processes, process_id=0):
        installed.append(dist.fake_pod_for_tests(num_processes,
                                                 process_id=process_id))
        return dist.pod_info()

    yield _install
    for prev in reversed(installed):
        dist._pod = prev


class TestSoloFallback:
    """Unconfigured, every dist helper is the single-process call."""

    def test_init_pod_unconfigured_is_noop(self, dist, monkeypatch):
        for k in ("PSS_POD_COORDINATOR", "PSS_POD_NUM_PROCESSES",
                  "PSS_POD_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        prev = dist._pod
        try:
            dist._pod = dist._SOLO
            info = dist.init_pod()
            assert info.initialized and not info.is_pod
            assert info.is_leader and info.num_processes == 1
            assert dist.pod_channel() is None
        finally:
            dist._pod = prev

    def test_put_sharded_matches_plain_placement(self, dist):
        import torch

        from psrsigsim_torch.parallel import make_mesh, shard_batch
        from psrsigsim_torch.parallel.mesh import Sharding

        mesh = make_mesh((4, 1), ["cpu"] * 4)
        x = np.arange(16, dtype=np.float32)
        a = dist.put_sharded(x, Sharding(mesh, ("obs",)))
        parts = shard_batch(x, mesh)
        assert a.is_fully_addressable
        assert [torch.equal(t, p) for (_, t), p in zip(a.shards, parts)] \
            == [True] * 4
        np.testing.assert_array_equal(dist.device_get(a), x)
        # key words stage too, replicated over the chan axis
        keys = np.arange(32, dtype=np.uint32).reshape(16, 2)
        k = dist.put_sharded(keys, Sharding(mesh, ("obs", None)))
        np.testing.assert_array_equal(dist.device_get(k), keys)
        idx, block = dist.local_rows(k)
        np.testing.assert_array_equal(idx, np.arange(16))
        np.testing.assert_array_equal(block, keys)

    def test_device_get_matches_host_copy(self, dist):
        import torch

        tree = {"a": torch.arange(8), "b": (torch.ones(3), 2.5)}
        got = dist.device_get(tree)
        np.testing.assert_array_equal(got["a"], np.arange(8))
        np.testing.assert_array_equal(got["b"][0], np.ones(3, np.float32))
        assert got["b"][1] == 2.5

    def test_solo_keys_and_cache_path(self, dist):
        assert dist.pod_key() == ("solo",)
        assert dist.compile_cache_path("/tmp/cc") == "/tmp/cc"
        assert dist.is_leader()

    def test_solo_exchange_returns_local(self, dist):
        local = {(0, 0): (np.arange(3),)}
        assert dist.exchange(local, tag="x") == local


class TestTopologyKeyAudit:
    """Keys fork on topology, process-id-independently; a follower never
    runs the leader's side effects."""

    def test_pod_key_forks_and_is_process_id_independent(self, dist,
                                                         fake_pod):
        solo = dist.pod_key()
        fake_pod(2, process_id=0)
        k0 = dist.pod_key()
        fake_pod(2, process_id=1)
        k1 = dist.pod_key()
        assert k0 == k1 == ("pod", 2)
        assert k0 != solo

    def test_trace_env_key_covers_topology(self, fake_pod):
        from psrsigsim_torch.runtime.programs import trace_env_key

        base = trace_env_key("cpu")
        fake_pod(2)
        assert trace_env_key("cpu") != base

    def test_compile_cache_path_forks_per_host_count(self, dist, fake_pod):
        assert dist.compile_cache_path("/x") == "/x"
        fake_pod(2)
        assert dist.compile_cache_path("/x") == os.path.join("/x", "hosts2")
        fake_pod(4)
        assert dist.compile_cache_path("/x") == os.path.join("/x", "hosts4")

    def test_assert_single_build_across_topologies(self, fake_pod):
        """One geometry, two topologies: two artifacts, each built once —
        the solo build is never served to the simulated pod."""
        from psrsigsim_torch.runtime.programs import (ProgramRegistry,
                                                      trace_env_key)

        reg = ProgramRegistry("audit")
        built = []

        def make(tag):
            def _build():
                built.append(tag)
                return tag
            return _build

        key_solo = ("fam", "geom", trace_env_key("cpu"))
        a = reg.get_or_build(key_solo, make("solo"))
        fake_pod(2)
        key_pod = ("fam", "geom", trace_env_key("cpu"))
        assert key_pod != key_solo
        assert reg.peek(key_pod) is None   # never cross-served
        b = reg.get_or_build(key_pod, make("pod2"))
        assert (a, b) == ("solo", "pod2") and built == ["solo", "pod2"]
        reg.assert_single_build()

    def test_follower_refuses_leader_only_paths(self, dist, fake_pod,
                                                tmp_path):
        fake_pod(2, process_id=1)
        assert not dist.is_leader()
        from psrsigsim_torch.io.export import export_ensemble_psrfits
        from psrsigsim_torch.runtime import supervised_export

        out = str(tmp_path / "never")
        with pytest.raises(RuntimeError, match="pod_export_follower"):
            export_ensemble_psrfits(object(), 4, out, "t", None)
        with pytest.raises(RuntimeError, match="pod_export_follower"):
            supervised_export(object(), 4, out, "t", None)
        assert not os.path.exists(out)

    def test_pod_mesh_refuses_integrity(self, fake_pod):
        """The integrity layer's audits re-run a chunk on one process:
        a pod mesh refuses them before any exchange (the reference's
        rule)."""
        from psrsigsim_torch.parallel import make_mesh
        from psrsigsim_torch.simulate import Simulation

        sim = Simulation(psrdict=dict(pod_runner().TINY), device="cpu")
        sim.init_all()
        fake_pod(2, process_id=0)
        ens = sim.to_ensemble(mesh=make_mesh(None, ["cpu"]))
        with pytest.raises(RuntimeError, match="not supported on a pod"):
            next(ens.iter_chunks(4, quantized=True, integrity=True))
        with pytest.raises(RuntimeError, match="not supported on a pod"):
            ens.run_quantized_at([0, 1], audit=True)

    def test_mesh_positions_carry_their_process(self, fake_pod):
        """Under a pod, make_mesh's positions are every process's devices
        in process order; this process runs its own."""
        from psrsigsim_torch.parallel import make_mesh

        fake_pod(2, process_id=1)
        mesh = make_mesh(None, ["cpu", "cpu"])
        assert dict(mesh.shape) == {"obs": 4, "chan": 1}
        assert mesh.processes.reshape(-1).tolist() == [0, 0, 1, 1]
        assert [mesh.is_local((i, 0)) for i in range(4)] \
            == [False, False, True, True]
        assert mesh.spans_processes
        assert mesh.padded(5) == 8


def _leader(dist, info, port, timeout_s):
    box = {}

    def _run():
        try:
            box["ch"] = dist.PodChannel(info, port, timeout_s=timeout_s)
        except Exception as exc:  # noqa: BLE001 — asserted on below
            box["err"] = exc

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return t, box


def _lockstep_child(tag, shape):
    """One process of a 2-process pod (PSS_POD_* in the environment) that
    exchanges one array under ``tag``; prints the merged keys."""
    from psrsigsim_torch.runtime import dist

    info = dist.init_pod(timeout_s=30.0)
    local = {(info.process_id, 0): (np.full(shape, info.process_id,
                                            np.int32),)}
    out = dist.exchange(local, tag=tag)
    dist.shutdown_pod()
    print(json.dumps(sorted(k[0] for k in out)), flush=True)


class TestChannelHello:
    """The channel's authenticated hello, and the exchange's lockstep
    checks."""

    def test_bad_hello_never_fills_a_slot(self, dist):
        info = dist.PodInfo(process_id=0, num_processes=2,
                            coordinator="127.0.0.1:0", initialized=True)
        (port,) = dist.free_ports(1)
        t, box = _leader(dist, info, port, timeout_s=2.5)
        deadline = time.time() + 2.0
        sent = False
        while not sent and time.time() < deadline:
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=1.0)
                # a forged hello: the right size, the wrong MAC (a pickle
                # would land here — it is never unpickled)
                s.sendall(b"c" + b"\x00" * (dist._HELLO.size - 1
                                            + dist._HELLO_MAC))
                sent = True
                s.close()
            except OSError:
                time.sleep(0.05)
        t.join(timeout=10.0)
        assert sent and "ch" not in box
        assert isinstance(box.get("err"), TimeoutError)

    def test_authenticated_pair_bootstraps(self, dist):
        lead = dist.PodInfo(process_id=0, num_processes=2,
                            coordinator="127.0.0.1:0", initialized=True)
        fol = dist.PodInfo(process_id=1, num_processes=2,
                           coordinator="127.0.0.1:0", initialized=True)
        (port,) = dist.free_ports(1)
        t, box = _leader(dist, lead, port, timeout_s=10.0)
        fch = dist.PodChannel(fol, port, timeout_s=10.0,
                              on_peer_lost=lambda pid: None)
        t.join(timeout=10.0)
        lch = box.get("ch")
        assert lch is not None, box.get("err")
        try:
            lch.broadcast(("hello", 1))
            assert fch.recv() == ("hello", 1)
            fch.send_to_leader(("ack", 1))
            assert lch.gather() == {1: ("ack", 1)}
        finally:
            lch._on_peer_lost = lambda pid: None
            for ch in (fch, lch):
                ch.close()

    def _pair(self, tags, shapes):
        from psrsigsim_torch.runtime.dist import free_ports

        coord, chan = free_ports(2)
        procs = []
        for pid in range(2):
            env = _env(PSS_POD_COORDINATOR=f"127.0.0.1:{coord}",
                       PSS_POD_NUM_PROCESSES="2",
                       PSS_POD_PROCESS_ID=str(pid),
                       PSS_POD_CHANNEL_PORT=str(chan))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lockstep",
                 tags[pid], json.dumps(shapes[pid])],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        out = []
        for p in procs:
            o, e = p.communicate(timeout=60)
            out.append((p.returncode, o, e))
        return out

    def test_exchange_in_lockstep_merges_every_part(self):
        res = self._pair(["c0", "c0"], [[3], [3]])
        for rc, o, e in res:
            assert rc == 0, e[-2000:]
            assert json.loads(o.strip().splitlines()[-1]) == [0, 1]

    @pytest.mark.parametrize("tags,shapes", [
        (["chunk0", "chunk1"], [[3], [3]]),    # another chunk's parts
        (["c0", "c0"], [[3], [4]]),            # another shape
    ])
    def test_exchange_out_of_lockstep_raises(self, tags, shapes):
        """The leader refuses the follower's frame loudly; the follower,
        its leader gone without the clean-shutdown frame, exits with
        POD_PEER_EXIT — nothing is assembled."""
        from psrsigsim_torch.runtime.dist import POD_PEER_EXIT

        (lrc, lo, le), (frc, fo, fe) = self._pair(tags, shapes)
        assert lrc != 0 and "out of lockstep" in le, (lrc, le[-2000:])
        assert frc == POD_PEER_EXIT, (frc, fe[-2000:])
        assert not lo.strip() and not fo.strip()

    def test_collective_refuses_two_ranks_on_one_card(self, dist):
        """NCCL refuses two ranks on one GPU: the collective fetch says so
        and never switches to gloo on its own."""
        dist.check_distinct_cards([("h", "GPU-a"), ("h", "GPU-b")])
        with pytest.raises(RuntimeError, match="share one card"):
            dist.check_distinct_cards([("h", "GPU-a"), ("h", "GPU-a")])


def _identity(hosts, families, timeout, device="cpu", **env):
    proc = subprocess.run(
        [sys.executable, POD_RUNNER, "--mode", "identity", "--hosts", hosts,
         "--families", families, "--device", device, "--total-devices", "4",
         "--timeout", str(timeout)],
        capture_output=True, text=True, timeout=timeout * 3 + 30,
        env=_env(**env), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reference(out):
    """The JAX package's single-process run_quantized of the same workload
    (run in a child process, with the R1/R2 shims)."""
    from test_torch_toa import shims

    shims()
    from psrsigsim_tpu.simulate import Simulation

    tool = pod_runner()
    sim = Simulation(psrdict=dict(tool.TINY))
    sim.init_all()
    d, s, o = sim.to_ensemble().run_quantized(8, seed=tool.SEED)
    np.savez(out, data=np.asarray(d), scl=np.asarray(s), offs=np.asarray(o))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One identity sweep at host counts 1, 2 and 4 (every family), with
    the leaders' run_quantized saved for the parity leg."""
    save = str(tmp_path_factory.mktemp("pod_cluster") / "rq")
    proc = subprocess.run(
        [sys.executable, POD_RUNNER, "--mode", "identity", "--hosts",
         "1,2,4", "--families", "ensemble,mc,dataset,serve", "--device",
         "cpu", "--total-devices", "4", "--timeout", "150", "--save", save],
        capture_output=True, text=True, timeout=480, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), save


class TestPodCluster:
    """Local CPU pods: the pod analogue of chunk-size invariance."""

    def test_host_count_bit_identity_1_2_4(self, cluster):
        verdict, _ = cluster
        assert verdict["ok"], verdict["mismatches"]
        assert verdict["mismatches"] == {}
        for key in ("ensemble_quantized", "ensemble_float",
                    "ensemble_chunks", "mc_metrics", "mc_hist",
                    "dataset_records", "serve_profiles"):
            assert key in verdict["hashes"], verdict["hashes"]
        for h, workers in verdict["workers"].items():
            assert len(workers) == int(h)
            for w in workers:
                # a pod exchanges once a run_quantized; solo never
                n = w["exchange"]["run_quantized"]["exchanges"]
                assert n == (1 if int(h) > 1 else 0), (h, w["exchange"])

    def test_every_rank_holds_the_whole_result(self, cluster):
        """Each rank's own hashes, not only the merged ones, equal host
        count 1's: a fault in one rank's assembly cannot hide behind
        another's."""
        verdict, _ = cluster
        leader_only = set(pod_runner().LEADER_ONLY)
        for h, workers in verdict["workers"].items():
            for w in workers:
                want = {k: v for k, v in verdict["hashes"].items()
                        if w["process_id"] == 0 or k not in leader_only}
                assert w["hashes"] == want, (h, w["process_id"])

    def test_rank_disagreement_is_a_mismatch(self):
        """The identity verdict compares a pod's ranks with each other: a
        rank whose hash of a family differs, or a follower that reports a
        leader-only result, is named as a mismatch."""
        merge = pod_runner().merge_ranks
        lead = {"process_id": 0, "hashes": {"a": "1", "serve_profiles": "s"}}
        same = {"process_id": 1, "hashes": {"a": "1"}}
        assert merge([lead, same], "hosts2") == (lead["hashes"], {})
        apart = {"process_id": 1, "hashes": {"a": "2"}}
        assert merge([lead, apart], "hosts2")[1] == {
            "hosts2/rank0-vs-rank1/a": ["1", "2"]}
        serving = {"process_id": 1,
                   "hashes": {"a": "1", "serve_profiles": "s"}}
        assert merge([lead, serving], "hosts2")[1] == {
            "hosts2/rank1/serve_profiles": [None, "s"]}

    def test_default_device_is_the_card(self, monkeypatch):
        """Without --device the tool takes the card, and without one it
        raises before it spawns a process."""
        import torch

        tool = pod_runner()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(tool, "spawn", lambda *a, **k: pytest.fail(
            "spawned a pod without a card"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--mode", "identity", "--hosts", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.spawn_export_group("unused", 2, 4, 2)

    def test_collective_fetch_is_bit_identical(self, cluster):
        """PSS_POD_FETCH=collective (torch.distributed, gloo on the host)
        gives the channel fetch's bytes."""
        verdict, _ = cluster
        got = _identity("2", "ensemble", 150, PSS_POD_FETCH="collective")
        assert got["ok"], got
        for key in ("ensemble_quantized", "ensemble_float",
                    "ensemble_chunks"):
            assert got["hashes"][key] == verdict["hashes"][key]

    def test_pod_against_the_jax_package(self, cluster, tmp_path):
        """The 2-process pod's run_quantized against the JAX package's
        single-process run on the same seed: DAT_SCL/DAT_OFFS within rtol
        1e-5, codes within 1 LSB on at most 1% of cells."""
        _, save = cluster
        ref = str(tmp_path / "ref.npz")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reference", ref],
            capture_output=True, text=True, timeout=300, env=_env(),
            cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(ref) as w, np.load(save + ".hosts2.npz") as g:
            np.testing.assert_allclose(g["scl"], w["scl"], rtol=1e-5)
            np.testing.assert_allclose(g["offs"], w["offs"], rtol=1e-5)
            diff = g["data"].astype(np.int32) - w["data"].astype(np.int32)
            assert np.abs(diff).max() <= 1
            assert (diff != 0).mean() <= 1e-2
            assert g["data"].shape == w["data"].shape


def _cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a pod's ranks on the card)")


@pytest.mark.cuda
def test_pod_on_the_card_is_bit_identical():
    """Two ranks sharing the card (two CUDA contexts on cuda:0) over the
    channel give the one-process mesh's and the mesh-free run's bytes: the
    ensemble through the kernels, and the served profiles."""
    _cuda()
    verdict = _identity("0,1,2", "ensemble,serve", 240, device="cuda")
    assert verdict["ok"], verdict["mismatches"]
    for w in verdict["workers"]["2"]:
        assert w["launches"]["run_quantized"]["fold_quantize"] == 2
        assert w["launches"]["run"]["rng_field"] == 4


@pytest.mark.cuda
def test_collective_on_one_card_raises():
    """PSS_POD_FETCH=collective with both ranks on cuda:0: NCCL refuses
    two ranks on one GPU, so the exchange raises and says why, and no rank
    carries on over gloo."""
    _cuda()
    proc = subprocess.run(
        [sys.executable, POD_RUNNER, "--mode", "identity", "--hosts", "2",
         "--families", "ensemble", "--device", "cuda", "--total-devices",
         "2", "--timeout", "180"],
        capture_output=True, text=True, timeout=400,
        env=_env(PSS_POD_FETCH="collective"), cwd=ROOT)
    assert proc.returncode != 0
    assert "share one card" in proc.stderr, proc.stderr[-3000:]


if __name__ == "__main__":
    if sys.argv[1] == "--lockstep":
        _lockstep_child(sys.argv[2], tuple(json.loads(sys.argv[3])))
    elif sys.argv[1] == "--reference":
        _reference(sys.argv[2])
