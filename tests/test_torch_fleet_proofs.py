"""The port's serving fleet end to end on the CPU, and its router and
fleet against the JAX package's.

Against the reference, whose values come from a child process (this file
run as a script, with the R1/R2 shims of tests/test_torch_toa.py):

* routing: the owners of 256 spec hashes over the replica id sets
  {0, 1, 2} and {0, 2}, and the rendezvous ``_score`` bytes, equal;
* scripted decisions: one deterministic scripted transport and a patched
  clock drive both routers through connection errors and failover, fast
  5xx and an open breaker, half-open probes after ``breaker_reset_s``, a
  latency ejection, 429 pass-through, the ``route.blackhole`` and
  ``replica.kill`` shots and a below-quorum rejection: the replica ids of
  every forward, every outcome and the final ``stats()`` equal;
* a cache directory written by the reference's ``SimulationService`` is
  served by a port fleet of two ``--device cpu`` replicas with
  ``verify_cache=True`` as cache hits, byte for byte, with zero device
  calls;
* the chaos proof (``tests/fleet_runner.py --mode chaos`` at its tier-1
  size: 2 replicas, 6 requests, ``replica.kill`` after 2): every profile
  byte-identical to a solo port service, whose profiles are within rtol
  1e-5 plus 1e-5 of the peak of the reference's (threefry on the host);
  zero lost commits, the kill fired, the corpse restarted, one build per
  (geometry, width) per replica.

Within the port: the multi-process cache contention stress
(``test_fleet.py::TestFleetProofs::test_multiprocess_cache_contention``),
the raising paths (no card and no device, multi-host groups) and the
import check.  The reference's ``slow`` proofs (elastic, aio chaos,
c10k) run tests/fleet_runner.py itself against the port: this file, run
with ``--runner``, points the runner's imports of the JAX package's
``runtime`` and ``serve`` names at the port's, and every fleet it builds
runs its replicas with ``--device cpu``.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_toa import child_env, shims  # noqa: E402

#: tests/fleet_runner.py's fleet geometry (bench.py's serving spec:
#: 4 channels, 1024 bins, 2 subints)
BASE_SPEC = {
    "nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
    "period_s": 0.005, "smean_jy": 0.05,
    "seed": 3, "dm": 10.0,
}
CHAOS_REQUESTS, CHAOS_KILL_AFTER, CHAOS_THREADS = 6, 2, 3
ROUTE_HASHES = [hashlib.sha256(f"route-{i}".encode()).hexdigest()
                for i in range(256)]
ROUTE_SETS = ((0, 1, 2), (0, 2))


def request_spec(i):
    """tests/fleet_runner.py's i-th request."""
    return dict(BASE_SPEC, seed=300 + i, dm=10.0 + 0.25 * (i % 1000))


#: the specs the reference serves into the cache the port's fleet reads
CACHE_SPECS = [request_spec(100 + i) for i in range(3)]


class StubFleet:
    """An in-memory fleet: live replica ids with fake urls and a kill log
    (tests/test_fleet.py's stub)."""

    def __init__(self, ids, quorum=1):
        self.live = {i: f"stub://replica{i}" for i in ids}
        self.quorum = quorum
        self.killed = []

    def endpoints(self):
        return sorted(self.live.items())

    def has_quorum(self):
        return len(self.live) >= self.quorum

    def kill_replica(self, i, sig=None):
        self.killed.append(i)
        self.live.pop(i, None)

    def health(self):
        return {"ok": self.has_quorum(), "healthy": len(self.live)}


class FakeClock:
    """The router module's ``time``: monotonic time advances only when the
    scripted transport or the router sleeps."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += max(float(dt), 0.0)


def route_owners(FleetRouter):
    """Owners of ROUTE_HASHES over each id set, and the score bytes."""
    out = {}
    for ids in ROUTE_SETS:
        r = FleetRouter(StubFleet(ids), transport=lambda *a: (200, {}))
        out["owners_" + "".join(map(str, ids))] = np.array(
            [r.route(h)[0] for h in ROUTE_HASHES])
    out["scores"] = np.array([FleetRouter._score(h, rid).hex()
                              for h in ROUTE_HASHES for rid in (0, 1, 2)])
    return out


#: the scripted traffic, phase by phase: the replicas' behaviour from then
#: on (mode, seconds a forward takes), the clock advance before the phase,
#: replicas that vanish, and the number of requests
SCRIPT = [
    # the route.blackhole shot hits the first forward; healthy traffic
    ({0: ("ok", 0.010), 1: ("ok", 0.012), 2: ("ok", 0.011)}, 0.0, (), 8),
    # replica 1 refuses connections: failover; two failures open it
    ({1: ("down", 0.0)}, 0.0, (), 16),
    # replica 2 answers a fast 500: returned; two open its breaker
    ({2: ("5xx", 0.001)}, 0.0, (), 8),
    # past breaker_reset_s both heal: half-open probes close them
    ({1: ("ok", 0.012), 2: ("ok", 0.011)}, 1.5, (), 12),
    # replica 2 turns slow: ejected as a latency outlier
    ({2: ("ok", 0.5)}, 0.0, (), 12),
    # replica 0 sheds with 429 (passed through, kept out of the EWMA);
    # replica 2 is fast again, past its reset window
    ({0: ("429", 0.001), 2: ("ok", 0.011)}, 1.5, (), 8),
    # replica 0 recovers; replica.kill fires at request 67
    ({0: ("ok", 0.010)}, 0.0, (), 8),
    # one more replica vanishes: below quorum, every request rejected
    ({}, 0.0, "first", 3),
]


def scripted_decisions(router_mod, FaultPlan, RequestRejected, RouteFailed,
                       scratch):
    """Drive ``router_mod.FleetRouter`` through SCRIPT on a stub fleet of
    three replicas (quorum 2) with a patched clock.  Returns the replica
    id of every forward, every request's outcome and the stats after each
    phase, as JSON text."""
    clock = FakeClock()
    saved = router_mod.time
    router_mod.time = clock
    try:
        fleet = StubFleet((0, 1, 2), quorum=2)
        modes = {}
        calls = []

        def transport(method, url, body, timeout):
            rid = int(url.split("replica")[1].split("/")[0])
            calls.append(rid)
            if rid not in fleet.live:
                raise ConnectionError(f"replica {rid} was killed")
            mode, lat = modes[rid]
            clock.sleep(lat)
            if mode == "down":
                raise ConnectionError(f"replica {rid} refused")
            if mode == "5xx":
                return 500, {"error": "internal", "rid": rid}
            if mode == "429":
                return 429, {"error": "queue full", "retry_after_s": 0.5,
                             "rid": rid}
            return 200, {"status": "done", "rid": rid}

        plan = FaultPlan(scratch, {"route.blackhole": {"times": 1},
                                   "replica.kill": {"after_requests": 67}})
        r = router_mod.FleetRouter(
            fleet, faults=plan, transport=transport, breaker_fails=2,
            breaker_reset_s=1.0, breaker_outlier=3.0,
            breaker_min_latency_s=0.05, breaker_min_samples=2)
        outcomes, phases = [], []
        k = 0
        for phase_modes, advance, vanish, n in SCRIPT:
            modes.update(phase_modes)
            clock.sleep(advance)
            if vanish:
                fleet.live.pop(min(fleet.live))
            for _ in range(n):
                spec = dict(BASE_SPEC, seed=1000 + k)
                k += 1
                try:
                    status, resp = r.submit(spec, deadline_s=10.0)
                    outcomes.append([status, resp.get("rid")])
                except (RequestRejected, RouteFailed) as err:
                    outcomes.append([type(err).__name__])
            phases.append(r.stats())
        return json.dumps({"calls": calls, "outcomes": outcomes,
                           "phases": phases, "killed": fleet.killed,
                           "shots": {p: plan.shots_fired(p) for p in
                                     ("route.blackhole", "replica.kill")}},
                          sort_keys=True)
    finally:
        router_mod.time = saved


def _child(out):
    shims()
    import psrsigsim_tpu.serve.router as router_mod
    from psrsigsim_tpu.runtime import FaultPlan
    from psrsigsim_tpu.serve import (RequestRejected, ResultCache,
                                     SimulationService)

    res = route_owners(router_mod.FleetRouter)
    res["script"] = np.array(scripted_decisions(
        router_mod, FaultPlan, RequestRejected, router_mod.RouteFailed,
        os.path.join(out, "script_scratch")))
    # the specs of the chaos proof, served by the reference (threefry)
    svc = SimulationService(cache_dir=None, widths=(1,))
    try:
        for i in range(CHAOS_REQUESTS):
            rid, _ = svc.submit(request_spec(i))
            res[f"chaos_{i}"] = np.asarray(svc.result(rid, timeout=600))
    finally:
        svc.close()
    # a cache directory the reference's service commits into
    svc = SimulationService(cache_dir=os.path.join(out, "jax_cache"),
                            widths=(1,))
    try:
        for i, spec in enumerate(CACHE_SPECS):
            rid, _ = svc.submit(spec)
            res[f"cache_{i}"] = np.asarray(svc.result(rid, timeout=600))
    finally:
        svc.close()
    assert len(ResultCache(os.path.join(out, "jax_cache"))) == len(
        CACHE_SPECS)
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_fleet")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", str(out)], env=child_env(),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        res = dict(z)
    res["dir"] = str(out)
    return res


def _replica_env():
    """The replicas' environment: threefry on the host (PSS_SAMPLER
    unset), as the in-process service and the reference draw."""
    env = dict(os.environ)
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_INTEGRITY"):
        env.pop(k, None)
    return env


def _profile(resp):
    return np.asarray(resp["profile"], np.float32)


def _drive(router, specs, threads, deadline_s):
    """Serve every spec through the router from ``threads`` concurrent
    clients: ({index: profile}, errors)."""
    out, errors = {}, []

    def one(i):
        status, resp = router.submit(specs[i], deadline_s=deadline_s,
                                     wait=True)
        if status != 200 or resp.get("status") != "done":
            raise RuntimeError(f"request {i}: HTTP {status} {resp}")
        return i, _profile(resp)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for fut in [pool.submit(one, i) for i in range(len(specs))]:
            try:
                i, prof = fut.result()
                out[i] = prof
            except Exception as err:  # noqa: BLE001 - collected verdict
                errors.append(f"{type(err).__name__}: {err}")
    return out, errors


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def _audit(cache_dir):
    """The shared tier after the drain: a verify re-hash and a leak scan."""
    from psrsigsim_torch.serve import ResultCache

    cache = ResultCache(cache_dir, verify=True)
    out = {"entries": len(cache), "lost_commits": cache.dropped,
           "claims": os.listdir(os.path.join(cache_dir, "claims")),
           "tmps": [n for n in os.listdir(os.path.join(cache_dir, "results"))
                    if n.endswith(".tmp")]}
    cache.close()
    return out


# ---------------------------------------------------------------------------
# the router against the JAX package's
# ---------------------------------------------------------------------------


def test_routing_owners_and_scores_match_reference(ref):
    from psrsigsim_torch.serve import FleetRouter

    got = route_owners(FleetRouter)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    # a departed replica moves only its own keys
    three, two = got["owners_012"], got["owners_02"]
    assert (two[three != 1] == three[three != 1]).all()
    assert set(three) == {0, 1, 2}


def test_scripted_decisions_match_reference(ref, tmp_path):
    import psrsigsim_torch.serve.router as router_mod
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.serve import RequestRejected

    got = scripted_decisions(router_mod, FaultPlan, RequestRejected,
                             router_mod.RouteFailed, str(tmp_path / "s"))
    assert got == str(ref["script"])
    # the script reached every decision it is meant to exercise
    res = json.loads(got)
    states = [{rid: (b["state"], b["reason"])
               for rid, b in st["breakers"].items()} for st in res["phases"]]
    assert states[1]["1"] == ("open", "errors")
    assert states[2]["2"] == ("open", "errors")
    assert states[3]["1"] == states[3]["2"] == ("closed", None)
    assert states[4]["2"] == ("open", "latency")
    st = res["phases"][-1]
    assert res["shots"] == {"route.blackhole": 1, "replica.kill": 1}
    assert st["blackholed"] == 1 and st["kills_fired"] == 1
    assert st["failovers"] >= 3 and st["ejections"] == 3
    assert [429, 0] in res["outcomes"] and [500, 2] in res["outcomes"]
    assert res["outcomes"][-3:] == [["RequestRejected"]] * 3
    assert st["rejected"] == 3


# ---------------------------------------------------------------------------
# subprocess proofs
# ---------------------------------------------------------------------------


@pytest.mark.faults
def test_jax_written_cache_served_by_port_fleet(ref, tmp_path):
    """The reference's committed artifacts, verified at start-up by two
    port replicas and served as cache hits: the reference's bytes, no
    device call."""
    from psrsigsim_torch.serve import FleetRouter, ReplicaFleet

    cache_dir = str(tmp_path / "cache")
    shutil.copytree(os.path.join(ref["dir"], "jax_cache"), cache_dir)
    fleet = ReplicaFleet(2, cache_dir, widths=(1,), verify_cache=True,
                         quorum=2, device="cpu", env=_replica_env(),
                         log_dir=str(tmp_path / "logs"))
    fleet.start()
    try:
        assert fleet.healthy_count() == 2
        router = FleetRouter(fleet)
        for i, spec in enumerate(CACHE_SPECS):
            status, resp = router.submit(spec, deadline_s=120, wait=True)
            assert status == 200 and resp["status"] == "done", resp
            assert resp["cached"] is True
            want = np.load(os.path.join(cache_dir, "results",
                                        resp["id"] + ".npy"))
            assert want.tobytes() == ref[f"cache_{i}"].tobytes()
            assert _profile(resp).tobytes() == want.tobytes()
        health = [_healthz(url) for _, url in fleet.endpoints()]
        assert [h["device_calls"] for h in health] == [0, 0]
    finally:
        codes = fleet.drain()
    assert set(codes.values()) == {0}


@pytest.mark.faults
def test_chaos_replica_kill_byte_identity(ref, tmp_path, monkeypatch):
    """replica.kill SIGKILLs a routed replica mid-traffic: every request
    completes byte-identical to a solo port service (itself within the
    fold bound of the reference), no commit is lost or torn, the
    supervisor restarts the corpse and each replica builds each bucket
    once."""
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.serve import (FleetRouter, ReplicaFleet,
                                       SimulationService)

    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_INTEGRITY"):
        monkeypatch.delenv(k, raising=False)
    specs = [request_spec(i) for i in range(CHAOS_REQUESTS)]
    svc = SimulationService(cache_dir=None, widths=(1,), device="cpu")
    try:
        ids = [svc.submit(s)[0] for s in specs]
        solo = [svc.result(rid, timeout=600) for rid in ids]
    finally:
        svc.close()
    for i, row in enumerate(solo):
        want = ref[f"chaos_{i}"]
        peak = np.abs(want).max()
        assert (np.abs(row - want) <= 1e-5 * np.abs(want)
                + 1e-5 * peak).all(), i

    warm = tmp_path / "warm.json"
    warm.write_text(json.dumps(BASE_SPEC))
    cache_dir = str(tmp_path / "fleet_cache")
    plan = FaultPlan(str(tmp_path / "scratch"),
                     {"replica.kill": {"after_requests": CHAOS_KILL_AFTER}})
    fleet = ReplicaFleet(2, cache_dir, widths=(1,), warmup_path=str(warm),
                         quorum=1, device="cpu", env=_replica_env(),
                         log_dir=str(tmp_path / "logs"))
    fleet.start()
    try:
        router = FleetRouter(fleet, faults=plan)
        served, errors = _drive(router, specs, CHAOS_THREADS, 300.0)
        t_end = time.monotonic() + 120
        while fleet.healthy_count() < 2 and time.monotonic() < t_end:
            time.sleep(0.1)
        recovered = fleet.healthy_count() == 2
        compile_counts = [_healthz(url)["compile_counts"]
                          for _, url in fleet.endpoints()]
        restarts = sum(fleet.health()["restarts"].values())
        stats = router.stats()
    finally:
        fleet.drain()
    assert not errors and len(served) == CHAOS_REQUESTS
    assert all(served[i].tobytes() == solo[i].tobytes() for i in served)
    assert plan.shots_fired("replica.kill") >= 1
    assert stats["kills_fired"] >= 1 and stats["failovers"] >= 1
    assert restarts >= 1 and recovered
    assert compile_counts and all(c == 1 for cc in compile_counts
                                  for c in cc.values())
    audit = _audit(cache_dir)
    assert audit == {"entries": CHAOS_REQUESTS, "lost_commits": 0,
                     "claims": [], "tmps": []}


def _stress_hash(j):
    return hashlib.sha256(f"stress-{j}".encode()).hexdigest()


def _stress_array(j):
    return np.full((3, 16), float(j), np.float32)


def _stress_worker(cache_dir, worker, puts, hashes, plan_path):
    """One contending process: overlapping put/get of a shared hash pool,
    identical content per hash, so any byte divergence is a torn
    commit."""
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.serve import ResultCache

    with open(plan_path) as f:
        plan = json.load(f)
    cache = ResultCache(cache_dir, faults=FaultPlan(plan["scratch_dir"],
                                                    plan["spec"]),
                        claim_timeout_s=2.0)
    for k in range(puts):
        j = (worker + k) % hashes
        if cache.put(_stress_hash(j), _stress_array(j))["hash"] \
                != _stress_hash(j):
            return 1
        nxt = (j + 1) % hashes
        got = cache.get(_stress_hash(nxt))
        if got is not None and got[0, 0] != float(nxt):
            return 1
    cache.close()
    return 0


@pytest.mark.faults
def test_multiprocess_cache_contention(tmp_path):
    """4 processes hammer one cache dir with overlapping put/get of
    identical and distinct hashes (cache.contend dwells inside the commit
    window): a consistent index, no torn artifacts, exactly one committed
    artifact per hash, no leaked claim or temp file."""
    from psrsigsim_torch.serve import ResultCache

    workers, puts, hashes = 4, 24, 8
    cache_dir = str(tmp_path / "cache")
    plan_path = str(tmp_path / "plan.json")
    with open(plan_path, "w") as f:
        json.dump({"scratch_dir": str(tmp_path / "scratch"),
                   "spec": {"cache.contend": {"hold_s": 0.05,
                                              "times": workers}}}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stress-worker",
         cache_dir, str(w), str(puts), str(hashes), plan_path],
        env=env, stderr=subprocess.PIPE, text=True) for w in range(workers)]
    fails = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        if p.returncode != 0:
            fails.append(err[-2000:])
    assert not fails, fails
    cache = ResultCache(cache_dir, verify=True)
    torn = [j for j in range(hashes)
            if cache.get(_stress_hash(j)) is None
            or cache.get(_stress_hash(j)).tobytes()
            != _stress_array(j).tobytes()]
    entries, dropped = len(cache), cache.dropped
    cache.close()
    with open(os.path.join(cache_dir, "cache_journal.jsonl")) as f:
        puts_per_hash = {}
        for rec in (json.loads(line) for line in f if line.strip()):
            if rec.get("e") == "put":
                puts_per_hash[rec["hash"]] = puts_per_hash.get(
                    rec["hash"], 0) + 1
    assert torn == [] and dropped == 0 and entries == hashes
    assert set(puts_per_hash.values()) == {1}
    assert os.listdir(os.path.join(cache_dir, "claims")) == []
    assert not [n for n in os.listdir(os.path.join(cache_dir, "results"))
                if n.endswith(".tmp")]


# ---------------------------------------------------------------------------
# raising paths
# ---------------------------------------------------------------------------


def test_no_card_no_device_raises_before_spawning(tmp_path, monkeypatch):
    import torch

    from psrsigsim_torch.serve import ReplicaFleet

    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaFleet(2, str(tmp_path / "c")).start()
    assert spawned == []


def test_device_is_forwarded_to_every_replica(tmp_path, monkeypatch):
    import torch

    from psrsigsim_torch.serve import ReplicaFleet

    cmd = ReplicaFleet(1, str(tmp_path), device="cpu")._replica_cmd(0)
    assert cmd[1:3] == ["-m", "psrsigsim_torch.serve"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fleet = ReplicaFleet(1, str(tmp_path))
    assert "--device" not in fleet._replica_cmd(0)   # the card: the default
    assert fleet._env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_multi_host_groups_raise(tmp_path):
    """A group of no process raises; a 2-process group (the pod program
    group, tests/test_torch_pod_groups.py) is a leader command plus a
    follower command that serves no HTTP and forwards the device."""
    from psrsigsim_torch.serve import ReplicaFleet

    with pytest.raises(ValueError, match="group_hosts"):
        ReplicaFleet(1, str(tmp_path), group_hosts=0, device="cpu")
    fleet = ReplicaFleet(1, str(tmp_path), group_hosts=2, device="cpu")
    lead = fleet._replica_cmd(0, pod=(1234, 1235), pod_host=0)
    fol = fleet._replica_cmd(0, pod=(1234, 1235), pod_host=1)
    for cmd, host in ((lead, "0"), (fol, "1")):
        i = cmd.index("--pod-num-hosts")
        assert cmd[i:i + 8] == ["--pod-num-hosts", "2", "--pod-host", host,
                                "--pod-coordinator", "127.0.0.1:1234",
                                "--pod-channel-port", "1235"]
        assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--pod-follower" in fol and "--pod-follower" not in lead


def test_fleet_and_router_import_neither_jax_nor_the_jax_package():
    code = ("import sys; import psrsigsim_torch.serve.fleet, "
            "psrsigsim_torch.serve.router, psrsigsim_torch.runtime; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'psrsigsim_tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_two_replicas_on_the_card_match_the_in_process_service(tmp_path):
    """Two replicas share the card: a spec served through the fleet is
    bit-equal to the same spec served by an in-process service there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the replicas' buckets launch the "
                    "sampler kernel, which has no CPU mode")
    from psrsigsim_torch.serve import (FleetRouter, ReplicaFleet,
                                       SimulationService)

    warm = tmp_path / "warm.json"
    warm.write_text(json.dumps(BASE_SPEC))
    fleet = ReplicaFleet(2, str(tmp_path / "cache"), widths=(1, 8),
                         warmup_path=str(warm), quorum=2,
                         log_dir=str(tmp_path / "logs"))
    fleet.start()
    try:
        status, resp = FleetRouter(fleet).submit(request_spec(0),
                                                 deadline_s=300, wait=True)
    finally:
        fleet.drain()
    assert status == 200 and resp["status"] == "done"
    svc = SimulationService(widths=(1, 8), device="cuda")
    try:
        rid, _ = svc.submit(request_spec(0))
        want = svc.result(rid, timeout=300)
    finally:
        svc.close()
    assert _profile(resp).tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the reference's slow proofs, run by tests/fleet_runner.py on the port
# ---------------------------------------------------------------------------


def _run_runner(args, timeout):
    env = dict(os.environ, PSS_SAMPLER="hw", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--runner", *args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        timeout=timeout, env=env, cwd=ROOT)
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert lines, "runner produced no verdict"
    return json.loads(lines[-1]), proc.returncode


def _runner(argv):
    """tests/fleet_runner.py, unchanged, on the port: its imports of the
    JAX package's ``runtime`` and ``serve`` names resolve to the port's,
    and every ReplicaFleet it builds runs its replicas with --device cpu."""
    import types

    import psrsigsim_torch.runtime as runtime
    import psrsigsim_torch.serve as serve

    class CPUFleet(serve.ReplicaFleet):
        def __init__(self, *args, **kw):
            kw.setdefault("device", "cpu")
            super().__init__(*args, **kw)

    facade = types.ModuleType("psrsigsim_tpu.serve")
    facade.__dict__.update({k: getattr(serve, k) for k in serve.__all__})
    facade.ReplicaFleet = CPUFleet
    pkg = types.ModuleType("psrsigsim_tpu")
    pkg.__path__ = []
    pkg.serve, pkg.runtime = facade, runtime
    sys.modules.update({"psrsigsim_tpu": pkg, "psrsigsim_tpu.serve": facade,
                        "psrsigsim_tpu.runtime": runtime})
    import fleet_runner

    return fleet_runner.main(argv)


@pytest.mark.slow
@pytest.mark.faults
class TestSlowFleetProofs:
    def test_elastic_overload_survival(self, tmp_path):
        verdict, rc = _run_runner(
            ["--mode", "elastic", "--out", str(tmp_path / "e")],
            timeout=560)
        assert rc == 0 and verdict["ok"], verdict
        assert verdict["byte_identical"] is True
        assert verdict["ramp"]["scaled_up"] and verdict["ramp"]["scaled_down"]
        assert verdict["ramp"]["lost_commits"] == 0
        assert verdict["gray"]["ejected"] and verdict["gray"]["recovered"]
        assert (verdict["gray"]["slow_responses"]
                <= verdict["gray"]["slow_budget"])
        assert verdict["enospc"]["completed"] == 4
        assert verdict["saturation"]["rejected"] >= 1
        assert verdict["saturation"]["bad_hint"] == 0

    def test_chaos_with_aio_frontend(self, tmp_path):
        verdict, rc = _run_runner(
            ["--mode", "chaos", "--out", str(tmp_path / "ca"),
             "--frontend", "aio",
             "--replicas", "2", "--requests", "6", "--kill-after", "2",
             "--threads", "3"],
            timeout=560)
        assert rc == 0 and verdict["ok"], verdict
        assert verdict["byte_identical"] is True
        assert verdict["lost_commits"] == 0
        assert verdict["kill_fired"] >= 1 and verdict["restarts"] >= 1

    def test_c10k_storm_byte_identity_and_fd_hygiene(self, tmp_path):
        verdict, rc = _run_runner(
            ["--mode", "c10k", "--out", str(tmp_path / "k"),
             "--conns", "400", "--deadline", "240"],
            timeout=560)
        assert rc == 0 and verdict["ok"], verdict
        assert verdict["byte_identical"] is True
        storm = verdict["storm"]
        assert storm["established"] >= 400
        assert storm["disk_hits_delta_steady"] == 0
        assert storm["device_calls"] == 0
        assert storm["reconnects"] >= 1 and storm["recovered"]
        assert verdict["pool"]["breaker_opened"]
        assert verdict["pool"]["victim_pooled_after"] == 0
        assert verdict["fd_leak"] <= 16


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        _child(sys.argv[2])
    elif sys.argv[1] == "--stress-worker":
        cache_dir, w, puts, hashes, plan_path = sys.argv[2:7]
        sys.exit(_stress_worker(cache_dir, int(w), int(puts), int(hashes),
                                plan_path))
    elif sys.argv[1] == "--runner":
        sys.exit(_runner(sys.argv[2:]))
