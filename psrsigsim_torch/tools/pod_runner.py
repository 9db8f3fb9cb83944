#!/usr/bin/env python3
"""Multi-process pod driver of the port: host-count bit-identity, warm
joins, the export program group and scaling (counterpart:
tests/pod_runner.py and the pod mode of tests/fault_runner.py).

    python3 psrsigsim_torch/tools/pod_runner.py --mode identity \\
        --hosts 1,2,4 --families ensemble,mc,dataset,serve --device cpu

Every process runs on the CUDA card unless ``--device cpu`` asks for the
host; without a card the tool raises before it spawns a process.

Each proof spawns N worker processes forming one pod on this machine (the
``PSS_POD_*`` environment, a loopback coordinator from ``free_ports``),
with the GLOBAL count of mesh positions held constant (``--total-devices``
positions, ``total / N`` a process, all on ``--device``), so the pod
analogue of the chunk-size invariance can be tested: the same global mesh
at host counts {1, 2, 4} must give bit-identical bytes from every family.
Host count 0 is one process without a mesh (the mesh-free path).  Every
spawned process has a timeout; one JSON verdict line on stdout per mode:

``--mode identity``
    For each host count of ``--hosts``: the ``--families`` (``ensemble``:
    ``run``, ``run_quantized`` and ``iter_chunks``; ``mc``: a Monte-Carlo
    study; ``dataset``: a record chunk, or with ``--dataset-out`` a whole
    corpus written by the factory; ``serve``: requests through a
    ``SimulationService`` led by process 0), sha256 of every result, and
    the mismatches across ranks of one pod (every rank holds the whole
    result, so every rank's hash of a family must agree; ``serve`` is the
    leader's alone) and across host counts.  Each worker also reports its
    kernel launches per leg and its pod exchanges (count, seconds, bytes).
``--mode warm``
    A second pod over the same checkout builds no kernel and adds no file
    to the build directory (the port's reading of a shared compilation
    cache: psrsigsim_torch/DIVERGENCES.md P25).
``--mode bench``
    ``run_quantized`` observations a second per host count at a fixed
    count of positions a process.

:func:`spawn_export_group` starts one supervised export as a program
group (process 0 runs ``supervised_export``, the followers
``pod_export_follower``; a plan arms ``pod.kill`` on the followers,
``{"after_chunks": n}``).

``--geometry tiny`` (the default) is the JAX package's fault-harness
workload (4 channels, 2 x 0.5 s subints); ``config1`` is BASELINE config 1
(J1713+0747, 64 channels, 2048 bins, 20 subints).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TEMPLATE = os.path.join(ROOT, "data", "B1855+09.L-wide.PUPPI.11y.x.sum.sm")
SEED = 3
# the JAX package's tests/fault_runner.py SIM_CONFIG, copied
TINY = {
    "fcent": 1400.0, "bandwidth": 400.0, "sample_rate": 0.2048,
    "Nchan": 4, "sublen": 0.5, "fold": True, "period": 0.005,
    "Smean": 0.05, "profiles": [0.5, 0.05, 1.0], "tobs": 1.0,
    "name": "J0000+0000", "dm": 10.0, "aperture": 100.0,
    "area": 5500.0, "Tsys": 35.0, "tscope_name": "T",
    "system_name": "S", "rcvr_fcent": 1400, "rcvr_bw": 400,
    "rcvr_name": "R", "backend_samprate": 12.5, "backend_name": "B",
}
# BASELINE config 1 (chip_smoke.py main_psrdict), profiles loaded on use
CONFIG1 = {
    "fcent": 1380.0, "bandwidth": 400.0, "sample_rate": 0.4096,
    "Nchan": 64, "fold": True, "sublen": 60.0, "tobs": 1200.0,
    "period": 0.005, "Smean": 0.009, "name": "J1713+0747", "dm": 15.9,
    "tscope_name": "TestScope", "aperture": 100.0, "area": 5500.0,
    "Tsys": 35.0, "system_name": "TestSys", "rcvr_fcent": 1380.0,
    "rcvr_bw": 400.0, "rcvr_name": "TestRCVR", "backend_samprate": 12.5,
    "backend_name": "TestBack", "seed": 0,
}
# bench.py build_mc_study's geometry and priors (chip_smoke.py MC_BENCH)
MC_BENCH = dict(fcent=1380.0, bandwidth=400.0, sample_rate=0.1024, Nchan=64,
                sublen=2.0, fold=True, period=0.005, Smean=0.009,
                profiles=[0.5, 0.05, 1.0], tobs=16.0, name="BENCH", dm=15.9,
                aperture=100.0, area=5500.0, Tsys=35.0,
                tscope_name="TestScope", system_name="TestSys",
                rcvr_fcent=1380.0, rcvr_bw=400.0, rcvr_name="TestRCVR",
                backend_samprate=12.5, backend_name="TestBack", seed=0)
MC_PRIORS = {"dm": {"dist": "uniform", "lo": 9.0, "hi": 11.0},
             "noise_scale": {"dist": "loguniform", "lo": 0.5, "hi": 2.0}}
MC_BENCH_PRIORS = {"dm": {"dist": "uniform", "lo": 10.0, "hi": 20.0},
                   "noise_scale": {"dist": "loguniform", "lo": 0.5,
                                   "hi": 2.0}}
DATASET_SPEC = {
    "nchan": 4, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "tobs_s": 0.02, "period_s": 0.005,
    "smean_jy": 0.05, "seed": 11, "n_records": 8, "shards": 2,
    "dm": 10.0, "scenarios": ["rfi"], "rfi_imp_prob": 0.25,
    "rfi_nb_prob": 0.25,
    "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}},
}
# bench.py _DATASET_BENCH_SPEC cut to 128 records (chip_smoke.py phase 20)
DATASET_BENCH = {
    "nchan": 4, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "tobs_s": 0.1, "period_s": 0.005,
    "smean_jy": 0.05, "seed": 3, "n_records": 128, "shards": 4,
    "dm": 10.0, "scenarios": ["rfi", "single_pulse"],
    "rfi_imp_prob": 0.25, "rfi_nb_prob": 0.25,
    "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0},
               "rfi_imp_snr": {"dist": "loguniform", "lo": 1.0,
                               "hi": 50.0}},
}
SERVE_SPEC = {
    "nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
    "period_s": 0.005, "smean_jy": 0.05, "seed": 3, "dm": 10.0,
}
# chip_smoke.py phase 17's spec at BASELINE config 1's width
SERVE_CONFIG1 = {"nchan": 64, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
                 "sample_rate_mhz": 0.4096, "sublen_s": 60.0,
                 "tobs_s": 1200.0, "period_s": 0.005, "smean_jy": 0.009,
                 "seed": 0, "dm": 15.9}
ALL_FAMILIES = ("ensemble", "mc", "dataset", "serve")
LEADER_ONLY = ("serve_profiles",)   # a serving follower answers no request
SERVE_WIDTHS = (1, 8)
SERVE_REQUESTS = 3
BENCH_CHUNKS = 4
POD_ENV = ("PSS_POD_COORDINATOR", "PSS_POD_NUM_PROCESSES",
           "PSS_POD_PROCESS_ID", "PSS_POD_CHANNEL_PORT")


def sha(*arrays):
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def psrdict(geometry):
    if geometry == "tiny":
        return dict(TINY)
    import numpy as np

    from psrsigsim_torch.data import data_path

    d = dict(CONFIG1, tempfile=TEMPLATE)
    d["profiles"] = np.load(data_path("J1713+0747_profile.npy"))
    return d


# ---------------------------------------------------------------------------
# worker: one pod process
# ---------------------------------------------------------------------------


def _launches():
    """Each kernel wrapper's launches in this process (zeroed per leg)."""
    from psrsigsim_torch.ops import digest, fold_quantize, gamma, rng_hw

    return {"rng_field": rng_hw.rng_field.launches,
            "rng_flat_field": rng_hw.rng_flat_field.launches,
            "fold_quantize": fold_quantize.fold_quantize.launches,
            "packed_digest": digest.packed_digest.launches,
            "gamma_field": gamma.gamma_field.launches}


def _zero_launches():
    from psrsigsim_torch.ops import digest, fold_quantize, gamma, rng_hw

    for w in (rng_hw.rng_field, rng_hw.rng_flat_field,
              fold_quantize.fold_quantize, digest.packed_digest,
              gamma.gamma_field):
        w.launches = 0


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _start(args):
    """A worker's device, with the host's thread count fixed: above
    torch's 32,768-element grain a host op's rounding can follow the
    thread split, and two processes' thread pools would compete for the
    same cores."""
    import torch

    from psrsigsim_torch.utils.device import resolve_device

    torch.set_num_threads(args.threads)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _mesh(args, device):
    from psrsigsim_torch.parallel import make_mesh

    if args.devices_per_host == 0:
        return None   # host count 0: the mesh-free path
    return make_mesh(None, [device] * args.devices_per_host)


def _leg(out, name, device, fn):
    """Run one family leg: its launches, exchanges and seconds."""
    from psrsigsim_torch.runtime.dist import exchange_stats

    _sync(device)
    _zero_launches()
    exchange_stats(reset=True)
    t0 = time.perf_counter()
    hashes = fn()
    _sync(device)
    out["timings"][name] = round(time.perf_counter() - t0, 4)
    out["launches"][name] = _launches()
    out["exchange"][name] = exchange_stats()
    out["hashes"].update(hashes)


def run_worker(args):
    import faulthandler
    import signal as _signal

    faulthandler.register(_signal.SIGUSR1, all_threads=True)
    from psrsigsim_torch.runtime.dist import (device_get, init_pod,
                                              pod_barrier, shutdown_pod)

    info = init_pod()
    from psrsigsim_torch.simulate import Simulation

    device = _start(args)
    families = args.families.split(",")
    mesh = _mesh(args, device)
    out = {"process_id": info.process_id,
           "num_processes": info.num_processes, "is_pod": info.is_pod,
           "positions": None if mesh is None else mesh.size,
           "hashes": {}, "timings": {}, "launches": {}, "exchange": {}}

    sim = Simulation(psrdict=psrdict(args.geometry), device=device)
    sim.init_all()

    if "ensemble" in families:
        ens = sim.to_ensemble(mesh=mesh)
        if args.warm:
            # cuFFT plans, the allocator and the exchange's buffers, untimed
            ens.run_quantized(args.ens_obs, seed=args.seed)

        def quantized():
            d, s, o = (t.cpu().numpy() for t in
                       ens.run_quantized(args.ens_obs, seed=args.seed))
            if args.save and info.is_leader:
                import numpy as np

                np.savez(args.save, data=d, scl=s, offs=o)
            return {"ensemble_quantized": sha(d, s, o)}

        def floats():
            return {"ensemble_float": sha(device_get(
                ens.run(args.ens_float, seed=args.seed)))}

        def chunks():
            blocks = [b for _, b in ens.iter_chunks(
                args.ens_obs, chunk_size=args.ens_chunk, seed=args.seed,
                quantized=True, byte_order="big", finite_mask=True)]
            return {"ensemble_chunks": sha(*[a for b in blocks for a in b])}

        _leg(out, "run_quantized", device, quantized)
        _leg(out, "run", device, floats)
        if args.ens_chunk:
            _leg(out, "iter_chunks", device, chunks)

    if "mc" in families:
        from psrsigsim_torch.mc import MonteCarloStudy

        if args.mc_geometry == "bench":
            msim = Simulation(psrdict=dict(MC_BENCH), device=device)
            msim.init_all()
            priors = MC_BENCH_PRIORS
        else:
            msim, priors = sim, MC_PRIORS

        def study():
            st = MonteCarloStudy.from_simulation(msim, priors, seed=args.seed,
                                                 mesh=_mesh(args, device))
            res = st.run(args.mc_trials, chunk_size=args.mc_chunk,
                         out_dir=None)
            return {"mc_metrics": sha(res.metrics),
                    "mc_hist": sha(res.hist)}

        _leg(out, "mc", device, study)

    if "dataset" in families:
        from psrsigsim_torch.datasets.spec import canonicalize

        spec = DATASET_BENCH if args.dataset_out else DATASET_SPEC

        def records():
            from psrsigsim_torch.datasets.sampler import RecordSampler

            sampler = RecordSampler(canonicalize(dict(spec)),
                                    mesh=_mesh(args, device), device=device)
            host = device_get(sampler.dispatch(0, sampler.chunk_width(8)))
            return {"dataset_records": sha(*host)}

        def corpus():
            from psrsigsim_torch.datasets import DatasetFactory

            corpus_dir = os.path.join(args.dataset_out, args.run_tag)
            fac = DatasetFactory(dict(spec), mesh=_mesh(args, device),
                                 device=device)
            fac.run(corpus_dir, chunk_size=64, resume=False)
            pod_barrier("corpus-written")
            h = hashlib.sha256()
            for name in sorted(os.listdir(corpus_dir)):
                if name.startswith("shard-") and name.endswith(".records"):
                    with open(os.path.join(corpus_dir, name), "rb") as fh:
                        h.update(fh.read())
            return {"dataset_corpus": h.hexdigest()}

        _leg(out, "dataset", device,
             corpus if args.dataset_out else records)

    if "serve" in families:
        widths = SERVE_WIDTHS
        spec0 = SERVE_CONFIG1 if args.geometry == "config1" else SERVE_SPEC

        def serve():
            if info.is_pod and not info.is_leader:
                from psrsigsim_torch.serve.pod import pod_serve_follower

                pod_serve_follower(widths, device=device)
                return {}
            from psrsigsim_torch.serve import SimulationService

            svc = SimulationService(cache_dir=None, widths=widths,
                                    batch_window_s=0.001, device=device)
            try:
                rids = []
                for i in range(SERVE_REQUESTS):
                    spec = dict(spec0, seed=300 + i, dm=spec0["dm"] + 0.25 * i)
                    rids.append(svc.submit(spec, deadline_s=600.0)[0])
                shas = [sha(svc.result(rid, timeout=600.0)) for rid in rids]
            finally:
                svc.close()   # a pod leader also ends the followers' stream
            return {"serve_profiles": sha("|".join(shas).encode())}

        _leg(out, "serve", device, serve)

    pod_barrier("worker-done")
    shutdown_pod()
    print(json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def _env(n_hosts, pid, ports, extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for k in POD_ENV:
        env.pop(k, None)
    if n_hosts > 1:
        env["PSS_POD_COORDINATOR"] = f"127.0.0.1:{ports[0]}"
        env["PSS_POD_NUM_PROCESSES"] = str(n_hosts)
        env["PSS_POD_PROCESS_ID"] = str(pid)
        env["PSS_POD_CHANNEL_PORT"] = str(ports[1])
    env.update(extra or {})
    return env


def spawn(n_hosts, argv, timeout, extra_env=None, follower_argv=(),
          ends=None):
    """N processes of this script with ``argv`` forming one pod (one
    process, solo, for ``n_hosts`` <= 1); the followers get
    ``follower_argv`` too.  Returns ``[(returncode, stdout, stderr),
    ...]`` leader first; every process is bounded by ``timeout`` seconds
    (all are killed when one overruns); a list passed as ``ends`` receives
    each process's exit time (``time.monotonic()``)."""
    import threading

    from psrsigsim_torch.runtime.dist import free_ports

    ports = free_ports(2)
    procs = []
    for pid in range(max(1, n_hosts)):
        cmd = [sys.executable, os.path.abspath(__file__)] + list(argv)
        if pid > 0:
            cmd += list(follower_argv)
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(n_hosts, pid, ports, extra_env)))
    # each process read on a thread of its own, so exit times are exact
    out = [None] * len(procs)
    t_end = [None] * len(procs)

    def _read(k, p):
        o, e = p.communicate()
        t_end[k] = time.monotonic()
        out[k] = (p.returncode, o, e)

    threads = [threading.Thread(target=_read, args=(k, p), daemon=True)
               for k, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.poll() is None:
            p.kill()
    for t in threads:
        t.join()
    if ends is not None:
        ends.extend(t_end)
    return out


def _worker_argv(args, n_hosts, run_tag):
    per = 0 if n_hosts == 0 else args.total_devices // n_hosts
    argv = ["--mode", "worker", "--families", args.families,
            "--threads", str(args.threads), "--seed", str(args.seed),
            "--devices-per-host", str(per), "--device", args.device,
            "--geometry", args.geometry, "--ens-obs", str(args.ens_obs),
            "--ens-float", str(args.ens_float),
            "--ens-chunk", str(args.ens_chunk),
            "--mc-geometry", args.mc_geometry,
            "--mc-trials", str(args.mc_trials),
            "--mc-chunk", str(args.mc_chunk),
            "--run-tag", run_tag]
    if args.save:
        argv += ["--save", f"{args.save}.hosts{n_hosts}.npz"]
    if args.warm:
        argv += ["--warm"]
    if args.dataset_out:
        argv += ["--dataset-out", args.dataset_out]
    return argv


def run_pod(args, n_hosts, run_tag):
    """One pod's worker verdicts, leader first (raises on a failed
    process, with its stderr)."""
    res = spawn(n_hosts, _worker_argv(args, n_hosts, run_tag),
                args.timeout)
    outs = []
    for rc, o, e in res:
        if rc != 0:
            raise RuntimeError(f"pod worker ({n_hosts} hosts) rc={rc}: "
                               f"{e[-3000:]}")
        outs.append(json.loads(o.strip().splitlines()[-1]))
    return outs


def merge_ranks(outs, tag):
    """One pod's hashes from its workers' verdicts (leader first), and the
    mismatches among its ranks: every rank reports every key but the
    leader-only ones, and all ranks' hashes of a key agree.  A mismatch is
    named ``<tag>/rank0-vs-rank<r>/<key>``."""
    lead = outs[0]["hashes"]
    mism = {}
    for o in outs[1:]:
        r = o["process_id"]
        for k in (set(lead) | set(o["hashes"])) - set(LEADER_ONLY):
            if lead.get(k) != o["hashes"].get(k):
                mism[f"{tag}/rank0-vs-rank{r}/{k}"] = [lead.get(k),
                                                       o["hashes"].get(k)]
        for k in LEADER_ONLY:
            if k in o["hashes"]:
                mism[f"{tag}/rank{r}/{k}"] = [None, o["hashes"][k]]
    return dict(lead), mism


def run_identity(args):
    hosts = [int(h) for h in args.hosts.split(",")]
    for h in hosts:
        if h and args.total_devices % h:
            raise SystemExit(f"--total-devices {args.total_devices} must "
                             f"divide by host count {h}")
    runs, workers, mism = {}, {}, {}
    for h in hosts:
        outs = run_pod(args, h, f"hosts{h}")
        runs[h], rank_mism = merge_ranks(outs, f"hosts{h}")
        mism.update(rank_mism)
        workers[h] = outs
    base = runs[hosts[0]]
    for h in hosts[1:]:
        for k in set(base) | set(runs[h]):
            if base.get(k) != runs[h].get(k):
                mism[f"hosts{h}/{k}"] = [base.get(k), runs[h].get(k)]
    verdict = {"mode": "identity", "hosts": hosts,
               "total_devices": args.total_devices,
               "families": args.families.split(","), "hashes": base,
               "mismatches": mism, "workers": workers,
               "ok": not mism and all(len(r) == len(base)
                                      for r in runs.values())}
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


def _build_census():
    from psrsigsim_torch.ops import _build

    d = _build._BUILD_DIR
    if not d.exists():
        return []
    return sorted(p.name for p in d.iterdir() if p.is_file())


def run_warm(args):
    """A second pod (fresh processes: "a host joins") over the same
    checkout builds nothing: no kernel compile in any process and no new
    file in the build directory."""
    n = int(args.hosts.split(",")[0])
    cold = run_pod(args, n, "cold")
    files_cold = _build_census()
    warm = run_pod(args, n, "warm")
    files_warm = _build_census()
    new = sorted(set(files_warm) - set(files_cold))
    hashes_cold, mism = merge_ranks(cold, "cold")
    hashes_warm, mism_warm = merge_ranks(warm, "warm")
    mism.update(mism_warm)
    verdict = {"mode": "warm", "hosts": n,
               "build_files_cold": len(files_cold),
               "new_build_files_on_join": new,
               "hashes_equal": hashes_cold == hashes_warm,
               "mismatches": mism,
               "timings_cold": cold[0]["timings"],
               "timings_warm": warm[0]["timings"]}
    verdict["ok"] = not new and not mism and verdict["hashes_equal"]
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


def run_bench_worker(args):
    from psrsigsim_torch.runtime.dist import (exchange_stats, init_pod,
                                              pod_barrier, shutdown_pod)

    info = init_pod()
    from psrsigsim_torch.simulate import Simulation

    device = _start(args)
    sim = Simulation(psrdict=psrdict(args.geometry), device=device)
    sim.init_all()
    ens = sim.to_ensemble(mesh=_mesh(args, device))
    ens.run_quantized(args.ens_obs, seed=args.seed)   # warm: plans, allocator
    pod_barrier("bench-warm")
    _sync(device)
    exchange_stats(reset=True)
    t0 = time.perf_counter()
    for k in range(BENCH_CHUNKS):
        ens.run_quantized(args.ens_obs, seed=args.seed + k)
    _sync(device)
    dt = time.perf_counter() - t0
    pod_barrier("bench-done")
    shutdown_pod()
    n = BENCH_CHUNKS * args.ens_obs
    print(json.dumps({"process_id": info.process_id, "obs": n,
                      "wall_s": round(dt, 4),
                      "obs_per_sec": round(n / dt, 2),
                      "exchange": exchange_stats()}), flush=True)
    return 0


def run_bench(args):
    hosts = [int(h) for h in args.hosts.split(",")]
    levels = {}
    for h in hosts:
        argv = ["--mode", "bench-worker", "--device", args.device,
                "--threads", str(args.threads), "--seed", str(args.seed),
                "--geometry", args.geometry,
                "--devices-per-host", str(args.devices_per_host),
                "--ens-obs", str(args.ens_obs)]
        res = spawn(h, argv, args.timeout)
        outs = []
        for rc, o, e in res:
            if rc != 0:
                raise RuntimeError(f"bench worker rc={rc}: {e[-3000:]}")
            outs.append(json.loads(o.strip().splitlines()[-1]))
        levels[str(h)] = {
            "obs_per_sec": round(outs[0]["obs"]
                                 / max(o["wall_s"] for o in outs), 2),
            "workers": outs}
    print(json.dumps({"mode": "bench", "hosts": hosts, "levels": levels,
                      "ok": True}), flush=True)
    return 0


def run_export_worker(args):
    """One process of the export program group (:func:`spawn_export_group`
    spawns them)."""
    from psrsigsim_torch.runtime.dist import init_pod, shutdown_pod

    info = init_pod()
    from psrsigsim_torch.runtime import FaultPlan, supervised_export
    from psrsigsim_torch.simulate import Simulation

    device = _start(args)
    plan = None
    if args.plan:
        with open(args.plan) as fh:
            spec = json.load(fh)
        plan = FaultPlan(spec["scratch_dir"], spec["spec"])
    sim = Simulation(psrdict=psrdict(args.geometry), device=device)
    sim.init_all()
    ens = sim.to_ensemble(mesh=_mesh(args, device))
    _zero_launches()
    if info.is_pod and not info.is_leader:
        from psrsigsim_torch.io.export import pod_export_follower
        from psrsigsim_torch.runtime.faults import crash_process

        chunks_done = [0]

        def _progress(done, total):
            # pod.kill: a host dying after its n-th chunk
            chunks_done[0] += 1
            if plan is not None:
                cfg = plan.config("pod.kill")
                if cfg is not None and chunks_done[0] >= int(
                        cfg.get("after_chunks", 1)):
                    if plan.fire("pod.kill",
                                 token=f"chunk={chunks_done[0]}"):
                        crash_process()

        pod_export_follower(ens, args.n_obs, args.out_dir, seed=args.seed,
                            chunk_size=args.chunk_size, resume=True,
                            verify=True,
                            pipeline_depth=args.pipeline_depth,
                            progress=_progress)
        result = {"pod_follower": info.process_id}
    else:
        res = supervised_export(
            ens, args.n_obs, args.out_dir, TEMPLATE, ens.pulsar,
            seed=args.seed, chunk_size=args.chunk_size, writers=1,
            faults=plan, pipeline_depth=args.pipeline_depth,
            resume="verify")
        result = {"paths": len(res.paths), "quarantined": res.quarantined}
    result["launches"] = _launches()
    shutdown_pod()
    print(json.dumps(result), flush=True)
    return 0


def spawn_export_group(out_dir, n_hosts, n_obs, chunk, follower_plan=None,
                       timeout=540, device=None, geometry="tiny",
                       devices_per_host=None, pipeline_depth=2, threads=1,
                       seed=SEED, ends=None):
    """One export program group (``resume="verify"``): process 0 runs the
    supervised export, the followers mirror its chunk loop;
    ``follower_plan`` (a FaultPlan JSON) arms the followers.  Two mesh
    positions in all by default (one a process at 2 hosts).  ``device``
    None is the card (raises without one).  As :func:`spawn`, leader
    first."""
    device = _resolve_device_name(device)
    per = devices_per_host or max(1, 2 // max(1, n_hosts))
    argv = ["--mode", "export-worker", "--out-dir", out_dir,
            "--n-obs", str(n_obs), "--chunk-size", str(chunk),
            "--device", device, "--geometry", geometry,
            "--devices-per-host", str(per),
            "--pipeline-depth", str(pipeline_depth),
            "--threads", str(threads), "--seed", str(seed)]
    return spawn(n_hosts, argv, timeout, ends=ends,
                 follower_argv=(() if follower_plan is None
                                else ("--plan", follower_plan)))


def _resolve_device_name(device):
    """``device`` as the workers' ``--device`` word: None is the card, and
    raises when there is none, before any process is spawned."""
    from psrsigsim_torch.utils.device import resolve_device

    return str(resolve_device(device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", required=True,
                    choices=["worker", "identity", "warm", "bench",
                             "bench-worker", "export-worker"])
    ap.add_argument("--hosts", default="1,2",
                    help="comma-separated host counts (0: no mesh; warm: "
                         "the first)")
    ap.add_argument("--total-devices", type=int, default=4,
                    help="the CONSTANT global count of mesh positions")
    ap.add_argument("--devices-per-host", type=int, default=1)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--warm", action="store_true",
                    help="identity: one untimed run_quantized first")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch's host thread count in every process")
    ap.add_argument("--device", default=None,
                    help="each process's device (default: the CUDA card; "
                         "cpu asks for the host)")
    ap.add_argument("--geometry", default="tiny",
                    choices=["tiny", "config1"])
    ap.add_argument("--families", default=",".join(ALL_FAMILIES))
    ap.add_argument("--ens-obs", type=int, default=8)
    ap.add_argument("--ens-float", type=int, default=8)
    ap.add_argument("--ens-chunk", type=int, default=4,
                    help="iter_chunks' chunk size (0 skips that leg)")
    ap.add_argument("--mc-geometry", default="tiny",
                    choices=["tiny", "bench"])
    ap.add_argument("--mc-trials", type=int, default=16)
    ap.add_argument("--mc-chunk", type=int, default=8)
    ap.add_argument("--dataset-out", default=None,
                    help="write a whole corpus (bench.py's dataset spec "
                         "cut to 128 records) under this directory")
    ap.add_argument("--run-tag", default="run")
    ap.add_argument("--save", default=None,
                    help="identity: the leader of each host count saves "
                         "run_quantized's (data, scl, offs) to "
                         "SAVE.hosts<N>.npz")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--n-obs", type=int, default=12)
    ap.add_argument("--chunk-size", type=int, default=4)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--plan", default=None)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds each spawned pod may take")
    args = ap.parse_args(argv)
    args.device = _resolve_device_name(args.device)
    modes = {"worker": run_worker, "identity": run_identity,
             "warm": run_warm, "bench": run_bench,
             "bench-worker": run_bench_worker,
             "export-worker": run_export_worker}
    return modes[args.mode](args)


if __name__ == "__main__":
    raise SystemExit(main())
