"""``python -m psrsigsim_torch.serve`` — the simulation serving daemon
(counterpart: ``python -m psrsigsim_tpu.serve``).

Starts the dynamic-batching request engine behind an HTTP JSON API and
prints ONE machine-parseable ready line to stdout (``{"ready": true,
"port": ...}``) once the socket is bound and warmup (if any) finished —
the contract tests and shell scripts wait on.  The buckets run on the
CUDA card (the server refuses to start without one); ``--device cpu``
runs them on the host (the port's one flag beyond the JAX package's).  ``--frontend`` selects the connection layer:
``threaded`` (stdlib ``ThreadingHTTPServer``, one thread per
connection — the fallback) or ``aio`` (the selectors event loop,
:mod:`psrsigsim_torch.serve.aio` — thousands of keep-alive connections
on one loop; the C10k front end).  Responses are byte-identical across
front ends (shared endpoint semantics in
:mod:`psrsigsim_torch.serve.http`).

Example::

    python -m psrsigsim_torch.serve --port 8641 --cache-dir /var/tmp/pss \
        --warmup warmspec.json
    curl -s localhost:8641/simulate -d @spec.json
    curl -s localhost:8641/metrics

``--warmup`` takes a JSON file holding one spec object or a list of
them; each geometry is staged and run once for every bucket width before
the ready line prints, so first-request latency is bounded.
``--compile-cache-dir`` is accepted for the JAX package's command lines;
the port compiles nothing, so it enables nothing.

A pod serving group (:mod:`psrsigsim_torch.serve.pod`) is one leader and
``--pod-num-hosts - 1`` followers, each started with the same
``--pod-num-hosts``/``--pod-coordinator``/``--pod-channel-port`` and its
own ``--pod-host``; the followers add ``--pod-follower``, print a ready
line of their own and serve no HTTP::

    python -m psrsigsim_torch.serve --port 0 --pod-num-hosts 2 --pod-host 0 \
        --pod-coordinator 127.0.0.1:29500 --device cpu &
    python -m psrsigsim_torch.serve --pod-num-hosts 2 --pod-host 1 \
        --pod-coordinator 127.0.0.1:29500 --pod-follower --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m psrsigsim_torch.serve",
        description="dynamic-batching pulsar-simulation HTTP server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8641,
                    help="0 picks a free port (printed in the ready line)")
    ap.add_argument("--cache-dir", default=None,
                    help="content-addressed result cache root; omit to "
                         "disable caching")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="accepted for the JAX package's command lines; "
                         "the port compiles nothing, so nothing is cached")
    ap.add_argument("--device", default=None,
                    help="where the buckets run (default: the CUDA card, "
                         "refusing to start without one; 'cpu' for the "
                         "host)")
    ap.add_argument("--widths", default="1,8,32",
                    help="comma-separated bucket widths")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--frontend", default="threaded",
                    choices=["threaded", "aio"],
                    help="connection-handling layer: 'threaded' (stdlib "
                         "thread-per-connection, the fallback) or 'aio' "
                         "(selectors event loop — the C10k front end; "
                         "PSS_AIO_MAX_CONNS / PSS_AIO_WORKERS tune it)")
    ap.add_argument("--hot-mb", type=float, default=None,
                    help="in-memory hot result tier budget in MiB "
                         "(default: PSS_CACHE_HOT_MB or 256; 0 disables)")
    ap.add_argument("--aio-max-conns", type=int, default=None,
                    help="aio front end open-connection bound (default: "
                         "PSS_AIO_MAX_CONNS or 10000)")
    ap.add_argument("--warmup", default=None,
                    help="JSON file: one spec (or a list) whose geometries "
                         "are staged before the ready line")
    ap.add_argument("--replica-id", type=int, default=None,
                    help="fleet replica identity (reported in /healthz "
                         "and the ready line; ReplicaFleet assigns it)")
    ap.add_argument("--verify-cache", action="store_true",
                    help="re-hash every cached artifact against the "
                         "journal on startup (the relaunch-after-crash "
                         "mode)")
    ap.add_argument("--fault-plan", default=None,
                    help="TESTS ONLY: FaultPlan JSON "
                         '({"scratch_dir", "spec"}) arming serve.* points')
    ap.add_argument("--pod-num-hosts", type=int, default=None,
                    help="processes in this replica's pod group (> 1 joins "
                         "a pod; runtime/dist.py)")
    ap.add_argument("--pod-host", type=int, default=None,
                    help="this process's pod process id (0 = leader, "
                         "which owns the HTTP endpoint)")
    ap.add_argument("--pod-coordinator", default=None,
                    help="host:port of the pod coordinator (process 0)")
    ap.add_argument("--pod-channel-port", type=int, default=None,
                    help="leader's host-side control-channel port "
                         "(default: coordinator port + 1)")
    ap.add_argument("--pod-follower", action="store_true",
                    help="run as a follower: no HTTP socket — join the "
                         "leader's mesh and obey its program stream")
    args = ap.parse_args(argv)

    # keep stdout clean for the one-line ready protocol: the OO layer's
    # reference-parity warnings print to stdout during warmup
    real_stdout = sys.stdout
    sys.stdout = sys.stderr

    pod = bool(args.pod_num_hosts and args.pod_num_hosts > 1)
    if args.pod_follower and not pod:
        raise ValueError("--pod-follower needs a pod: --pod-num-hosts > 1, "
                         "--pod-host and --pod-coordinator")
    if pod:
        from ..runtime.dist import init_pod

        init_pod(coordinator=args.pod_coordinator,
                 num_processes=args.pod_num_hosts,
                 process_id=args.pod_host,
                 channel_port=args.pod_channel_port)

    widths = tuple(int(w) for w in args.widths.split(","))
    if args.pod_follower:
        # a follower's whole life: the ready line the spawner waits on,
        # then the leader's register/exec stream until its clean shutdown
        # (a leader's DEATH ends this process through the channel
        # watchdog instead)
        from ..runtime.dist import shutdown_pod
        from ..utils.device import resolve_device
        from .pod import pod_serve_follower

        device = resolve_device(args.device)
        print(json.dumps({"ready": True, "pod_follower": args.pod_host,
                          "pod_num_hosts": args.pod_num_hosts}),
              file=real_stdout, flush=True)
        pod_serve_follower(widths, compile_cache_dir=args.compile_cache_dir,
                           device=device)
        shutdown_pod()
        return 0

    from .http import make_server, run_server
    from .service import SimulationService

    faults = None
    if args.fault_plan:
        from ..runtime import FaultPlan

        with open(args.fault_plan) as f:
            plan = json.load(f)
        faults = FaultPlan(plan["scratch_dir"], plan["spec"])

    service = SimulationService(
        cache_dir=args.cache_dir, widths=widths, max_queue=args.max_queue,
        batch_window_s=args.batch_window_ms / 1e3,
        verify_cache=args.verify_cache, faults=faults,
        compile_cache_dir=args.compile_cache_dir,
        replica_id=args.replica_id, device=args.device,
        cache_hot_bytes=(None if args.hot_mb is None
                         else int(args.hot_mb * (1 << 20))))

    if args.warmup:
        with open(args.warmup) as f:
            specs = json.load(f)
        for spec in specs if isinstance(specs, list) else [specs]:
            service.warmup(spec)

    if args.frontend == "aio":
        from .aio import AioHTTPServer

        srv = AioHTTPServer(args.host, args.port, service=service,
                            max_conns=args.aio_max_conns)
    else:
        srv = make_server(args.host, args.port, service=service)

    def _ready(s):
        print(json.dumps({"ready": True, "host": args.host,
                          "port": s.server_port,
                          "replica_id": args.replica_id,
                          "frontend": args.frontend,
                          "cache": bool(args.cache_dir)}),
              file=real_stdout, flush=True)

    run_server(srv, ready_cb=_ready)
    if pod:
        # the leader's drain (service.close inside run_server's shutdown)
        # already ended the followers' stream; BYE the watchdog so this
        # exit is not taken for a death
        from ..runtime.dist import shutdown_pod

        shutdown_pod()
    return 0


if __name__ == "__main__":
    sys.exit(main())
