"""Supervised, ELASTIC replica fleet: N serving processes over one
shared cache, scaled by load (counterpart: psrsigsim_tpu/serve/fleet.py).

One HTTP process is host-bound long before the card is busy; N replica
processes over one shared cache are the horizontal answer.  A
:class:`ReplicaFleet`

* spawns replicas as ``python -m psrsigsim_torch.serve`` subprocesses over
  ONE cache dir, on the CUDA card unless given a ``device`` (forwarded as
  ``--device``; several replicas share one card, each with its own CUDA
  context) — safe because :class:`~psrsigsim_torch.serve.ResultCache`
  commits with cross-process single-writer discipline (claim markers +
  flock-guarded journal appends), so replicas share committed results
  and device work is at-most-once per spec fleet-wide;
* supervises each replica with a
  :class:`~psrsigsim_torch.runtime.ProcessSupervisor`: a dead replica is
  restarted under a jittered
  :class:`~psrsigsim_torch.runtime.RetryPolicy` (no respawn lockstep, no
  unbounded flapping), re-binds its port, and re-enters routing at a new
  endpoint *generation*;
* health-checks every replica via the grown ``/healthz`` (replica id,
  uptime, queue depth + bound, request p95, device calls, per-program
  compile counts) and SIGKILLs one that stops answering, handing it
  back to the supervisor;
* **autoscales** (``autoscale=True``): a control loop reads the load
  signals the health poll already collects — total queue depth as a
  fraction of total queue capacity, and the worst per-replica request
  p95 — and spawns or retires replicas between ``min_replicas`` and
  ``max_replicas``.  Hysteresis is structural: the scale-up threshold
  is strictly above the scale-down threshold, and separate cooldown
  windows (down's longer than up's) stop the loop from flapping on a
  bursty signal.  Scale-UP costs one replica start (import, CUDA
  context, staging each bucket width once: nothing is compiled) and HRW
  routing absorbs the membership change (only the new replica's key
  range moves).  Scale-DOWN is lossless by
  construction: the victim leaves routing FIRST, then gets the same
  SIGTERM graceful drain an operator shutdown uses, so every in-flight
  request finishes before the process exits;
* degrades gracefully below quorum: the router stops admitting (the
  explicit-backpressure path, not a hang) until enough replicas return;
* propagates drain fleet-wide: :meth:`drain` sends every replica the
  SIGTERM graceful-drain signal the single-server path already honors,
  and :meth:`install_sigterm_drain` wires the fleet process's own
  SIGTERM to it.

Autoscaler knobs (constructor args; env vars are the deployment-time
defaults): ``PSS_FLEET_MIN_REPLICAS`` / ``PSS_FLEET_MAX_REPLICAS``
bound the fleet, ``PSS_FLEET_SCALE_UP_FRAC`` / ``PSS_FLEET_SCALE_DOWN_FRAC``
are the queue-fraction thresholds (up must exceed down),
``PSS_FLEET_SCALE_COOLDOWN_S`` the base cooldown (scale-down waits 2x).

A replica is one process: the JAX package's multi-host program groups
(``group_hosts > 1``) raise ``NotImplementedError`` (pods are not
ported).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from ..runtime.retry import RetryPolicy
from ..runtime.supervisor import ProcessSupervisor

__all__ = ["ReplicaFleet"]


def _child_env(env):
    """The replicas' environment: ``env`` (default: this process's) with
    the directory that holds this package first on ``PYTHONPATH``, so
    ``python -m psrsigsim_torch.serve`` imports the parent's code."""
    out = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [p for p in out.get("PYTHONPATH", "").split(os.pathsep) if p]
    out["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in paths if p != root])
    return out


def _env_num(name, default, cast=float):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return cast(default)


class ReplicaFleet:
    """Spawn, route-track, health-check, restart, and SCALE serving
    replicas.

    Parameters
    ----------
    n_replicas : int
        Initial fleet size.  Each replica is ``python -m
        psrsigsim_torch.serve --port 0`` with a unique ``--replica-id``.
    cache_dir : str
        THE shared content-addressed result cache root.
    widths : tuple of int
        Bucket widths forwarded to every replica.
    warmup_path : str, optional
        Warmup-spec JSON forwarded to every replica (``--warmup``), so
        each comes up with every bucket width staged and run once before
        its ready line, before it takes traffic.
    verify_cache : bool
        Relaunch replicas with ``--verify-cache`` (the shared dir may
        hold a crashed peer's artifacts — verify, don't trust).
    fault_plan_path : str, optional
        FaultPlan JSON forwarded to every replica (tests only).
    policy : RetryPolicy, optional
        Per-replica restart budget (default: 5 attempts, jittered).
    quorum : int, optional
        Healthy-replica floor below which the fleet reports degraded
        (default: strict majority of the INITIAL size; elastic fleets
        usually pass ``quorum=min_replicas``).
    health_interval_s / health_fail_after :
        ``/healthz`` poll period and the consecutive-failure count after
        which an unresponsive replica is SIGKILLed for restart.
    ready_timeout_s : float
        How long one replica may take to print its ready line (covers a
        cold ``import torch``, the CUDA context and the warmup on the
        card).
    log_dir : str, optional
        Per-replica stderr logs (``replica<i>.log``); default discards.
    compile_cache_dir : str, optional
        Forwarded to every replica (``--compile-cache-dir``) for the JAX
        package's callers; the port compiles nothing, so it caches
        nothing.
    device : str, optional
        Where every replica runs its buckets, forwarded as ``--device``.
        ``None`` means the CUDA card: the constructor raises when there
        is none, before any process is spawned.
    env : dict, optional
        The replicas' environment (default: this process's); the
        directory holding this package is put first on its
        ``PYTHONPATH``, so every replica runs the parent's code.
    autoscale : bool
        Enable the scaling control loop (module docstring).
    min_replicas / max_replicas : int, optional
        Elastic bounds (defaults: env or ``n_replicas`` for both, i.e.
        a fixed fleet unless widened).
    scale_up_queue_frac / scale_down_queue_frac : float
        Queue-fraction thresholds (total depth / total capacity).  The
        up threshold must be strictly greater than the down threshold —
        the hysteresis band that stops flapping.
    scale_up_p95_s : float, optional
        Additional scale-up trigger: worst per-replica request p95
        above this (None disables the latency signal).
    scale_interval_s / scale_up_cooldown_s / scale_down_cooldown_s :
        Control-loop period and the per-direction cooldowns (down
        should exceed up: shedding capacity is the riskier direction).
    """

    def __init__(self, n_replicas, cache_dir, *, widths=(1, 8),
                 max_queue=64, batch_window_ms=2.0, warmup_path=None,
                 verify_cache=True, fault_plan_path=None, policy=None,
                 quorum=None, health_interval_s=0.5, health_fail_after=3,
                 ready_timeout_s=300.0, log_dir=None, env=None,
                 host="127.0.0.1", compile_cache_dir=None,
                 autoscale=False, min_replicas=None, max_replicas=None,
                 scale_up_queue_frac=None, scale_down_queue_frac=None,
                 scale_up_p95_s=None, scale_interval_s=0.5,
                 scale_up_cooldown_s=None, scale_down_cooldown_s=None,
                 frontend="threaded", hot_mb=None, group_hosts=1,
                 device=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if group_hosts < 1:
            raise ValueError("group_hosts must be >= 1")
        if group_hosts > 1:
            raise NotImplementedError(
                "multi-host replica groups are not ported (ROADMAP Queue 1 "
                "item 4: meshes, pods and sequence sharding); a replica is "
                "one process")
        from ..utils.device import resolve_device

        # the card check runs HERE, in the parent: a fleet without a card
        # must not spawn replicas that die at start-up and burn the
        # restart budget
        resolve_device(device)
        self.device = None if device is None else str(device)
        if frontend not in ("threaded", "aio"):
            raise ValueError(f"frontend must be 'threaded' or 'aio', "
                             f"got {frontend!r}")
        self.n_replicas = int(n_replicas)
        self.cache_dir = str(cache_dir)
        self.host = host
        # per-replica connection layer: "aio" runs every replica on the
        # selectors event loop (serve/aio.py); "threaded" is the stdlib
        # fallback.  The chaos/elastic proofs run under BOTH.
        self.frontend = str(frontend)
        self.hot_mb = None if hot_mb is None else float(hot_mb)
        self.widths = tuple(int(w) for w in widths)
        self.max_queue = int(max_queue)
        self.batch_window_ms = float(batch_window_ms)
        self.warmup_path = warmup_path
        self.verify_cache = bool(verify_cache)
        self.fault_plan_path = fault_plan_path
        self.compile_cache_dir = (str(compile_cache_dir)
                                  if compile_cache_dir is not None else None)
        self.health_interval_s = float(health_interval_s)
        self.health_fail_after = int(health_fail_after)
        self.ready_timeout_s = float(ready_timeout_s)
        self.log_dir = log_dir
        self._env = _child_env(env)
        self._policy = policy if policy is not None else RetryPolicy(
            max_attempts=5, base_delay=0.05, max_delay=2.0, jitter=0.5)
        # -- elasticity ----------------------------------------------------
        self.autoscale = bool(autoscale)
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _env_num("PSS_FLEET_MIN_REPLICAS", self.n_replicas, int))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _env_num("PSS_FLEET_MAX_REPLICAS", self.n_replicas, int))
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        # default quorum: majority of the SMALLEST size the fleet may
        # legally shrink to (min_replicas under autoscale, else the
        # fixed size) — a quorum above the scale-down floor would let
        # the autoscaler retire the fleet into a self-inflicted outage
        # the queue signal could never recover from (rejected requests
        # never queue); the scale-down branch additionally refuses to
        # retire below whatever quorum is configured
        if quorum is not None:
            self.quorum = int(quorum)
        elif self.autoscale:
            self.quorum = self.min_replicas // 2 + 1
        else:
            self.quorum = self.n_replicas // 2 + 1
        self.scale_up_queue_frac = float(
            scale_up_queue_frac if scale_up_queue_frac is not None
            else _env_num("PSS_FLEET_SCALE_UP_FRAC", 0.5))
        self.scale_down_queue_frac = float(
            scale_down_queue_frac if scale_down_queue_frac is not None
            else _env_num("PSS_FLEET_SCALE_DOWN_FRAC", 0.1))
        if self.scale_up_queue_frac <= self.scale_down_queue_frac:
            raise ValueError(
                "hysteresis requires scale_up_queue_frac "
                f"({self.scale_up_queue_frac}) > scale_down_queue_frac "
                f"({self.scale_down_queue_frac})")
        self.scale_up_p95_s = (float(scale_up_p95_s)
                               if scale_up_p95_s is not None else None)
        self.scale_interval_s = float(scale_interval_s)
        base_cd = _env_num("PSS_FLEET_SCALE_COOLDOWN_S", 5.0)
        self.scale_up_cooldown_s = float(
            scale_up_cooldown_s if scale_up_cooldown_s is not None
            else base_cd)
        self.scale_down_cooldown_s = float(
            scale_down_cooldown_s if scale_down_cooldown_s is not None
            else 2.0 * base_cd)
        self.scale_events = []   # [{"t","action","replica","active",...}]
        self._last_scale_t = 0.0
        self._pending_up = False
        self._lock = threading.Lock()
        # replica id -> {"url": str|None, "gen": int, "health": dict|None,
        #               "health_fails": int}
        self._endpoints = {}
        self._sups = {}
        self._active = set()     # ids participating in routing
        self._retired = set()    # ids drained away by scale-down
        self._next_id = 0
        self._stopping = False
        self._health_thread = None
        self._scale_thread = None
        for _ in range(self.n_replicas):
            self._add_entry_locked()

    # -- membership --------------------------------------------------------

    def _add_entry_locked(self):
        """Register one replica slot (endpoint entry + supervisor) under
        the lock (the constructor calls this unlocked-but-unshared).
        Returns the new replica id; the supervisor is NOT started."""
        i = self._next_id
        self._next_id += 1
        self._endpoints[i] = {"url": None, "gen": 0, "health": None,
                              "health_fails": 0}
        self._sups[i] = ProcessSupervisor(
            f"replica{i}",
            spawn=(lambda i=i: self._spawn_replica(i)),
            policy=self._policy,
            on_exit=(lambda sup, rc, i=i: self._mark_down(i)))
        self._active.add(i)
        return i

    def add_replica(self):
        """Scale UP by one replica: allocate a fresh id (it re-enters
        HRW routing at a new key range), spawn it, and record the scale
        event.  Blocks until the replica's ready line.  Returns the
        replica id."""
        with self._lock:
            if self._stopping:
                return None
            i = self._add_entry_locked()
            sup = self._sups[i]
        sup.start()
        with self._lock:
            stopping = self._stopping
        if stopping:
            # drain() ran while this replica was booting and its stop()
            # was a no-op on the not-yet-started supervisor: finish the
            # shutdown here rather than leak a running server
            sup.stop(signal.SIGTERM)
            self._mark_down(i)
            return None
        self._record_scale("up", i)
        return i

    def retire_replica(self, i, timeout=60.0):
        """Scale DOWN one replica WITHOUT losing work: (1) leave routing
        immediately — new requests route around it; (2) SIGTERM drain —
        the replica finishes in-flight requests, closes its cache
        journal, exits 0; (3) the supervisor is stopped so nothing
        respawns it.  Runs the drain on a background thread (the control
        loop must not block on a long request); the fleet keeps the
        supervisor object for introspection (restart counts survive)."""
        with self._lock:
            if i not in self._active:
                return False
            self._active.discard(i)
            self._retired.add(i)
            sup = self._sups[i]
        self._mark_down(i)

        def _drain_one():
            sup.stop(signal.SIGTERM, timeout=timeout)

        threading.Thread(target=_drain_one, daemon=True,
                         name=f"pss-retire-{i}").start()
        self._record_scale("down", i)
        return True

    def _record_scale(self, action, i, signal_snapshot=None):
        with self._lock:
            self._last_scale_t = time.monotonic()
            self.scale_events.append({
                "t": round(time.time(), 3), "action": action,
                "replica": i, "active": len(self._active),
                "signal": signal_snapshot})

    def active_count(self):
        with self._lock:
            return len(self._active)

    def pending_scale_up(self):
        """True while a scale-up replica is booting (capacity ordered
        but not yet routable) — harness/ops visibility."""
        with self._lock:
            return self._pending_up

    def _prune_failed(self):
        """Evict members whose supervisor exhausted its restart budget
        from the ACTIVE set: a permanently-failed replica contributes
        zero capacity but would otherwise hold an ``active <
        max_replicas`` slot forever, capping the autoscaler below its
        configured maximum for the rest of the process lifetime."""
        with self._lock:
            dead = [i for i in self._active
                    if i in self._sups and self._sups[i].failed]
            for i in dead:
                self._active.discard(i)
                self._retired.add(i)
        for i in dead:
            self._record_scale("failed", i)

    # -- spawning ----------------------------------------------------------

    def _replica_cmd(self, i):
        cmd = [sys.executable, "-m", "psrsigsim_torch.serve",
               "--host", self.host, "--port", "0",
               "--cache-dir", self.cache_dir,
               "--replica-id", str(i),
               "--widths", ",".join(str(w) for w in self.widths),
               "--max-queue", str(self.max_queue),
               "--batch-window-ms", str(self.batch_window_ms),
               "--frontend", self.frontend]
        if self.device is not None:
            cmd += ["--device", self.device]
        if self.hot_mb is not None:
            cmd += ["--hot-mb", str(self.hot_mb)]
        if self.compile_cache_dir:
            cmd += ["--compile-cache-dir", self.compile_cache_dir]
        if self.warmup_path:
            cmd += ["--warmup", str(self.warmup_path)]
        if self.verify_cache:
            cmd += ["--verify-cache"]
        if self.fault_plan_path:
            cmd += ["--fault-plan", str(self.fault_plan_path)]
        return cmd

    def _spawn_replica(self, i):
        """Launch replica ``i`` and wait for its one-line ready protocol
        (which carries the kernel-assigned port).  On a failed/withheld
        ready line the process is killed and returned anyway — the
        supervisor's watcher sees the death and retries under the
        backoff policy, so a replica that crashes during startup cannot
        wedge the fleet."""
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stderr = open(os.path.join(self.log_dir, f"replica{i}.log"), "ab")
        else:
            stderr = subprocess.DEVNULL
        proc = subprocess.Popen(
            self._replica_cmd(i), stdout=subprocess.PIPE, stderr=stderr,
            text=True, env=self._env)
        if stderr is not subprocess.DEVNULL:
            stderr.close()
        ready = {}
        line = [None]

        def _read():
            line[0] = proc.stdout.readline()

        t = threading.Thread(target=_read, daemon=True)
        t.start()
        t.join(self.ready_timeout_s)
        if line[0]:
            try:
                ready = json.loads(line[0])
            except json.JSONDecodeError:
                ready = {}
        if not ready.get("ready"):
            # startup failure: hand the corpse to the supervisor
            if proc.poll() is None:
                proc.kill()
            self._mark_down(i)
            return proc
        with self._lock:
            ep = self._endpoints.get(i)
            if ep is not None:
                ep["url"] = f"http://{self.host}:{ready['port']}"
                ep["gen"] += 1
                ep["health_fails"] = 0
        return proc

    def _mark_down(self, i):
        with self._lock:
            ep = self._endpoints.get(i)
            if ep is not None:
                ep["url"] = None
                ep["health"] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Spawn every replica (serially — each binds port 0, no
        contention), the health-check loop, and (when ``autoscale``) the
        scaling control loop.  Returns self."""
        for i in sorted(self._active):
            self._sups[i].start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="pss-fleet-health")
        self._health_thread.start()
        with self._lock:
            # startup grace: cooldowns run from "fleet up", so an idle
            # signal in the first instants can't shed freshly-spawned
            # capacity before traffic arrives
            self._last_scale_t = time.monotonic()
        if self.autoscale:
            self._scale_thread = threading.Thread(
                target=self._autoscale_loop, daemon=True,
                name="pss-fleet-scale")
            self._scale_thread.start()
        return self

    def drain(self, timeout=60.0):
        """Fleet-wide graceful drain: SIGTERM to every replica (each
        finishes in-flight work, closes its cache journal, exits 0),
        supervisors stopped, health + scale loops joined.  Returns
        {replica id: exit code}."""
        with self._lock:
            self._stopping = True
            sups = dict(self._sups)
        codes = {}
        for i, sup in sups.items():
            codes[i] = sup.stop(signal.SIGTERM, timeout=timeout)
        if self._health_thread is not None:
            self._health_thread.join(timeout)
        if self._scale_thread is not None:
            self._scale_thread.join(timeout)
        return codes

    def install_sigterm_drain(self, exit_after=True):
        """Propagate SIGTERM (and SIGINT) on THIS process fleet-wide:
        the signal that drains one server drains the whole fleet.  With
        ``exit_after`` (the default) the process then terminates via
        the restored default handler — the single-server contract; a
        fleet that drained but kept answering 503s forever would just
        earn the orchestrator's SIGKILL.  Pass ``exit_after=False``
        when the caller owns process teardown (e.g. it still has an
        HTTP listener to close)."""
        def _drain(signum, frame):
            def _run():
                self.drain()
                if exit_after:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            threading.Thread(target=_run, daemon=True).start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)

    def kill_replica(self, i, sig=signal.SIGKILL):
        """Chaos/ops entry: signal one replica (default SIGKILL — the
        ``replica.kill`` fault uses this).  The supervisor restarts it
        under the backoff policy; routing drops it immediately."""
        self._mark_down(i)
        with self._lock:
            sup = self._sups.get(i)
        if sup is not None:
            sup.kill(sig)

    def restart_replica(self, i, kill_after_s=30.0):
        """Graceful restart of one replica (the router's gray-failure
        ejection hand-off): SIGTERM drain, supervisor respawns on exit,
        SIGKILL escalation if the child is too wedged to drain.  Routing
        drops it immediately (it re-enters at its old key range when the
        replacement's ready line lands)."""
        self._mark_down(i)
        with self._lock:
            sup = self._sups.get(i)
        if sup is not None:
            sup.restart(signal.SIGTERM, kill_after_s=kill_after_s)

    # -- autoscaling -------------------------------------------------------

    def load_signal(self):
        """The control loop's input, from the freshest health poll of
        every ACTIVE replica: total queue depth over total queue
        capacity, and the worst per-replica request p95.  A replica
        with no health sample yet contributes capacity only while its
        process is actually RUNNING (a booting scale-up is capacity
        arriving and must push the fraction down; a crashed member in
        restart backoff is capacity GONE and must not suppress the
        scale-up signal during a partial outage)."""
        with self._lock:
            members = [(self._endpoints[i].get("health"), self._sups[i])
                       for i in self._active
                       if i in self._endpoints and i in self._sups]
            n_active = len(self._active)
        depth = 0
        capacity = 0
        p95 = 0.0
        conns = 0
        for h, sup in members:
            if not sup.alive():
                continue   # dead/restarting: neither capacity nor depth
            if h is None:
                capacity += self.max_queue   # booting: capacity arriving
                continue
            depth += int(h.get("queue_depth", 0))
            capacity += int(h.get("max_queue", self.max_queue))
            p95 = max(p95, float(h.get("request_p95_s", 0.0)))
            # connection pressure (aio front ends report it): queue
            # depth alone cannot see thousands of open-but-waiting
            # sockets piling onto one replica
            conns += int(h.get("open_connections", 0))
        frac = depth / capacity if capacity else 0.0
        return {"queue_frac": round(frac, 4), "queue_depth": depth,
                "capacity": capacity, "p95_s": round(p95, 6),
                "open_connections": conns, "active": n_active}

    def _autoscale_loop(self):
        """Hysteresis control loop (module docstring): up when the queue
        fraction (or p95) says overload and the up-cooldown passed; down
        when the fraction says idle and the LONGER down-cooldown passed;
        never outside [min_replicas, max_replicas]; one scale-up in
        flight at a time (a booting replica is capacity already
        ordered — ordering another on the same signal is how autoscalers
        overshoot)."""
        while True:
            with self._lock:
                if self._stopping:
                    return
                last = self._last_scale_t
                pending = self._pending_up
            self._prune_failed()
            sig = self.load_signal()
            now = time.monotonic()
            # the p95 signal is a LIFETIME histogram percentile (never
            # windowed), so it is gated on live queue depth: a stale
            # slow period must not keep an IDLE fleet flapping between
            # scale-down (frac 0) and scale-up (sticky p95) forever
            overload = sig["queue_frac"] > self.scale_up_queue_frac or (
                self.scale_up_p95_s is not None
                and sig["p95_s"] > self.scale_up_p95_s
                and sig["queue_depth"] > 0)
            idle = sig["queue_frac"] < self.scale_down_queue_frac
            if (overload and not pending
                    and sig["active"] < self.max_replicas
                    and now - last >= self.scale_up_cooldown_s):
                with self._lock:
                    self._pending_up = True

                def _up(snapshot=sig):
                    try:
                        i = self.add_replica()
                        if i is not None and self.scale_events:
                            with self._lock:
                                self.scale_events[-1]["signal"] = snapshot
                    finally:
                        with self._lock:
                            self._pending_up = False

                threading.Thread(target=_up, daemon=True,
                                 name="pss-scale-up").start()
            elif (idle and not pending
                  and sig["active"] > self.min_replicas
                  # never retire INTO a quorum outage: below quorum the
                  # router rejects everything, so the queue signal that
                  # would trigger recovery can never form
                  and sig["active"] - 1 >= self.quorum
                  and now - last >= self.scale_down_cooldown_s):
                with self._lock:
                    victims = sorted(self._active)
                if victims:
                    # newest first: its key range is the youngest, and
                    # retiring it restores exactly the pre-scale-up map
                    victim = victims[-1]
                    self.retire_replica(victim)
                    with self._lock:
                        if self.scale_events:
                            self.scale_events[-1]["signal"] = sig
            time.sleep(self.scale_interval_s)

    # -- routing / health views -------------------------------------------

    def endpoints(self):
        """Live ``(replica_id, base_url)`` pairs, routing's view —
        ACTIVE replicas only (a retiring replica leaves this list before
        its drain signal is even sent)."""
        with self._lock:
            eps = [(i, self._endpoints[i]["url"]) for i in self._active
                   if self._endpoints[i]["url"] is not None]
            sups = {i: self._sups[i] for i, _ in eps}
        return [(i, u) for i, u in eps if sups[i].alive()]

    def endpoint_gen(self, i):
        with self._lock:
            return self._endpoints[i]["gen"]

    def healthy_count(self):
        return len(self.endpoints())

    def has_quorum(self):
        return self.healthy_count() >= self.quorum

    def degraded(self):
        return not self.has_quorum()

    def health(self):
        """Fleet-level health summary (the router's ``/healthz``)."""
        with self._lock:
            per = {i: dict(ep["health"]) if ep["health"] else None
                   for i, ep in self._endpoints.items()}
            active = sorted(self._active)
            retired = sorted(self._retired)
            events = list(self.scale_events[-16:])
            sups = dict(self._sups)
        return {
            "ok": self.has_quorum(),
            "replicas": self.n_replicas,
            "active": active,
            "healthy": self.healthy_count(),
            "quorum": self.quorum,
            "degraded": self.degraded(),
            "restarts": {i: s.restarts for i, s in sups.items()},
            "failed": [i for i, s in sups.items() if s.failed],
            "autoscale": {
                "enabled": self.autoscale,
                "min": self.min_replicas, "max": self.max_replicas,
                "retired": retired,
                "events": events,
            },
            "health": per,
        }

    def _poll_health(self, url):
        """One ``/healthz`` exchange (overridable in tests): returns the
        parsed payload or raises on an unresponsive replica."""
        with urllib.request.urlopen(url + "/healthz", timeout=2.0) as r:
            return json.loads(r.read())

    def _health_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
            for i, url in self.endpoints():
                try:
                    h = self._poll_health(url)
                except (urllib.error.URLError, OSError,
                        json.JSONDecodeError):
                    with self._lock:
                        ep = self._endpoints.get(i)
                        if ep is None:
                            continue
                        ep["health_fails"] += 1
                        fails = ep["health_fails"]
                    if fails >= self.health_fail_after:
                        # unresponsive but not exited (wedged listener,
                        # livelock): SIGKILL it into the supervisor's
                        # restart path instead of routing into a tarpit
                        self.kill_replica(i, signal.SIGKILL)
                    continue
                with self._lock:
                    ep = self._endpoints.get(i)
                    if ep is not None:
                        ep["health"] = h
                        ep["health_fails"] = 0
            time.sleep(self.health_interval_s)

    def __repr__(self):
        return (f"ReplicaFleet(active={self.active_count()}, "
                f"healthy={self.healthy_count()}, quorum={self.quorum}, "
                f"autoscale={self.autoscale})")
