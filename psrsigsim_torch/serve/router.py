"""Consistent-hash front end over a replica fleet, with failover
(counterpart: psrsigsim_tpu/serve/router.py; host code, copied).

The routing layer between "a stream of request specs" and "N serving
replicas over one shared cache":

* **Consistent routing by spec hash** — rendezvous (highest-random-
  weight) hashing of ``spec_hash`` over the LIVE replica set, keyed by
  replica *id* (not port), so identical in-flight specs land on — and
  coalesce at — exactly one replica, a restarted replica re-enters at
  its old key range, and a death moves only the dead replica's keys.
* **Deadline-preserving failover** — a request in flight when its
  replica dies (connection refused/reset/timeout) is re-routed to the
  next-best live replica with the *remaining* deadline budget, not a
  fresh one.  Re-execution is safe: at-most-once device work is
  guaranteed by the shared cache (a result the dead replica committed
  is served as a hit by the replacement), and bytes are identical by
  the (seed, spec_hash) key fold whatever replica computes them.
* **Graceful degradation** — below fleet quorum the router REJECTS with
  the explicit-backpressure exception the single-server admission path
  already uses (:class:`~psrsigsim_torch.serve.RequestRejected` with a
  retry-after), never hangs or half-serves.
* **Gray-failure ejection (circuit breakers)** — health polling can
  only see a replica that stops *answering*; a replica that answers
  ``/healthz`` instantly but serves requests 10x slow (wedged runtime,
  thermal throttle, noisy neighbor) would drag fleet p99 forever.  The
  router keeps a per-replica latency EWMA and consecutive-error count
  and wraps each replica in a circuit breaker: *closed* (routing
  normally) -> *open* on ``breaker_fails`` consecutive transport
  failures OR on a latency outlier (EWMA above ``breaker_outlier`` x
  the median of the other closed replicas, past an absolute floor) ->
  after ``breaker_reset_s`` a single *half-open* probe request is let
  through — success closes the breaker, failure reopens it.  An open
  replica is excluded from routing (its keys move by rendezvous
  construction) and, with ``eject_restart``, handed to the supervisor
  for a graceful SIGTERM restart.  Caveat: with blocking ``wait=True``
  submits the measured latency INCLUDES the replica's queue wait, so a
  healthy-but-busy replica (hot-key imbalance) can trip the outlier
  check — for pure routing exclusion that is load shifting (its keys
  move to idler replicas and the probe re-admits it as soon as it
  answers fast), but leave ``eject_restart`` off (the default) unless
  submits are async: restarting a merely-busy replica sheds capacity
  exactly when it is scarce.

* **Pooled keep-alive upstreams** — the default transport is a
  :class:`PooledTransport`: up to ``PSS_ROUTER_POOL_SIZE`` persistent
  HTTP/1.1 connections per replica, reused across forwards (no fresh
  TCP setup per request), with stale-socket single-retry and
  breaker-aware eviction — a breaker opening closes the ejected
  replica's pooled sockets within the breaker window, so no cached
  route outlives the ejection.

Chaos points (armed only via an explicit FaultPlan): ``replica.kill``
SIGKILLs the routed replica right *before* the configured request is
forwarded — the hardest-case mid-traffic death, proving the re-route +
restart path deterministically; ``route.blackhole`` makes a routed
replica unreachable without killing it (the network-partition case);
``replica.slow`` (armed on the replica side) makes one fleet member
alive-but-slow, the gray failure the breaker exists for.

``make_router_server`` wraps the router in the same stdlib HTTP JSON
API one replica speaks, so a fleet is a drop-in replacement for a
single server at one address.
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.faults import should_fire
from .service import RequestRejected
from .spec import canonicalize, spec_hash

__all__ = ["FleetRouter", "RouteFailed", "make_router_server",
           "PooledTransport"]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class _Breaker:
    """Per-replica circuit-breaker state (mutated under the router
    lock): closed -> open (consecutive failures or latency-outlier
    ejection) -> half-open single probe -> closed or back open."""

    __slots__ = ("state", "fails", "opened_at", "probing", "ewma",
                 "samples", "ejections", "reopens", "reason")

    def __init__(self):
        self.state = "closed"
        self.fails = 0          # consecutive transport failures
        self.opened_at = 0.0
        self.probing = False    # a half-open probe is in flight
        self.ewma = 0.0         # per-forward latency EWMA (seconds)
        self.samples = 0
        self.ejections = 0      # times this replica's breaker opened
        self.reopens = 0        # failed half-open probes
        self.reason = None      # why it last opened ("errors"/"latency")

    def snapshot(self):
        return {"state": self.state, "ewma_s": round(self.ewma, 6),
                "samples": self.samples, "fails": self.fails,
                "ejections": self.ejections, "reopens": self.reopens,
                "reason": self.reason}


class RouteFailed(RuntimeError):
    """Every candidate replica failed (or the deadline expired) for one
    request; ``attempts`` records the per-replica failures."""

    def __init__(self, msg, attempts):
        self.attempts = list(attempts)
        super().__init__(f"{msg}; attempts: {attempts}")


def _http_transport(method, url, body, timeout):
    """One-shot (non-pooled) transport: one HTTP exchange over a fresh
    TCP connection -> ``(status, json dict)``.  Transport-level
    failures (refused, reset, timed out) propagate as OSError/URLError
    — the router's failover trigger.  Injectable so router logic is
    testable without sockets.  The router's DEFAULT is now
    :class:`PooledTransport`; this remains for tests and for callers
    that explicitly want connection-per-request semantics."""
    headers = {"Content-Type": "application/json"} if body else {}
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read())
        except (ValueError, OSError):
            payload = {"error": str(e)}
        return e.code, payload


class PooledTransport:
    """Keep-alive upstream connection pool: the router's default
    transport.

    Every forwarded request used to pay a fresh ``http.client`` TCP
    setup (connect + slow-start + teardown) per exchange; under load
    that is both per-request latency and a steady churn of TIME_WAIT
    sockets.  This transport keeps up to ``pool_size`` persistent
    HTTP/1.1 connections per replica endpoint and reuses them across
    requests:

    * **Checkout/checkin** is LIFO (the warmest socket first); a pooled
      socket idle past ``idle_timeout_s`` is closed instead of reused.
    * **Stale-socket retry**: a REUSED connection that dies before any
      response bytes (the peer reaped it between requests) is retried
      ONCE on a fresh connection — the standard keep-alive discipline —
      so a benign idle-reap never counts as a replica failure.  A fresh
      connection's failure propagates immediately (the failover
      trigger).
    * **Breaker-aware eviction**: :meth:`evict` closes every pooled
      socket for an endpoint and bumps its epoch, so sockets checked
      out before the eviction are closed at checkin instead of
      re-entering the pool — when a replica's circuit breaker opens,
      the router evicts its pool entry and no stale socket to the
      ejected replica outlives the breaker window.

    Thread-safe; one instance per router (it is per-destination
    state, like the breakers).
    """

    def __init__(self, pool_size=None, idle_timeout_s=30.0):
        self.pool_size = int(pool_size if pool_size is not None
                             else _env_float("PSS_ROUTER_POOL_SIZE", 4))
        self.idle_timeout_s = float(idle_timeout_s)
        self._lock = threading.Lock()
        self._pools = {}    # netloc -> deque of (conn, t_checkin)
        self._epoch = {}    # netloc -> eviction epoch
        self.hits = 0           # exchanges on a reused socket
        self.misses = 0         # fresh TCP connects
        self.stale_retries = 0  # reused-socket deaths retried fresh
        self.evictions = 0      # sockets closed by evict()
        self.idle_closed = 0    # sockets closed as past idle_timeout_s

    @staticmethod
    def _netloc(url):
        return urllib.parse.urlsplit(url).netloc

    def _checkout(self, netloc):
        """A pooled live connection (warmest first) or None; returns
        ``(conn, epoch)``."""
        now = time.monotonic()
        with self._lock:
            epoch = self._epoch.get(netloc, 0)
            q = self._pools.get(netloc)
            while q:
                conn, t = q.pop()
                if now - t <= self.idle_timeout_s:
                    self.hits += 1
                    return conn, epoch
                self.idle_closed += 1
                conn.close()
            self.misses += 1
            return None, epoch

    def _checkin(self, netloc, conn, epoch):
        with self._lock:
            if self._epoch.get(netloc, 0) != epoch:
                # evicted (breaker opened) while this socket was in
                # flight: close instead of resurrecting a route to an
                # ejected replica
                self.evictions += 1
                conn.close()
                return
            q = self._pools.setdefault(netloc, collections.deque())
            q.append((conn, time.monotonic()))
            while len(q) > self.pool_size:
                old, _ = q.popleft()
                old.close()

    def evict(self, base_url):
        """Close every pooled socket for ``base_url``'s endpoint and
        invalidate in-flight checkins (breaker-open hand-off)."""
        netloc = self._netloc(base_url)
        with self._lock:
            self._epoch[netloc] = self._epoch.get(netloc, 0) + 1
            q = self._pools.pop(netloc, None)
            conns = [c for c, _ in q] if q else []
            self.evictions += len(conns)
        for c in conns:
            c.close()

    def open_count(self, base_url):
        """Pooled (idle) sockets currently held for an endpoint — the
        c10k harness asserts this hits zero within the breaker window
        after an ejection."""
        with self._lock:
            q = self._pools.get(self._netloc(base_url))
            return len(q) if q else 0

    def close(self):
        with self._lock:
            pools, self._pools = self._pools, {}
        for q in pools.values():
            for conn, _ in q:
                conn.close()

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "stale_retries": self.stale_retries,
                    "evictions": self.evictions,
                    "idle_closed": self.idle_closed,
                    "pooled": {n: len(q)
                               for n, q in self._pools.items() if q}}

    def __call__(self, method, url, body, timeout):
        parsed = urllib.parse.urlsplit(url)
        netloc = parsed.netloc
        path = parsed.path or "/"
        if parsed.query:
            path += "?" + parsed.query
        headers = {"Content-Type": "application/json"} if body else {}
        for attempt in (0, 1):
            conn, epoch = self._checkout(netloc)
            reused = conn is not None
            if conn is None:
                conn = http.client.HTTPConnection(
                    parsed.hostname, parsed.port, timeout=timeout)
            else:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as err:
                conn.close()
                # a TIMEOUT is a slow replica, not a reaped idle socket:
                # retrying it would cost a second full timeout per
                # forward and double-submit the request — propagate so
                # the breaker/failover sees the slowness immediately
                if (reused and attempt == 0
                        and not isinstance(err, TimeoutError)):
                    # the peer reaped this idle socket between requests:
                    # retry once on a fresh connection before calling
                    # the replica dead
                    with self._lock:
                        self.stale_retries += 1
                    continue
                if isinstance(err, OSError):
                    raise
                raise ConnectionError(
                    f"{type(err).__name__}: {err}") from err
            if resp.will_close:
                conn.close()
            else:
                self._checkin(netloc, conn, epoch)
            return resp.status, json.loads(data)
        raise ConnectionError(f"pooled transport retry exhausted for {url}")


class FleetRouter:
    """Route requests across a :class:`~psrsigsim_torch.serve.ReplicaFleet`.

    ``fleet`` may be any object exposing ``endpoints() ->
    [(replica_id, base_url)]``, ``has_quorum()``, and
    ``kill_replica(id, sig)`` — the real fleet, or a stub in tests.

    Thread-safe: traffic threads share one router; counters are under a
    lock, routing reads a snapshot of the live endpoint list.
    """

    def __init__(self, fleet, faults=None, default_timeout_s=120.0,
                 retry_after_s=0.5, transport=None, breaker_fails=None,
                 breaker_reset_s=None, breaker_outlier=None,
                 breaker_min_latency_s=None, breaker_min_samples=None,
                 eject_restart=False):
        self.fleet = fleet
        self._faults = faults
        self.default_timeout_s = float(default_timeout_s)
        self.retry_after_s = float(retry_after_s)
        if transport is not None:
            self._transport = transport
            self._pool = (transport if isinstance(transport,
                                                  PooledTransport) else None)
        else:
            # the default: pooled persistent keep-alive upstreams —
            # every forward no longer pays a fresh TCP setup
            self._pool = PooledTransport()
            self._transport = self._pool
        # circuit-breaker tunables (env-overridable, arg wins):
        #   fails     — consecutive transport failures that open it
        #   reset_s   — open dwell before the half-open probe
        #   outlier   — EWMA multiple of the fleet median that ejects
        #   min_latency_s — absolute EWMA floor below which no ejection
        #                   (a 2 ms replica in a 0.4 ms fleet is fine)
        #   min_samples   — EWMA samples required before outlier checks
        self.breaker_fails = int(breaker_fails if breaker_fails is not None
                                 else _env_float("PSS_BREAKER_FAILS", 3))
        self.breaker_reset_s = (
            float(breaker_reset_s) if breaker_reset_s is not None
            else _env_float("PSS_BREAKER_RESET_S", 2.0))
        self.breaker_outlier = (
            float(breaker_outlier) if breaker_outlier is not None
            else _env_float("PSS_BREAKER_OUTLIER", 4.0))
        self.breaker_min_latency_s = (
            float(breaker_min_latency_s)
            if breaker_min_latency_s is not None
            else _env_float("PSS_BREAKER_MIN_LATENCY_S", 0.25))
        self.breaker_min_samples = int(
            breaker_min_samples if breaker_min_samples is not None
            else _env_float("PSS_BREAKER_MIN_SAMPLES", 3))
        self.eject_restart = bool(eject_restart)
        self._lock = threading.Lock()
        self._breakers = {}      # replica id -> _Breaker
        self.routed = 0          # responses successfully returned
        self.forwarded = 0       # forward attempts (includes failovers)
        self.failovers = 0       # re-routes after a transport failure
        self.blackholed = 0      # route.blackhole shots absorbed
        self.kills_fired = 0     # replica.kill shots dispatched
        self.rejected = 0        # quorum / backpressure rejections
        self.ejections = 0       # breaker opens (errors + latency)
        self.per_replica = {}    # replica id -> responses served

    # -- consistent routing ------------------------------------------------

    @staticmethod
    def _score(h, replica_id):
        return hashlib.sha256(f"{h}:{replica_id}".encode()).digest()

    def _allow_locked(self, b, now):
        """May this replica take traffic right now?  Caller holds the
        lock.  closed: yes.  open: only once ``breaker_reset_s`` has
        elapsed (the probe path).  half-open: only while no probe is
        already in flight."""
        if b.state == "closed":
            return True
        if b.state == "open":
            return (now - b.opened_at) >= self.breaker_reset_s \
                and not b.probing
        return not b.probing     # half_open

    def route(self, h, exclude=(), probe=True):
        """The live replica that owns spec hash ``h``: rendezvous
        hashing over ``fleet.endpoints()`` minus ``exclude`` minus
        replicas whose circuit breaker is open (an open replica past
        its reset window is admitted as a half-open PROBE — at most one
        in flight, marked here only when ``probe`` and it actually won
        the rendezvous).  Returns ``(replica_id, base_url)`` or None
        when nothing is routable."""
        now = time.monotonic()
        with self._lock:
            best = None
            for rid, url in self.fleet.endpoints():
                if rid in exclude:
                    continue
                b = self._breakers.get(rid)
                if b is not None and not self._allow_locked(b, now):
                    continue
                s = self._score(h, rid)
                if best is None or s > best[0]:
                    best = (s, rid, url)
            if best is None:
                return None
            if probe:
                b = self._breakers.get(best[1])
                if b is not None and b.state in ("open", "half_open"):
                    b.state = "half_open"
                    b.probing = True
            return best[1], best[2]

    # -- breaker bookkeeping ----------------------------------------------

    def _breaker_states_locked(self):
        return {rid: b.state for rid, b in self._breakers.items()}

    def _record_success(self, rid, latency_s):
        """Fold one successful forward's latency into the replica's
        EWMA; close a half-open breaker; eject a latency outlier.
        Returns True when this success OPENED the breaker (gray-failure
        ejection) so the caller can hand the replica to the supervisor
        outside the lock."""
        ejected = False
        with self._lock:
            b = self._breakers.setdefault(rid, _Breaker())
            b.fails = 0
            b.probing = False
            alpha = 0.3
            if b.state in ("half_open", "open"):
                # the probe answered: close, and RESET the EWMA to this
                # fresh sample — the stale pre-ejection latency must not
                # keep re-ejecting a replica that recovered (a probe
                # that is itself still slow re-opens via the outlier
                # check below, which is the reopen-on-still-sick path)
                b.state = "closed"
                b.reason = None
                b.ewma = float(latency_s)
            else:
                b.ewma = (float(latency_s) if b.samples == 0
                          else alpha * float(latency_s)
                          + (1.0 - alpha) * b.ewma)
            b.samples += 1
            if b.state == "closed" and b.samples >= self.breaker_min_samples:
                # latency-outlier ejection: this replica answers, but
                # far slower than its peers — the gray failure /healthz
                # cannot see.  Compare against the median EWMA of the
                # OTHER closed replicas (an already-ejected peer must
                # not drag the baseline up).
                others = sorted(
                    o.ewma for r2, o in self._breakers.items()
                    if r2 != rid and o.samples > 0 and o.state == "closed")
                if others:
                    med = others[len(others) // 2]
                    if (b.ewma > self.breaker_min_latency_s
                            and b.ewma > self.breaker_outlier * med):
                        b.state = "open"
                        b.opened_at = time.monotonic()
                        b.reason = "latency"
                        b.ejections += 1
                        self.ejections += 1
                        ejected = True
        if ejected and self.eject_restart:
            # hand the gray replica to the supervisor: graceful SIGTERM
            # restart (in-flight work finishes; a truly wedged child is
            # SIGKILLed by the escalation) — routing already excludes it
            restart = getattr(self.fleet, "restart_replica", None)
            if restart is not None:
                restart(rid)
            else:
                self.fleet.kill_replica(rid, signal.SIGTERM)
        return ejected

    def _clear_probe(self, rid):
        """Release a half-open probe slot without recording an outcome
        (the forward failed in a way that says nothing about the
        replica — e.g. a client-side parse error)."""
        with self._lock:
            b = self._breakers.get(rid)
            if b is not None:
                b.probing = False

    def _record_failure(self, rid):
        """One transport failure: consecutive-failure counting opens the
        breaker; a failed half-open probe reopens it immediately.
        Returns True when this failure OPENED (or reopened) the breaker
        so the caller can evict the replica's pooled sockets."""
        with self._lock:
            b = self._breakers.setdefault(rid, _Breaker())
            probe_failed = b.probing or b.state == "half_open"
            b.probing = False
            b.fails += 1
            if probe_failed:
                b.state = "open"
                b.opened_at = time.monotonic()
                b.reopens += 1
                return True
            if b.state == "closed" and b.fails >= self.breaker_fails:
                b.state = "open"
                b.opened_at = time.monotonic()
                b.reason = "errors"
                b.ejections += 1
                self.ejections += 1
                return True
            return False

    def _evict_pooled(self, url):
        """Breaker-aware pool hygiene: when a replica's breaker opens,
        close its pooled keep-alive sockets (and invalidate in-flight
        checkins) so no cached route to an ejected replica survives the
        breaker window."""
        if self._pool is not None and url is not None:
            self._pool.evict(url)

    # -- request path ------------------------------------------------------

    def _maybe_chaos_kill(self, rid):
        """``replica.kill``: SIGKILL the routed replica right before the
        ``after_requests``-th response would be produced — the forward
        that follows runs into the freshly dead socket, exercising the
        worst-case failover ordering deterministically."""
        if self._faults is None:
            return
        cfg = self._faults.config("replica.kill")
        if cfg is None:
            return
        with self._lock:
            upcoming = self.routed + 1
        if upcoming < int(cfg.get("after_requests", 1)):
            return
        target = cfg.get("replica", rid)
        if should_fire(self._faults, "replica.kill", token=str(target)):
            self.fleet.kill_replica(int(target), signal.SIGKILL)
            with self._lock:
                self.kills_fired += 1

    def submit(self, spec, deadline_s=None, wait=True, wait_s=None):
        """Route one spec to its replica and return ``(status, body)``
        from the replica's ``/simulate``.

        ``deadline_s`` bounds the WHOLE request including failovers: a
        re-route carries the remaining budget, not a fresh one.  With
        ``wait`` the call blocks for the result (the chaos harness's
        mode); ``wait_s`` caps that block at the CLIENT'S requested
        duration (a short sync wait stays short — the replica answers
        202/409 after it and the caller polls); without either the
        replica answers 202 immediately.  Raises
        :class:`RequestRejected` below quorum and :class:`RouteFailed`
        when every candidate failed."""
        canonical = canonicalize(spec)
        h = spec_hash(canonical)
        budget = deadline_s if deadline_s is not None else self.default_timeout_s
        t_end = time.monotonic() + float(budget)
        excluded = set()
        attempts = []
        while True:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                # checked FIRST: an already-expired deadline fails
                # immediately with zero transport calls, whatever the
                # quorum/breaker state (pinned by a unit test)
                raise RouteFailed(f"deadline exhausted for {h[:12]}",
                                  attempts)
            if not self.fleet.has_quorum():
                with self._lock:
                    self.rejected += 1
                raise RequestRejected("fleet below quorum",
                                      self.retry_after_s)
            picked = self.route(h, exclude=excluded)
            if picked is None:
                if not excluded:
                    # nothing routable and nothing merely excluded-this-
                    # request: either no live replica, or every live one
                    # sits behind an open breaker — fail loudly with the
                    # attempt trace and breaker states, never hang
                    with self._lock:
                        states = self._breaker_states_locked()
                    raise RouteFailed(
                        f"no routable replica for {h[:12]} "
                        f"(breakers: {states or 'none'})", attempts)
                # every live replica failed once: clear the exclusion,
                # give restarts a beat to land, and try again
                excluded.clear()
                time.sleep(min(0.05, max(remaining, 0.0)))
                continue
            rid, url = picked
            self._maybe_chaos_kill(rid)
            body = dict(spec)
            body["deadline_s"] = remaining
            if wait_s is not None:
                body["wait"] = min(float(wait_s), remaining)
            elif wait:
                body["wait"] = remaining
            payload = json.dumps(body).encode()
            t_fwd = time.monotonic()
            try:
                if should_fire(self._faults, "route.blackhole",
                               token=str(rid)):
                    with self._lock:
                        self.blackholed += 1
                    raise ConnectionError(
                        f"route.blackhole: replica {rid} unreachable")
                with self._lock:
                    self.forwarded += 1
                status, resp = self._transport(
                    "POST", url + "/simulate", payload,
                    max(remaining, 0.001))
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError) as err:
                # the replica died (or the route is black-holed) with
                # this request in flight: exclude it and re-route with
                # the REMAINING deadline.  Safe to re-execute — a result
                # the dead replica already committed comes back as a
                # shared-cache hit on the replacement, never a second
                # device execution.
                attempts.append((rid, f"{type(err).__name__}: {err}"))
                excluded.add(rid)
                if self._record_failure(rid):
                    self._evict_pooled(url)
                with self._lock:
                    self.failovers += 1
                continue
            except BaseException:
                # anything outside the failover tuple (http.client
                # exceptions, a truncated-body ValueError from the
                # transport's json parse) propagates to the caller —
                # but must not strand a half-open probe flag, which
                # would exclude the replica from routing forever
                self._clear_probe(rid)
                raise
            if status >= 500:
                # a replica answering every request with a fast 5xx is
                # exactly as sick as one refusing connections: count it
                # toward the breaker instead of poisoning the latency
                # EWMA with near-zero "successes"
                if self._record_failure(rid):
                    self._evict_pooled(url)
            elif status in (429, 503):
                # backpressure says the replica is BUSY, not slow or
                # broken: release any probe slot but keep the ~instant
                # reject out of the EWMA — folding it in would collapse
                # a shedding replica's baseline and make its healthy,
                # actually-working peers look like latency outliers
                self._clear_probe(rid)
            else:
                if self._record_success(rid, time.monotonic() - t_fwd):
                    # latency ejection: the gray replica's pooled
                    # sockets go with its routing eligibility
                    self._evict_pooled(url)
            with self._lock:
                self.routed += 1
                self.per_replica[rid] = self.per_replica.get(rid, 0) + 1
            return status, resp

    def get(self, path, deadline_s=30.0, key=None):
        """Route a GET (``/status/<id>``, ``/result/<id>``) by its
        request id — the same consistent route its POST took, so the
        replica that holds the request's status answers; after a
        failover the shared cache backstops ``/result`` on any replica.
        ``key`` overrides the routing key (defaults to the trailing
        path segment)."""
        h = key if key is not None else path.rsplit("/", 1)[-1]
        t_end = time.monotonic() + float(deadline_s)
        excluded = set()
        attempts = []
        while True:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                raise RouteFailed(f"deadline exhausted for GET {path}",
                                  attempts)
            picked = self.route(h, exclude=excluded, probe=False)
            if picked is None:
                raise RouteFailed(f"no live replica for GET {path}",
                                  attempts)
            rid, url = picked
            try:
                return self._transport("GET", url + path, None,
                                       max(remaining, 0.001))
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError) as err:
                attempts.append((rid, f"{type(err).__name__}: {err}"))
                excluded.add(rid)
                with self._lock:
                    self.failovers += 1

    # -- introspection -----------------------------------------------------

    def stats(self):
        with self._lock:
            out = {
                "routed": self.routed,
                "forwarded": self.forwarded,
                "failovers": self.failovers,
                "blackholed": self.blackholed,
                "kills_fired": self.kills_fired,
                "rejected": self.rejected,
                "ejections": self.ejections,
                "per_replica": dict(self.per_replica),
                "breakers": {rid: b.snapshot()
                             for rid, b in self._breakers.items()},
            }
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        return out

    def close(self):
        """Release pooled upstream sockets (fd hygiene — the c10k
        harness asserts the fd census returns to baseline)."""
        if self._pool is not None:
            self._pool.close()


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "psrsigsim-fleet-router/1.0"
    protocol_version = "HTTP/1.1"

    @property
    def router(self):
        return self.server.router

    def log_message(self, fmt, *args):
        pass

    def _reply(self, code, obj, headers=()):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        if self.path.rstrip("/") != "/simulate":
            return self._reply(404, {"error": f"no such endpoint {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as err:
            return self._reply(400, {"error": f"bad JSON body: {err}"})
        if not isinstance(body, dict):
            return self._reply(400, {"error": "spec body must be a JSON object"})
        try:
            wait_s = body.pop("wait", None)
            wait_s = None if wait_s is None else float(wait_s)
            deadline_s = body.pop("deadline_s", None)
            deadline_s = None if deadline_s is None else float(deadline_s)
        except (TypeError, ValueError):
            # the single server's contract exactly (http.py): a clean
            # 400, not a dropped connection from the handler thread
            return self._reply(
                400, {"error": "wait / deadline_s must be numbers"})
        try:
            from .spec import SpecError

            status, resp = self.router.submit(
                body, deadline_s=deadline_s, wait=wait_s is not None,
                wait_s=wait_s)
        except SpecError as err:
            return self._reply(400, {"error": "invalid spec",
                                     "fields": err.errors})
        except RequestRejected as err:
            return self._reply(
                503, {"error": err.reason,
                      "retry_after_s": err.retry_after_s},
                headers=[("Retry-After", f"{err.retry_after_s:.3f}")])
        except RouteFailed as err:
            return self._reply(504, {"error": str(err)})
        return self._reply(status, resp)

    def do_GET(self):
        path = self.path.rstrip("/")
        if path == "/healthz":
            return self._reply(200, self.router.fleet.health())
        if path == "/metrics":
            return self._reply(200, {"router": self.router.stats(),
                                     "fleet": self.router.fleet.health()})
        if path.startswith(("/status/", "/result/")):
            try:
                status, resp = self.router.get(path)
            except (RouteFailed, RequestRejected) as err:
                return self._reply(504, {"error": str(err)})
            return self._reply(status, resp)
        return self._reply(404, {"error": f"no such endpoint {self.path}"})


def make_router_server(router, host="127.0.0.1", port=0):
    """A ``ThreadingHTTPServer`` speaking the single-server JSON API,
    backed by the fleet: one address in front of N replicas.  ``port=0``
    picks a free port (``server.server_port``)."""
    srv = ThreadingHTTPServer((host, port), _RouterHandler)
    srv.daemon_threads = True
    srv.router = router
    return srv
