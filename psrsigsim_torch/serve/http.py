"""Thin stdlib HTTP front end over :class:`SimulationService` (counterpart:
psrsigsim_tpu/serve/http.py; host only).

A ``ThreadingHTTPServer`` JSON API — no framework, no dependency:

=====================  =====================================================
endpoint               behavior
=====================  =====================================================
``POST /simulate``     body: the request spec JSON.  202 + ``{"id",
                       "status"}`` on admission; 200 with the result
                       inline when the body carries ``"wait": seconds``
                       (or when the cache answered instantly); 400 on a
                       bad spec (every bad field named); 429 + a
                       ``Retry-After`` header on backpressure; 503 +
                       ``Retry-After`` while draining.
``GET /status/<id>``   200 ``{"id", "status", ...}``; 404 unknown.
``GET /result/<id>``   200 ``{"id", "shape", "dtype", "profile": [[...]]}``
                       when done; 409 while queued/running; 410 for
                       expired/errored; 404 unknown.
``GET /healthz``       200 ``{"ok": true, "replica_id", "uptime_s",
                       "queue_depth", "draining", "served",
                       "device_calls", "programs", "compile_counts"}``
                       — the fleet supervisor's health-check and
                       per-replica single-compile guard read this.
``GET /metrics``       200: the service metrics dict — stage seconds +
                       latency p50/p95/p99, queue depths, per-bucket
                       program hit counts, cache stats (hot/disk tier
                       counters), front-end gauges, per-scenario
                       request counters (``scenario_requests``) and
                       per-effect device-time stages (``effect:*`` in
                       ``stages``) for mixed-scenario traffic profiles.
=====================  =====================================================

The endpoint SEMANTICS live in the module-level ``*_reply`` functions
below, shared verbatim by this threaded server and the event-loop front
end (:mod:`psrsigsim_torch.serve.aio`): both build replies through the
same code and the same ``json.dumps``, so a response body is
byte-identical whichever front end served it (pinned by
tests/test_torch_serve.py over real sockets).  The threaded
server remains the fallback (``--frontend threaded``) for debugging and
for platforms where a blocking handler per connection is convenient;
the aio front end is the C10k path.

Graceful drain: SIGTERM (and SIGINT) flips the service into draining —
new submits get 503, in-flight requests finish, the cache journal is
closed — then the listener shuts down.  SIGKILL is the tested crash
path: the content-addressed cache journal guarantees committed results
survive (tests/test_torch_serve.py relaunches a SIGKILLed
``python -m psrsigsim_torch.serve``).
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.faults import should_fire
from .service import RequestRejected, SimulationService
from .spec import SpecError

__all__ = ["ServeHandler", "make_server", "run_server", "maybe_slow_fault",
           "simulate_reply", "result_reply", "get_reply"]


# ---------------------------------------------------------------------------
# shared endpoint semantics (threaded handler AND serve/aio.py call these)
# ---------------------------------------------------------------------------


def maybe_slow_fault(service):
    """``replica.slow`` (tests only): an alive-but-slow replica — the
    request IS answered, just late, and /healthz stays instant, so only
    the router's latency circuit breaker can see the gray failure.
    Injected before any handling so the delay rides every path (cache
    hit included), like a wedged runtime would.  Blocking — front ends
    must call it off their event loop."""
    faults = getattr(service, "_faults", None)
    if faults is None:
        return
    cfg = faults.config("replica.slow")
    if cfg is not None and should_fire(
            faults, "replica.slow", token=str(service.replica_id)):
        time.sleep(float(cfg.get("delay_s", 1.0)))


def simulate_reply(service, raw):
    """POST /simulate semantics minus the blocking wait.  ``raw`` is the
    request body bytes.  Returns ``(code, obj, headers, wait)``: when
    ``wait`` is None the triple is the final reply; otherwise ``wait``
    is ``(rid, wait_s)`` and the caller must produce the reply via
    :func:`result_reply` once the request completes (or the wait
    expires) — the threaded handler blocks right here, the aio front
    end registers a completion callback instead."""
    try:
        body = json.loads(raw or b"{}")
    except (ValueError, json.JSONDecodeError) as err:
        return 400, {"error": f"bad JSON body: {err}"}, (), None
    if not isinstance(body, dict):
        return 400, {"error": "spec body must be a JSON object"}, (), None
    try:
        wait_s = body.pop("wait", None)
        wait_s = None if wait_s is None else float(wait_s)
        deadline_s = body.pop("deadline_s", None)
        deadline_s = None if deadline_s is None else float(deadline_s)
    except (TypeError, ValueError):
        return 400, {"error": "wait / deadline_s must be numbers"}, (), None
    try:
        rid, status = service.submit(body, deadline_s=deadline_s)
    except SpecError as err:
        return 400, {"error": "invalid spec", "fields": err.errors}, (), None
    except RequestRejected as err:
        code = 503 if err.draining else 429
        return (code, {"error": err.reason,
                       "retry_after_s": err.retry_after_s},
                [("Retry-After", f"{max(err.retry_after_s, 0.001):.3f}")],
                None)
    if wait_s is not None:
        return 0, None, (), (rid, wait_s)
    return (200 if status == "done" else 202,
            {"id": rid, "status": status}, (), None)


def result_reply(service, rid, timeout):
    """GET /result/<id> (and the tail of a waited POST): the reply
    triple for one request id, blocking up to ``timeout`` seconds."""
    from .service import RequestFailed

    try:
        arr = service.result(rid, timeout=timeout)
    except KeyError:
        return 404, {"error": f"unknown request {rid}"}, ()
    except TimeoutError:
        try:
            st = service.status(rid)
        except KeyError:
            st = {"id": rid, "status": "unknown"}
        return 409, {**st, "error": "not done yet"}, ()
    except RequestFailed as err:
        return 410, {"id": rid, "status": err.status,
                     "error": err.detail}, ()
    st = service.status(rid)
    return 200, {
        "id": rid, "status": "done", "cached": st.get("cached", False),
        "shape": list(arr.shape), "dtype": str(arr.dtype),
        "profile": arr.tolist()}, ()


def get_reply(service, path):
    """GET dispatch: the reply triple for ``/healthz``, ``/metrics``,
    ``/status/<id>``, ``/result/<id>`` (non-blocking)."""
    path = path.rstrip("/")
    if path == "/healthz":
        return 200, service.health(), ()
    if path == "/metrics":
        return 200, service.metrics(), ()
    if path.startswith("/status/"):
        rid = path[len("/status/"):]
        try:
            return 200, service.status(rid), ()
        except KeyError:
            return 404, {"error": f"unknown request {rid}"}, ()
    if path.startswith("/result/"):
        return result_reply(service, path[len("/result/"):], timeout=0.0)
    return 404, {"error": f"no such endpoint {path}"}, ()


# ---------------------------------------------------------------------------
# the threaded front end
# ---------------------------------------------------------------------------


class ServeHandler(BaseHTTPRequestHandler):
    server_version = "psrsigsim-serve/1.0"
    protocol_version = "HTTP/1.1"
    # keep-alive responses go out as (headers, body) — two writes; with
    # Nagle on, the body waits for the header segment's (delayed) ACK,
    # a flat ~40 ms stall on EVERY response after a connection's first.
    # The c10k bench measured it; the aio front end sets TCP_NODELAY
    # explicitly for the same reason.
    disable_nagle_algorithm = True

    # the service rides on the server object (make_server attaches it)
    @property
    def service(self):
        return self.server.service

    def log_message(self, fmt, *args):  # quiet: one JSON line per request
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

    # -- POST /simulate ----------------------------------------------------

    def do_POST(self):
        if self.path.rstrip("/") != "/simulate":
            return self._reply(404, {"error": f"no such endpoint {self.path}"})
        maybe_slow_fault(self.service)
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            return self._reply(400, {"error": "bad Content-Length"})
        code, obj, headers, wait = simulate_reply(
            self.service, self.rfile.read(length))
        if wait is not None:
            # one OS thread blocks per waited request — the model the
            # aio front end exists to replace
            code, obj, headers = result_reply(self.service, wait[0],
                                              timeout=wait[1])
        return self._reply(code, obj, headers)

    # -- GETs --------------------------------------------------------------

    def do_GET(self):
        return self._reply(*get_reply(self.service, self.path))


class _ThreadedServer(ThreadingHTTPServer):
    daemon_threads = True
    # the socketserver default backlog of 5 puts any burst of incoming
    # connections into kernel SYN-retransmit backoff (seconds); the
    # c10k client opens hundreds at once even against this fallback
    request_queue_size = 128


def make_server(host="127.0.0.1", port=0, service=None, **service_kw):
    """A ``ThreadingHTTPServer`` bound to (host, port) with a
    :class:`SimulationService` attached (built from ``service_kw`` when
    not given).  ``port=0`` picks a free port (``server.server_port``)."""
    srv = _ThreadedServer((host, port), ServeHandler)
    srv.service = (service if service is not None
                   else SimulationService(**service_kw))
    return srv


def run_server(srv, install_signals=True, ready_cb=None):
    """Serve until SIGTERM/SIGINT, then drain gracefully: stop admitting
    (503 + Retry-After), finish in-flight batches, close the cache
    journal, stop the listener.  Works for both the threaded server and
    :class:`~psrsigsim_torch.serve.aio.AioHTTPServer` (same
    ``serve_forever`` / ``shutdown`` / ``server_close`` surface)."""
    stop = threading.Event()

    def _drain(signum, frame):
        stop.set()
        # shutdown() must come from another thread than serve_forever's
        threading.Thread(target=srv.shutdown, daemon=True).start()

    if install_signals:
        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    if ready_cb is not None:
        ready_cb(srv)
    try:
        srv.serve_forever(poll_interval=0.05)
    finally:
        srv.service.close()
        srv.server_close()
