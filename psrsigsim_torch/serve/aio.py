"""Event-loop HTTP/1.1 front end: C10k serving over one selector
(counterpart: psrsigsim_tpu/serve/aio.py; host only).

The stdlib ``ThreadingHTTPServer`` (:mod:`psrsigsim_torch.serve.http`)
spends one OS thread per CONNECTION — the hard ceiling ROADMAP item 2
names on concurrent load: ten thousand keep-alive clients would mean
ten thousand blocked threads before a single request is even parsed.
:class:`AioHTTPServer` is the dependency-free replacement: a
``selectors``-based non-blocking server where connection count and
work capacity are decoupled —

* **One event loop** owns every socket: accept, incremental HTTP/1.1
  request parsing (keep-alive, pipelined-safe: per-connection response
  slots preserve request order), bounded per-connection read buffers
  and pending-response windows, idle-connection reaping, and
  non-blocking writes.
* **A small fixed worker pool** (``PSS_AIO_WORKERS``) runs the endpoint
  semantics — the SAME ``*_reply`` functions the threaded server uses
  (:mod:`psrsigsim_torch.serve.http`), so response bodies are
  byte-identical whichever front end served them.
* **Waited POSTs block no thread**: a ``"wait"`` submit registers a
  completion callback on the :class:`SimulationService` request
  (``on_done``) plus a deadline entry in the loop's timing heap; the
  response is built when the batcher completes the request (or the
  wait expires), never by parking a thread on an Event.  Admission is
  therefore decoupled from connection count: thousands of sockets
  multiplex onto the loop while the service's bounded queue stays the
  only backpressure point.
* **Zero-copy hot responses**: the JSON ``"profile"`` fragment of a
  200 ``/result`` body — the dominant bytes of every served result,
  immutable by content address — is rendered ONCE per ``spec_hash``
  into a byte-bounded LRU (:class:`~psrsigsim_torch.serve.cache.ByteLRU`)
  and every subsequent response enqueues ``memoryview`` slices of the
  shared buffer instead of re-``tolist``-ing, re-``dumps``-ing, and
  re-copying per request.  Together with the cache's in-memory hot
  tier, a repeated viral spec is served with zero disk reads, zero
  re-hashing, zero device calls, and zero per-request body copies.

Admission overload is explicit: past ``max_conns`` (default
``PSS_AIO_MAX_CONNS`` = 10000) a fresh connection receives a one-shot
503 and is closed — never silently stalled in an accept backlog.

The server exposes the same ``serve_forever`` / ``shutdown`` /
``server_close`` / ``server_port`` / ``service`` surface as the
threaded server, so ``run_server`` (signal-driven drain) and the
one-line ready protocol work unchanged; ``--frontend aio`` in
``python -m psrsigsim_torch.serve`` selects it.  ``stats()`` feeds the
front-end gauges (open connections, event-loop lag, pending write
bytes) into ``/healthz`` and ``/metrics`` via the service hook, where
the fleet autoscaler's ``load_signal()`` can see connection pressure.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import selectors
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from .cache import ByteLRU
from .http import get_reply, maybe_slow_fault, result_reply, simulate_reply

__all__ = ["AioHTTPServer", "make_aio_server", "DEFAULT_MAX_CONNS"]

DEFAULT_MAX_CONNS = 10000

_MAX_HEADER_BYTES = 64 * 1024      # request line + headers cap
_MAX_BODY_BYTES = 1 << 20          # request body cap (specs are tiny)
_MAX_PIPELINE = 16                 # parsed-but-unanswered per connection
_RECVS_PER_EVENT = 4               # fairness: bounded reads per wakeup

_OVERLOAD_BODY = b'{"error": "connection limit"}'
_OVERLOAD_RESPONSE = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: %d\r\n"
    b"Connection: close\r\n\r\n%s" % (len(_OVERLOAD_BODY), _OVERLOAD_BODY))


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return int(default)


class _Conn:
    """Per-connection state, mutated only on the event-loop thread
    (workers hand finished responses back via the notify queue)."""

    __slots__ = ("sock", "fd", "rbuf", "out", "out_bytes", "slots",
                 "last_active", "want_write", "close_after", "closed")

    def __init__(self, sock):
        self.sock = sock
        self.fd = sock.fileno()
        self.rbuf = bytearray()
        self.out = collections.deque()   # memoryviews pending send
        self.out_bytes = 0
        self.slots = collections.deque()  # in-order response slots
        self.last_active = time.monotonic()
        self.want_write = False
        self.close_after = False   # half-close once slots drain
        self.closed = False


class _Slot:
    """One parsed request's response placeholder (pipeline ordering:
    responses go out strictly in request order, whatever order the
    worker pool finishes them in)."""

    __slots__ = ("buffers", "close", "fired")

    def __init__(self):
        self.buffers = None   # list of buffer objects once ready
        self.close = False    # Connection: close after this response
        self.fired = False    # wait-deferral consumed (on_done/deadline)


class AioHTTPServer:
    """Selector-based non-blocking HTTP/1.1 JSON server over a
    :class:`~psrsigsim_torch.serve.service.SimulationService`.

    Parameters
    ----------
    host, port :
        Bind address; ``port=0`` picks a free port (``server_port``).
    service : SimulationService
        The request engine (registered as its ``frontend`` for
        health/metrics gauges).
    max_conns : int
        Open-connection admission bound (503 + close past it).
        Default ``PSS_AIO_MAX_CONNS`` (10000).
    workers : int
        Handler worker-pool size (``PSS_AIO_WORKERS``, default 4) —
        capacity for endpoint execution, NOT a per-connection cost.
    idle_timeout_s : float
        Keep-alive connections idle past this are reaped.
    body_memo_bytes : int
        Byte budget of the rendered-``profile`` LRU (zero-copy hot
        responses); defaults to 64 MiB.
    """

    def __init__(self, host="127.0.0.1", port=0, service=None,
                 max_conns=None, workers=None, idle_timeout_s=300.0,
                 body_memo_bytes=64 << 20):
        if service is None:
            raise ValueError("AioHTTPServer requires a SimulationService")
        self.service = service
        self.max_conns = int(max_conns if max_conns is not None
                             else _env_int("PSS_AIO_MAX_CONNS",
                                           DEFAULT_MAX_CONNS))
        self.idle_timeout_s = float(idle_timeout_s)
        self._listener = socket.create_server(
            (host, port), backlog=min(self.max_conns, 1024),
            reuse_port=False)
        self._listener.setblocking(False)
        self.server_address = self._listener.getsockname()
        self.server_port = self.server_address[1]
        self._sel = selectors.DefaultSelector()
        self._conns = {}                  # fd -> _Conn
        self._notify = collections.deque()  # callables for the loop thread
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._stop = threading.Event()
        self._started = threading.Event()
        self._waits = []                  # (deadline, seq, conn, slot, rid)
        self._wait_seq = 0
        self._pool = ThreadPoolExecutor(
            max_workers=int(workers if workers is not None
                            else _env_int("PSS_AIO_WORKERS", 4)),
            thread_name_prefix="pss-aio")
        self._memo_lock = threading.Lock()
        self._body_memo = ByteLRU(int(body_memo_bytes))
        self._memo_hits = 0
        # counters (loop thread writes; stats() reads — int reads are
        # atomic enough for telemetry)
        self.accepted = 0
        self.closed_conns = 0
        self.requests = 0
        self.overflow_rejects = 0
        self.reaped_idle = 0
        self.parse_errors = 0
        self.peak_connections = 0
        self._lag_ewma = 0.0
        self._last_gauge_t = 0.0
        # stats() runs on WORKER threads (/healthz, /metrics) while the
        # loop mutates _conns and _waits: aggregates that would require
        # iterating those structures are cached here by the loop's tick
        # so foreign threads only ever read scalars
        self._pending_write_bytes = 0
        self._pending_waits = 0
        # the service folds our stats into /healthz and /metrics
        service.frontend = self

    # -- public stats ------------------------------------------------------

    def stats(self):
        """JSON-ready front-end gauges: connection census, event-loop
        lag (EWMA of loop-iteration processing time — how long a ready
        event waits behind the current burst), pending write backlog,
        and the zero-copy body-memo footprint.  Called from worker
        threads, so it reads only scalars (``len`` is atomic; the
        backlog aggregates are cached by the loop's tick) — never
        iterating structures the loop thread mutates."""
        with self._memo_lock:
            memo = {"entries": len(self._body_memo),
                    "bytes": self._body_memo.bytes,
                    "evictions": self._body_memo.evictions,
                    "hits": self._memo_hits}
        return {
            "kind": "aio",
            "open_connections": len(self._conns),
            "peak_connections": self.peak_connections,
            "max_conns": self.max_conns,
            "accepted": self.accepted,
            "closed": self.closed_conns,
            "requests": self.requests,
            "overflow_rejects": self.overflow_rejects,
            "reaped_idle": self.reaped_idle,
            "parse_errors": self.parse_errors,
            "loop_lag_s": round(self._lag_ewma, 6),
            "pending_write_bytes": self._pending_write_bytes,
            "pending_waits": self._pending_waits,
            "body_memo": memo,
        }

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self, poll_interval=0.05):
        """The event loop (runs on the calling thread until
        :meth:`shutdown`)."""
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._started.set()
        try:
            while not self._stop.is_set():
                timeout = float(poll_interval)
                if self._waits:
                    timeout = min(
                        timeout, max(self._waits[0][0] - time.monotonic(),
                                     0.0))
                events = self._sel.select(timeout)
                t0 = time.monotonic()
                self._run_notified()
                for key, mask in events:
                    if key.data == "accept":
                        self._accept_burst()
                    elif key.data == "wake":
                        self._drain_wakeups()
                    else:
                        conn = key.data
                        if mask & selectors.EVENT_READ:
                            self._on_readable(conn)
                        if mask & selectors.EVENT_WRITE and not conn.closed:
                            self._on_writable(conn)
                self._fire_expired_waits()
                self._tick(t0)
        finally:
            self._teardown()

    def shutdown(self):
        """Stop the loop (callable from any thread); pending responses
        are flushed best-effort during teardown."""
        self._stop.set()
        self._wake()

    def server_close(self):
        self._pool.shutdown(wait=False)
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            self._wake_w.close()
            self._wake_r.close()
        except OSError:
            pass

    def _teardown(self):
        """Loop exit: stop accepting, flush pending writes briefly,
        close every connection."""
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        deadline = time.monotonic() + 2.0
        while (time.monotonic() < deadline
               and any(c.out or any(s.buffers is not None
                                    for s in c.slots)
                       for c in self._conns.values())):
            events = self._sel.select(0.05)
            self._run_notified()
            for key, mask in events:
                if key.data == "wake":
                    self._drain_wakeups()
                elif isinstance(key.data, _Conn):
                    if mask & selectors.EVENT_WRITE:
                        self._on_writable(key.data)
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        self._sel.close()

    # -- cross-thread plumbing ---------------------------------------------

    def _wake(self):
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass   # already pending / closing: the loop will wake anyway

    def _drain_wakeups(self):
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _run_notified(self):
        while self._notify:
            fn = self._notify.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 - the loop must live
                pass

    def _call_soon(self, fn):
        """Schedule ``fn`` on the event-loop thread (worker threads'
        only entry point back into connection state)."""
        self._notify.append(fn)
        self._wake()

    # -- accept / read / parse ---------------------------------------------

    def _accept_burst(self):
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            if len(self._conns) >= self.max_conns:
                # explicit overload: a one-shot 503, never a silent
                # stall in the backlog
                self.overflow_rejects += 1
                try:
                    sock.setblocking(False)
                    sock.send(_OVERLOAD_RESPONSE)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[conn.fd] = conn
            self.accepted += 1
            self.peak_connections = max(self.peak_connections,
                                        len(self._conns))
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _on_readable(self, conn):
        for _ in range(_RECVS_PER_EVENT):
            try:
                data = conn.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return self._close_conn(conn)
            if not data:
                return self._close_conn(conn)
            conn.rbuf += data
            if len(data) < 65536:
                break
        conn.last_active = time.monotonic()
        if len(conn.rbuf) > _MAX_HEADER_BYTES + _MAX_BODY_BYTES:
            return self._fail_conn(conn, 431, "request too large")
        self._parse_conn(conn)

    def _parse_conn(self, conn):
        """Consume complete pipelined requests from the read buffer (in
        order, bounded by the pending-response window)."""
        while not conn.closed and not conn.close_after \
                and len(conn.slots) < _MAX_PIPELINE:
            head_end = conn.rbuf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(conn.rbuf) > _MAX_HEADER_BYTES:
                    self._fail_conn(conn, 431, "headers too large")
                return
            head = bytes(conn.rbuf[:head_end]).decode(
                "latin-1", "replace")
            lines = head.split("\r\n")
            parts = lines[0].split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                self.parse_errors += 1
                return self._fail_conn(conn, 400, "malformed request line")
            method, path, version = parts
            headers = {}
            for ln in lines[1:]:
                k, sep, v = ln.partition(":")
                if sep:
                    headers[k.strip().lower()] = v.strip()
            if "chunked" in headers.get("transfer-encoding", "").lower():
                self.parse_errors += 1
                return self._fail_conn(conn, 501,
                                       "chunked bodies unsupported")
            try:
                clen = int(headers.get("content-length", "0"))
            except ValueError:
                self.parse_errors += 1
                return self._fail_conn(conn, 400, "bad Content-Length")
            if clen > _MAX_BODY_BYTES:
                return self._fail_conn(conn, 413, "body too large")
            total = head_end + 4 + clen
            if len(conn.rbuf) < total:
                return                      # body still in flight
            body = bytes(conn.rbuf[head_end + 4:total])
            del conn.rbuf[:total]
            conn_hdr = headers.get("connection", "").lower()
            close = (conn_hdr == "close"
                     or (version == "HTTP/1.0"
                         and conn_hdr != "keep-alive"))
            slot = _Slot()
            slot.close = close
            conn.slots.append(slot)
            if close:
                conn.close_after = True     # no parse past a final request
            self.requests += 1
            self._pool.submit(self._handle, conn, slot, method, path, body)

    # -- handler execution (worker threads) --------------------------------

    def _handle(self, conn, slot, method, path, body):
        try:
            if method == "POST":
                if path.rstrip("/") != "/simulate":
                    return self._finish_json(
                        conn, slot, 404,
                        {"error": f"no such endpoint {path}"}, ())
                maybe_slow_fault(self.service)
                code, obj, headers, wait = simulate_reply(self.service,
                                                          body)
                if wait is not None:
                    rid, wait_s = wait
                    return self._defer_wait(conn, slot, rid, wait_s)
                return self._finish_json(conn, slot, code, obj, headers)
            if method == "GET":
                fast = self._result_fast(path)
                if fast is not None:
                    return self._call_soon(
                        lambda: self._slot_ready(conn, slot, fast))
                return self._finish_json(
                    conn, slot, *get_reply(self.service, path))
            if method == "HEAD":
                # headers only — a body after HEAD desyncs the
                # keep-alive stream; unsupported (like the threaded
                # front end) and the connection closes after it
                slot.close = True
                buffers = [self._http_head(501, 0,
                                           [("Connection", "close")])]
                return self._call_soon(
                    lambda: self._slot_ready(conn, slot, buffers))
            return self._finish_json(
                conn, slot, 405, {"error": f"method {method} not allowed"},
                ())
        except Exception as err:  # noqa: BLE001 - reply, don't leak a slot
            self._finish_json(conn, slot, 500,
                              {"error": f"{type(err).__name__}: {err}"}, ())

    def _defer_wait(self, conn, slot, rid, wait_s):
        """A waited POST: no thread parks on the request — completion
        fires a callback, the wait deadline rides the loop's heap, and
        whichever happens first builds the reply (``result_reply`` with
        timeout 0 resolves both cases correctly)."""
        def arm():
            self._wait_seq += 1
            heapq.heappush(
                self._waits,
                (time.monotonic() + max(float(wait_s), 0.0),
                 self._wait_seq, conn, slot, rid))

        def fire():   # from the batcher thread, via on_done
            self._call_soon(lambda: self._consume_wait(conn, slot, rid))

        self._call_soon(arm)
        self.service.on_done(rid, fire)

    def _consume_wait(self, conn, slot, rid):
        """Loop thread: resolve one waited request at most once."""
        if slot.fired or conn.closed:
            return
        slot.fired = True
        self._pool.submit(self._finish_wait, conn, slot, rid)

    def _finish_wait(self, conn, slot, rid):
        try:
            code, obj, headers = result_reply(self.service, rid,
                                              timeout=0.0)
        except Exception as err:  # noqa: BLE001
            code, obj, headers = 500, {
                "error": f"{type(err).__name__}: {err}"}, ()
        self._finish_json(conn, slot, code, obj, headers)

    def _fire_expired_waits(self):
        now = time.monotonic()
        while self._waits and self._waits[0][0] <= now:
            _, _, conn, slot, rid = heapq.heappop(self._waits)
            self._consume_wait(conn, slot, rid)

    # -- response rendering -------------------------------------------------

    _REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request",
                404: "Not Found", 405: "Method Not Allowed",
                409: "Conflict", 410: "Gone", 413: "Payload Too Large",
                429: "Too Many Requests", 431: "Headers Too Large",
                500: "Internal Server Error", 501: "Not Implemented",
                503: "Service Unavailable"}

    def _http_head(self, code, blen, headers=()):
        """THE status-line/header rendering — one implementation for
        the cold path, the hot path, and protocol errors, so the byte
        layout can never drift between them."""
        hdr = [f"HTTP/1.1 {code} {self._REASONS.get(code, 'Status')}",
               "Server: psrsigsim-serve-aio/1.0",
               "Content-Type: application/json",
               f"Content-Length: {blen}"]
        for k, v in headers:
            hdr.append(f"{k}: {v}")
        return ("\r\n".join(hdr) + "\r\n\r\n").encode("latin-1")

    @staticmethod
    def _splice_profile(head_obj, frag):
        """Body buffers for a result object whose ``profile`` fragment
        is rendered separately (the zero-copy memo): byte-identical to
        ``json.dumps`` of the full object because ``profile`` is the
        object's last key.  Shared by the cold and hot render paths —
        the splice format lives in exactly one place."""
        head = json.dumps(head_obj)[:-1].encode() + b', "profile": '
        return [head, memoryview(frag), b"}"], len(head) + len(frag) + 1

    def _result_fast(self, path):
        """The zero-copy hot path for ``GET /result/<rid>``: when the
        profile fragment is already rendered in the memo AND the
        request is terminally done, build the (small, state-accurate)
        head per request and enqueue the shared fragment — no
        ``tolist``, no re-``dumps``, no artifact decode, no disk.
        Returns response buffers or None (fall through to the full
        path).  The head is NEVER memoized: its ``cached`` flag is live
        service state, so the rendered bytes stay identical to what the
        threaded front end would serve right now."""
        p = path.rstrip("/")
        if not p.startswith("/result/"):
            return None
        rid = p[len("/result/"):]
        with self._memo_lock:
            ent = self._body_memo.get(rid)
            if ent is not None:
                self._memo_hits += 1
        if ent is None:
            return None
        frag, shape, dtype = ent
        try:
            st = self.service.status(rid)
        except KeyError:
            return None
        if st.get("status") != "done":
            return None
        obj = {"id": rid, "status": "done",
               "cached": st.get("cached", False),
               "shape": shape, "dtype": dtype}
        body_parts, blen = self._splice_profile(obj, frag)
        return [self._http_head(200, blen)] + body_parts

    def _render(self, code, obj, headers):
        """Response buffers for one reply triple.  200 ``/result``
        bodies split into a per-request head plus the memoized
        ``profile`` fragment (immutable by content address), so the hot
        path enqueues a shared ``memoryview`` instead of re-serializing
        kilobytes of JSON per request — rendered bytes are identical to
        ``json.dumps`` of the whole object because ``profile`` is the
        object's last key."""
        if (code == 200 and isinstance(obj, dict)
                and obj.get("status") == "done" and "profile" in obj):
            rid = obj.get("id")
            with self._memo_lock:
                ent = self._body_memo.get(rid)
                if ent is not None:
                    self._memo_hits += 1
            frag = ent[0] if ent is not None else None
            if frag is None:
                frag = json.dumps(obj["profile"]).encode()
                with self._memo_lock:
                    self._body_memo.put(
                        rid, (frag, list(obj.get("shape", [])),
                              obj.get("dtype")), len(frag))
            head_obj = {k: v for k, v in obj.items() if k != "profile"}
            body_parts, blen = self._splice_profile(head_obj, frag)
        else:
            body = json.dumps(obj).encode()
            body_parts, blen = [body], len(body)
        return [self._http_head(code, blen, headers)] + body_parts

    def _finish_json(self, conn, slot, code, obj, headers):
        """Worker -> loop hand-off: attach the rendered buffers to the
        slot and let the loop flush in pipeline order."""
        buffers = self._render(code, obj, headers)
        self._call_soon(lambda: self._slot_ready(conn, slot, buffers))

    def _slot_ready(self, conn, slot, buffers):
        if conn.closed:
            return
        slot.buffers = buffers
        self._flush_slots(conn)

    def _fail_conn(self, conn, code, msg):
        """Protocol-level failure: answer (out of band — parsing is
        wedged anyway) and close after the write drains."""
        conn.close_after = True
        conn.rbuf.clear()
        slot = _Slot()
        slot.close = True
        conn.slots.append(slot)
        slot.buffers = self._render(code, {"error": msg},
                                    [("Connection", "close")])
        self._flush_slots(conn)

    # -- write path ---------------------------------------------------------

    def _flush_slots(self, conn):
        """Move in-order ready responses to the write queue; update the
        selector's write interest; opportunistically send."""
        moved = False
        while conn.slots and conn.slots[0].buffers is not None:
            slot = conn.slots.popleft()
            for part in slot.buffers:
                mv = part if isinstance(part, memoryview) \
                    else memoryview(part)
                conn.out.append(mv)
                conn.out_bytes += len(mv)
            if slot.close:
                conn.close_after = True
            moved = True
        if moved:
            self._on_writable(conn)
        # freed pipeline slots: resume parsing buffered pipelined
        # requests deferred by the window cap
        if conn.rbuf and not conn.closed \
                and len(conn.slots) < _MAX_PIPELINE:
            self._parse_conn(conn)

    def _set_write_interest(self, conn, want):
        if conn.closed or want == conn.want_write:
            return
        conn.want_write = want
        mask = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _on_writable(self, conn):
        while conn.out:
            mv = conn.out[0]
            try:
                sent = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return self._close_conn(conn)
            conn.out_bytes -= sent
            if sent == len(mv):
                conn.out.popleft()
            else:
                conn.out[0] = mv[sent:]
                break
        conn.last_active = time.monotonic()
        if conn.out:
            self._set_write_interest(conn, True)
        else:
            self._set_write_interest(conn, False)
            if conn.close_after and not conn.slots:
                self._close_conn(conn)

    # -- close / reap / gauges ----------------------------------------------

    def _close_conn(self, conn):
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.fd, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.out.clear()
        conn.out_bytes = 0
        self.closed_conns += 1

    def _tick(self, t0):
        """Per-iteration bookkeeping: loop-lag EWMA, periodic idle
        reaping, periodic gauge export into the service's StageTimers
        (the existing counter/gauge API — nothing new to scrape)."""
        proc = time.monotonic() - t0
        self._lag_ewma = (proc if self._lag_ewma == 0.0
                          else 0.2 * proc + 0.8 * self._lag_ewma)
        now = time.monotonic()
        if now - self._last_gauge_t < 0.25:
            return
        self._last_gauge_t = now
        # cached aggregates for stats() (loop thread owns the iteration)
        self._pending_write_bytes = sum(
            c.out_bytes for c in self._conns.values())
        self._pending_waits = sum(1 for e in self._waits
                                  if not e[3].fired)
        if self.idle_timeout_s > 0:
            cutoff = now - self.idle_timeout_s
            for conn in [c for c in self._conns.values()
                         if c.last_active < cutoff
                         and not c.out and not c.slots]:
                self.reaped_idle += 1
                self._close_conn(conn)
        timers = self.service.timers
        timers.set_gauges({
            "open_connections": len(self._conns),
            "loop_lag_s": round(self._lag_ewma, 6),
            "pending_write_bytes": self._pending_write_bytes,
        })


def make_aio_server(host="127.0.0.1", port=0, service=None, **kw):
    """The aio twin of :func:`~psrsigsim_torch.serve.http.make_server`:
    an :class:`AioHTTPServer` bound to (host, port) over ``service``
    (built from remaining kwargs when not given)."""
    if service is None:
        from .service import SimulationService

        service_kw = {k: v for k, v in kw.items()
                      if k not in ("max_conns", "workers",
                                   "idle_timeout_s", "body_memo_bytes")}
        kw = {k: v for k, v in kw.items() if k not in service_kw}
        service = SimulationService(**service_kw)
    return AioHTTPServer(host, port, service=service, **kw)
