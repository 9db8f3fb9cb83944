"""Pods: one logical program spread over several processes (counterpart:
psrsigsim_tpu/runtime/dist.py).

A pod is N processes (hosts, or ranks sharing a card) that run the SAME
entry point on the same inputs.  The JAX package joins them with
``jax.distributed`` so that ``jax.devices()`` turns global and every
compiled program shards over a pod-wide mesh.  The port keeps its
single-controller meshes (:mod:`psrsigsim_torch.parallel.mesh`) and adds
the process index to each mesh position: a process runs only its own
positions, and the exchange below gives every process the full result, so
the host logic that follows (journals, writers, result merges) takes the
same branches everywhere.  That lockstep is the pod's consistency model:
the exchange is also the rendezvous (psrsigsim_torch/DIVERGENCES.md P25).

* :func:`init_pod` — joins (or skips) the pod from the ``PSS_POD_*``
  environment or its arguments.  Unconfigured it is a no-op, and every
  helper here reduces to the single-process call (the solo path is
  byte-identical by construction).
* :func:`put_sharded` / :func:`device_get` — staging and fetch on the
  port's :class:`~psrsigsim_torch.parallel.Mesh`.  ``device_get`` follows
  ``PSS_POD_FETCH``: ``channel`` (the default) exchanges the shards over
  the pod channel, with a per-process sequence number and the shapes
  checked on every frame, so a divergence raises "out of lockstep" and
  never assembles the wrong chunk; ``collective`` uses
  ``torch.distributed`` (gloo for host tensors, NCCL for card tensors where
  every rank has a card of its own: two ranks on one card raise).
* :class:`PodChannel` — a leader-rooted TCP side channel (framed pickles
  behind an HMAC-authenticated hello) and the peer-death watchdog: a peer
  that dies turns into an immediate exit with :data:`POD_PEER_EXIT` in
  every survivor, never a hang.
* :func:`pod_key` / :func:`compile_cache_path` — the topology fingerprint
  folded into :func:`~psrsigsim_torch.runtime.programs.trace_env_key`, and
  the per-host-count cache directory.

Host-only: importing this module imports no torch (the export's writers
import the runtime package); the torch parts load inside the functions
that need them.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import socket
import struct
import sys
import threading
import time

__all__ = ["init_pod", "pod_info", "is_pod", "is_leader", "pod_key",
           "put_sharded", "device_get", "local_rows", "pod_process_mesh",
           "compile_cache_path", "PodChannel", "PodPeerLost", "PodInfo",
           "ShardedTensor", "pod_channel", "pod_barrier", "shutdown_pod",
           "POD_PEER_EXIT", "free_ports", "pod_health", "fetch_mode",
           "exchange", "exchange_stats", "check_distinct_cards"]

#: exit code of a process that lost a pod peer mid-run: deterministic and
#: loud, so the supervising layer restarts the whole program group
POD_PEER_EXIT = 73

_FRAME = struct.Struct("!Q")
_BYE = b"\x00POD-BYE\x00"


def free_ports(n=1):
    """``n`` distinct kernel-assigned loopback ports (bind to port 0, read
    the name, close), all held open until the last is bound — the
    coordinator and channel ports of processes about to be spawned."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


class PodPeerLost(RuntimeError):
    """A pod peer died (socket EOF without the clean-shutdown frame)."""


class PodInfo:
    """This process's pod coordinates (immutable after :func:`init_pod`)."""

    def __init__(self, process_id=0, num_processes=1, coordinator=None,
                 channel_port=None, initialized=False):
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.coordinator = coordinator
        self.channel_port = channel_port
        self.initialized = bool(initialized)

    @property
    def is_pod(self):
        return self.initialized and self.num_processes > 1

    @property
    def is_leader(self):
        return self.process_id == 0

    def describe(self):
        return {"process_id": self.process_id,
                "num_processes": self.num_processes,
                "is_pod": self.is_pod}

    def __repr__(self):
        return (f"PodInfo(process_id={self.process_id}, "
                f"num_processes={self.num_processes}, "
                f"initialized={self.initialized})")


_SOLO = PodInfo()
_pod = _SOLO
_channel = None
_group = None      # torch.distributed state of the collective fetch
_lock = threading.Lock()
# this process's exchanges: count, wall seconds, bytes sent and received
_STATS = {"exchanges": 0, "seconds": 0.0, "bytes_sent": 0,
          "bytes_received": 0}


def _env_int(name):
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def fetch_mode():
    """``PSS_POD_FETCH``: ``channel`` (the default) or ``collective``."""
    mode = os.environ.get("PSS_POD_FETCH", "channel").strip().lower()
    if mode not in ("channel", "collective"):
        raise ValueError(f"PSS_POD_FETCH={mode!r}: use channel or "
                         "collective")
    return mode


def init_pod(coordinator=None, num_processes=None, process_id=None,
             channel_port=None, channel=True, timeout_s=60.0):
    """Join (or skip) the pod.  Idempotent.

    Arguments default from the environment: ``PSS_POD_COORDINATOR``
    (``host:port`` of process 0), ``PSS_POD_NUM_PROCESSES``,
    ``PSS_POD_PROCESS_ID``, ``PSS_POD_CHANNEL_PORT`` (default: the
    coordinator's port + 1; the leader binds the channel there).  With no
    coordinator (or ``num_processes`` <= 1) this registers the
    single-process fallback and changes nothing.

    Under ``PSS_POD_FETCH=collective`` the processes also form a
    ``torch.distributed`` group at ``tcp://<coordinator>`` (gloo, plus NCCL
    for card tensors when CUDA is present); the default channel fetch needs
    none, and the coordinator's port is then only the channel's anchor."""
    global _pod, _channel
    with _lock:
        if _pod.initialized:
            return _pod
        coordinator = coordinator or os.environ.get("PSS_POD_COORDINATOR")
        num_processes = (num_processes if num_processes is not None
                         else _env_int("PSS_POD_NUM_PROCESSES"))
        process_id = (process_id if process_id is not None
                      else _env_int("PSS_POD_PROCESS_ID"))
        if not coordinator or not num_processes or num_processes <= 1:
            _pod = PodInfo(initialized=True)
            return _pod
        if process_id is None:
            raise ValueError(
                "pod bootstrap needs a process id: set PSS_POD_PROCESS_ID "
                "(or pass process_id=)")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process id {process_id} outside a pod of "
                             f"{num_processes} processes")
        info = PodInfo(process_id=process_id, num_processes=num_processes,
                       coordinator=str(coordinator), initialized=True)
        if channel:
            port = (channel_port if channel_port is not None
                    else _env_int("PSS_POD_CHANNEL_PORT"))
            if port is None:
                port = int(str(coordinator).rsplit(":", 1)[1]) + 1
            info.channel_port = int(port)
            _channel = PodChannel(info, int(port), timeout_s=timeout_s)
        if fetch_mode() == "collective":
            _init_group(info, timeout_s)
        _pod = info
        return _pod


def _init_group(info, timeout_s):
    """The ``torch.distributed`` group of the collective fetch."""
    global _group
    import datetime

    import torch
    import torch.distributed as tdist

    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    tdist.init_process_group(
        backend=backend, init_method=f"tcp://{info.coordinator}",
        world_size=info.num_processes, rank=info.process_id,
        timeout=datetime.timedelta(seconds=max(timeout_s, 60.0)))
    _group = {"objects": tdist.new_group(backend="gloo"),
              "cards_checked": False}


def pod_info():
    """This process's :class:`PodInfo` (the solo default before
    :func:`init_pod` runs)."""
    return _pod


def pod_channel():
    """The bootstrap :class:`PodChannel` (None when solo / disabled)."""
    return _channel


def is_pod():
    return _pod.is_pod


def is_leader():
    """True when this process owns the pod's host-side effects (journal
    writes, manifests, HTTP endpoints).  Solo processes lead trivially."""
    return _pod.is_leader


def pod_key():
    """The topology fingerprint: independent of the process id (a pod's
    processes resolve identical keys) but aware of the host count (a
    single-process artifact is never served to a pod).  Folded into every
    registry key through
    :func:`~psrsigsim_torch.runtime.programs.trace_env_key`."""
    if not _pod.is_pod:
        return ("solo",)
    return ("pod", _pod.num_processes)


def compile_cache_path(base):
    """The per-topology cache directory: ``base/hosts<N>`` under a pod,
    ``base`` itself when solo.  The port compiles no programs; its kernels
    are shared libraries keyed by their sources in the checkout's
    ``build/`` (``ops/_build.py``), which do not depend on the topology, so
    every process of every pod loads the same files and a joining host
    builds none (DIVERGENCES P25)."""
    if not _pod.is_pod:
        return str(base)
    return os.path.join(str(base), f"hosts{_pod.num_processes}")


def pod_barrier(tag="sync", timeout_s=120.0):
    """Channel-based host barrier (no-op when solo / channel disabled)."""
    if _channel is not None:
        _channel.barrier(tag, timeout_s=timeout_s)


def shutdown_pod():
    """Clean pod teardown: the clean-shutdown frame on every watch socket
    (so peers do not take this exit for a death), then close the channel
    and the collective group.  Safe when solo (no-op)."""
    global _channel, _group
    ch = _channel
    _channel = None
    if ch is not None:
        ch.close()
    if _group is not None:
        _group = None
        import torch.distributed as tdist

        if tdist.is_initialized():
            tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# sharded tensors: staging and fetch
# ---------------------------------------------------------------------------


class ShardedTensor:
    """A global tensor laid out on a mesh (the port's counterpart of a
    jax global array): ``shape`` and ``dtype`` are global, ``shards`` holds
    ``(index, tensor)`` for THIS process's mesh positions only (``index``
    a tuple of slices into the global shape)."""

    def __init__(self, shape, dtype, sharding, shards):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)

    @property
    def is_fully_addressable(self):
        """True when every mesh position is this process's."""
        mesh = self.sharding.mesh
        return bool((mesh.processes == _pod.process_id).all())

    def local(self):
        """This process's ``(global row indices, host block)`` along the
        first axis (:func:`local_rows`)."""
        return local_rows(self)


def _spec_slices(shape, sharding, pos):
    """The global index of mesh position ``pos`` under ``sharding``."""
    mesh = sharding.mesh
    idx = []
    for ax, d in enumerate(shape):
        name = sharding.spec[ax] if ax < len(sharding.spec) else None
        if name is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[name]
        if d % n:
            raise ValueError(f"axis {ax} of size {d} does not split over "
                             f"the {name!r} mesh axis ({n})")
        k = pos[mesh.axis_names.index(name)]
        per = d // n
        idx.append(slice(k * per, (k + 1) * per))
    return tuple(idx)


def put_sharded(x, sharding):
    """Place a (replicated) host value onto ``sharding`` (a
    :class:`~psrsigsim_torch.parallel.mesh.Sharding`): every process calls
    this with the SAME host value and places only its own positions' parts,
    each on its position's device.  Returns a :class:`ShardedTensor`; solo,
    every position is this process's, so the result holds every part
    (:func:`device_get` of it is ``x``)."""
    import numpy as np
    import torch

    arr = np.asarray(x)
    mesh = sharding.mesh
    shards = []
    for pos in np.ndindex(mesh.devices.shape):
        if mesh.processes[pos] != _pod.process_id:
            continue
        idx = _spec_slices(arr.shape, sharding, pos)
        part = np.ascontiguousarray(arr[idx])
        shards.append((idx, torch.from_numpy(part).to(mesh.devices[pos])))
    return ShardedTensor(arr.shape, arr.dtype, sharding, shards)


def _host(t):
    import numpy as np

    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _nbytes(a):
    return a.nbytes if hasattr(a, "nbytes") else a.numel() * a.element_size()


def _dtype_name(a):
    return str(a.dtype).replace("torch.", "")


def _is_cuda(a):
    return getattr(getattr(a, "device", None), "type", None) == "cuda"


def exchange(local, tag=None):
    """Every process's ``local`` dict (``{position: tuple of arrays}``,
    host numpy arrays or tensors, disjoint across processes) merged on
    every process.  Over the channel the other processes' parts arrive as
    host numpy arrays; the collective fetch returns tensors (on the card
    when the parts lie there).

    ``tag`` (any picklable value every process computes alike, such as a
    digest of the batch's keys) rides every frame with the per-process
    sequence number and the arrays' shapes and dtypes; a peer whose frame
    disagrees raises "out of lockstep" — a skipped or extra exchange, or
    shards of another chunk, never assembles into the result.  Solo it
    returns ``local``."""
    if not _pod.is_pod:
        return dict(local)
    t0 = time.perf_counter()
    out = _exchange(local, tag)
    _STATS["exchanges"] += 1
    _STATS["seconds"] += time.perf_counter() - t0
    sent = sum(_nbytes(a) for parts in local.values() for a in parts)
    _STATS["bytes_sent"] += sent
    _STATS["bytes_received"] += sum(
        _nbytes(a) for parts in out.values() for a in parts) - sent
    return out


def exchange_stats(reset=False):
    """This process's exchanges so far: ``{"exchanges", "seconds",
    "bytes_sent", "bytes_received"}`` (payload bytes, whole arrays; the
    leader relays followers' parts, which counts once as received).
    ``reset`` zeroes the counters after reading them."""
    out = dict(_STATS)
    if reset:
        _STATS.update(exchanges=0, seconds=0.0, bytes_sent=0,
                      bytes_received=0)
    return out


def _exchange(local, tag):
    meta = (tag, tuple(sorted(
        (tuple(a.shape), _dtype_name(a)) for parts in local.values()
        for a in parts)))
    if fetch_mode() == "collective":
        return _collective_exchange(local, meta)
    local = {pos: tuple(_host(a) for a in parts)
             for pos, parts in local.items()}
    ch = _channel
    if ch is None:
        raise RuntimeError("pod fetch needs the pod channel (init_pod with "
                           "channel=True), or PSS_POD_FETCH=collective")
    seq = ch.next_fetch_seq()
    if _pod.is_leader:
        out = dict(local)
        peer = {}
        for pid, payload in ch.gather().items():
            kind, got_seq, got_meta, parts = payload
            if kind != "pod-fetch" or got_seq != seq or got_meta != meta:
                raise RuntimeError(
                    f"pod fetch #{seq} {meta!r}: peer {pid} sent "
                    f"{(kind, got_seq, got_meta)!r} — program groups out of "
                    "lockstep")
            out.update(parts)
            peer[pid] = parts
        # each follower receives only the complement of its own shards
        for pid in peer:
            rest = dict(local)
            for other, parts in peer.items():
                if other != pid:
                    rest.update(parts)
            ch.send_to(pid, ("pod-fetch-part", seq, meta, rest))
        return out
    ch.send_to_leader(("pod-fetch", seq, meta, dict(local)))
    kind, got_seq, got_meta, rest = ch.recv()
    if kind != "pod-fetch-part" or got_seq != seq or got_meta != meta:
        raise RuntimeError(
            f"pod fetch #{seq} {meta!r}: leader sent "
            f"{(kind, got_seq, got_meta)!r} — program groups out of "
            "lockstep")
    out = dict(rest)
    out.update(local)
    return out


def check_distinct_cards(records):
    """The collective fetch's NCCL precondition: ``records`` holds one
    ``(hostname, card uuid)`` per rank; two ranks on one card raise (NCCL
    refuses them, and the fetch never switches to gloo on its own)."""
    seen = {}
    for rank, rec in enumerate(records):
        if rec in seen:
            raise RuntimeError(
                f"PSS_POD_FETCH=collective: ranks {seen[rec]} and {rank} "
                f"share one card ({rec[1]} on {rec[0]}); NCCL refuses two "
                "ranks on one GPU.  Give every rank a card of its own, or "
                "use the channel fetch (PSS_POD_FETCH=channel, the default)")
        seen[rec] = rank


def _card_id(device):
    import torch

    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"cuda:{device.index}"


def _check_cards(device):
    """Once per process, with every rank: the ranks' cards are distinct."""
    import socket as _socket

    import torch.distributed as tdist

    if _group.get("cards_checked"):
        return
    recs = [None] * _pod.num_processes
    tdist.all_gather_object(recs, (_socket.gethostname(), _card_id(device)),
                            group=_group["objects"])
    check_distinct_cards([tuple(r) for r in recs])
    _group["cards_checked"] = True


def _collective_exchange(local, meta):
    """:func:`exchange` over ``torch.distributed``: the frames' metadata by
    ``all_gather_object`` on a gloo group, then each part broadcast from
    its owner — host arrays over gloo, card tensors over NCCL (after
    :func:`_check_cards`)."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    if _group is None:
        raise RuntimeError("PSS_POD_FETCH=collective needs the process "
                           "group init_pod builds when that mode is set at "
                           "start-up")
    cards = [a.device for parts in local.values() for a in parts
             if _is_cuda(a)]
    dev = cards[0] if cards else torch.device("cpu")
    seq = _group["seq"] = _group.get("seq", 0) + 1
    heads = [None] * _pod.num_processes
    mine = {pos: tuple((tuple(a.shape), _dtype_name(a)) for a in parts)
            for pos, parts in local.items()}
    tdist.all_gather_object(heads, (seq, meta, dev.type, mine),
                            group=_group["objects"])
    for pid, (got_seq, got_meta, got_dev, _) in enumerate(heads):
        if got_seq != seq or got_meta != meta or got_dev != dev.type:
            raise RuntimeError(
                f"pod fetch #{seq} {meta!r}: rank {pid} sent "
                f"{(got_seq, got_meta, got_dev)!r} — program groups out of "
                "lockstep")
    if dev.type == "cuda":
        _check_cards(dev)
    out = dict(local)
    for pid, (_, _, _, parts) in enumerate(heads):
        for pos in sorted(parts):
            got = []
            for k, (shape, dtype) in enumerate(parts[pos]):
                if pid == _pod.process_id:
                    a = local[pos][k]
                    a = (torch.from_numpy(np.ascontiguousarray(a))
                         if isinstance(a, np.ndarray) else a.contiguous())
                    a = a.to(dev)
                else:
                    a = torch.empty(shape, dtype=getattr(torch, dtype),
                                    device=dev)
                tdist.broadcast(a, src=pid)
                got.append(a)
            if pid != _pod.process_id:
                out[pos] = tuple(got)
    return out


def device_get(tree):
    """Fetch a tree (dicts, lists, tuples) of tensors to host numpy — the
    pod-safe fetch.  Solo: every tensor copied to the host
    (``.cpu().numpy()``), a :class:`ShardedTensor` assembled from its
    parts, anything else returned as it is.  Under a pod a
    :class:`ShardedTensor` whose parts span other processes is exchanged
    (:func:`exchange`), so EVERY process returns the full host value.

    Single-owner rule: one thread per process drives pod exchanges at a
    time (the dispatching thread of a chunk loop, the serving batcher) —
    the channel stream is FIFO, not multiplexed."""
    if isinstance(tree, dict):
        return {k: device_get(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [device_get(v) for v in tree]
        return type(tree)(vals) if isinstance(tree, list) else tuple(vals)
    if isinstance(tree, ShardedTensor):
        return _assemble(tree)
    if hasattr(tree, "detach"):
        return _host(tree)
    return tree


def _assemble(x):
    import numpy as np

    local = {tuple((s.start, s.stop) for s in idx): (_host(t),)
             for idx, t in x.shards}
    parts = local if x.is_fully_addressable else exchange(
        local, tag=("sharded", x.shape, str(x.dtype)))
    out = np.empty(x.shape, x.dtype)
    for key, (block,) in parts.items():
        out[tuple(slice(a, b) for a, b in key)] = _host(block)
    return out


def local_rows(arr):
    """This process's rows of a leading-axis-sharded :class:`ShardedTensor`:
    ``(global_row_indices, host_block)`` (no exchange)."""
    import numpy as np

    shards = sorted(arr.shards, key=lambda s: s[0][0].start or 0)
    idx = np.concatenate([
        np.arange(s[0][0].start or 0,
                  s[0][0].stop if s[0][0].stop is not None
                  else arr.shape[0])
        for s in shards])
    block = np.concatenate([_host(t) for _, t in shards], axis=0)
    return idx, block


def pod_process_mesh(device=None):
    """A 2-D ``(obs, chan)`` mesh with ONE position per pod process, on
    this process's ``device`` (default: the card) — the serving layer's pod
    mesh.  Solo: one position."""
    from ..parallel.mesh import make_mesh
    from ..utils.device import resolve_device

    return make_mesh((_pod.num_processes, 1), [resolve_device(device)])


# ---------------------------------------------------------------------------
# the host-side channel
# ---------------------------------------------------------------------------


def _frame(obj):
    """One channel frame of ``obj``: pickle protocol 5 with the arrays'
    buffers out of band, so a chunk's hundreds of MB are sent from the
    arrays themselves, not copied into the pickle.  ``(head, data,
    buffers)``: the pickle's length, the buffer count and lengths; the
    pickle; the buffers."""
    bufs = []
    data = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = _FRAME.pack(len(data)) + _FRAME.pack(len(raws)) + b"".join(
        _FRAME.pack(r.nbytes) for r in raws)
    return head, data, raws


def _send_frame(sock, frame):
    head, data, raws = frame
    sock.sendall(head)
    sock.sendall(data)
    for r in raws:
        sock.sendall(r)


def _recv_exact(sock, n):
    """``n`` bytes from ``sock``, read into one buffer (a chunk's frame is
    hundreds of MB: no copy beyond it)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise PodPeerLost("pod peer closed the channel mid-frame")
        got += k
    return buf


def _recv_frame(sock):
    """The object of one :func:`_frame`, its buffers received in place."""
    n, k = struct.unpack("!QQ", _recv_exact(sock, 2 * _FRAME.size))
    lens = struct.unpack(f"!{k}Q", _recv_exact(sock, k * _FRAME.size)) \
        if k else ()
    data = _recv_exact(sock, n)
    bufs = [_recv_exact(sock, m) for m in lens]
    return pickle.loads(data, buffers=bufs)


#: the hello is a FIXED-SIZE, HMAC-authenticated frame: the one part of the
#: protocol that reads bytes from a socket that has not proven it is a pod
#: peer, so it never touches pickle and rejects forgeries before a stray
#: connection can claim a follower slot
_HELLO = struct.Struct("!cI")   # kind byte (c=ctl, w=watch) + process id
_HELLO_MAC = hashlib.sha256().digest_size


def _channel_token(info):
    """The shared channel secret: ``PSS_POD_TOKEN`` when the operator sets
    one (required on any non-loopback deployment), else derived from the
    pod coordinates."""
    tok = os.environ.get("PSS_POD_TOKEN")
    if tok:
        return tok.encode()
    return hashlib.sha256(
        f"pss-pod:{info.coordinator}:{info.num_processes}".encode()
    ).digest()


def _hello_frame(kind, pid, token):
    head = _HELLO.pack(b"c" if kind == "ctl" else b"w", pid)
    mac = hmac.new(token, b"pss-pod-hello" + head, hashlib.sha256).digest()
    return head + mac


class PodChannel:
    """Leader-rooted control channel + peer-death watchdog.

    Two sockets per follower: a ``ctl`` stream of length-prefixed pickles
    (read only from peers that proved themselves with the HMAC hello) and a
    ``watch`` stream that carries nothing but the clean-shutdown frame.  A
    watchdog thread blocks on each watch socket; EOF without :data:`_BYE`
    means the peer died, and the default reaction is an immediate
    ``os._exit(POD_PEER_EXIT)``.  ``on_peer_lost`` overrides it (tests).
    """

    def __init__(self, info, port, timeout_s=60.0, on_peer_lost=None):
        self.info = info
        self.port = int(port)
        self._on_peer_lost = on_peer_lost
        self._closing = threading.Event()
        self._ctl = {}     # peer process id -> ctl socket
        self._watch = {}   # peer process id -> watch socket
        self._ctl_lock = threading.Lock()
        self._fetch_seq = 0   # one fetch-driving thread per process
        # the leader binds the coordinator's address (a loopback pod never
        # listens off the box); followers dial it
        host = "127.0.0.1"
        if info.coordinator:
            host = str(info.coordinator).rsplit(":", 1)[0] or host
        self._token = _channel_token(info)
        if info.is_leader:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                srv.bind((host, self.port))
            except OSError:
                srv.bind(("", self.port))
            srv.listen(2 * info.num_processes)
            srv.settimeout(timeout_s)
            self._srv = srv
            need = 2 * (info.num_processes - 1)
            deadline = time.monotonic() + timeout_s
            got = 0
            while got < need:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"pod channel: {need - got} follower socket(s) "
                        f"never connected within {timeout_s}s")
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                # a peer that connects but never sends its hello hits the
                # bootstrap deadline, not a hang
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                try:
                    raw = _recv_exact(conn, _HELLO.size + _HELLO_MAC)
                except (OSError, PodPeerLost):
                    conn.close()
                    continue
                head, mac = raw[:_HELLO.size], raw[_HELLO.size:]
                want = hmac.new(self._token, b"pss-pod-hello" + bytes(head),
                                hashlib.sha256).digest()
                kbyte, pid = _HELLO.unpack(bytes(head))
                store = self._ctl if kbyte == b"c" else self._watch
                if not hmac.compare_digest(bytes(mac), want) or pid in store \
                        or not 0 < pid < info.num_processes:
                    # forged or garbled, or a slot already filled: never
                    # displaces (or counts for) a real follower
                    conn.close()
                    continue
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                store[pid] = conn
                got += 1
        else:
            self._srv = None
            for kind, store in (("ctl", self._ctl), ("watch", self._watch)):
                store[0] = self._connect(host, kind, timeout_s)
        self._watchers = []
        for pid, sock in self._watch.items():
            t = threading.Thread(target=self._watch_peer, args=(pid, sock),
                                 daemon=True, name=f"pss-pod-watch-{pid}")
            t.start()
            self._watchers.append(t)

    def _connect(self, host, kind, timeout_s):
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                s = socket.create_connection((host, self.port), timeout=5.0)
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.sendall(_hello_frame(kind, self.info.process_id,
                                       self._token))
                return s
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"pod channel: leader at port {self.port} never "
                        f"accepted within {timeout_s}s")
                time.sleep(0.05)

    # -- watchdog ----------------------------------------------------------

    def _watch_peer(self, pid, sock):
        # read until EOF or the whole shutdown frame (TCP may split it)
        data = b""
        try:
            while len(data) < len(_BYE):
                chunk = sock.recv(len(_BYE) - len(data))
                if not chunk:
                    break
                data += chunk
        except OSError:
            pass
        if data == _BYE:
            return
        self._peer_dead(pid)

    def _peer_dead(self, pid):
        """One reaction to a peer's death for both detection paths (the
        watch stream's EOF, a :class:`PodPeerLost` on the ctl stream): the
        exit code must not depend on which thread notices first."""
        if self._closing.is_set():
            return   # clean teardown: EOFs are expected
        if self._on_peer_lost is not None:
            self._on_peer_lost(pid)
            return
        print(f"pod: peer process {pid} died (channel EOF); aborting this "
              "program group for a clean supervisor restart",
              file=sys.stderr, flush=True)
        os._exit(POD_PEER_EXIT)

    # -- control traffic ---------------------------------------------------

    def next_fetch_seq(self):
        """The per-process monotonic counter stamped onto every exchange
        frame (one thread per process drives exchanges, so no lock)."""
        self._fetch_seq += 1
        return self._fetch_seq

    def broadcast(self, obj):
        """Leader -> every follower (one frame each, FIFO per peer)."""
        frame = _frame(obj)
        with self._ctl_lock:
            for sock in self._ctl.values():
                _send_frame(sock, frame)

    def send_to(self, pid, obj):
        """Leader -> ONE follower (FIFO on that peer's ctl stream)."""
        frame = _frame(obj)
        with self._ctl_lock:
            _send_frame(self._ctl[pid], frame)

    def recv(self):
        """Follower: the next leader frame (blocks)."""
        try:
            return _recv_frame(self._ctl[0])
        except PodPeerLost:
            self._peer_dead(0)
            raise

    def send_to_leader(self, obj):
        _send_frame(self._ctl[0], _frame(obj))

    def gather(self):
        """Leader: one frame from EVERY follower -> ``{pid: obj}``."""
        out = {}
        for pid, sock in self._ctl.items():
            try:
                out[pid] = _recv_frame(sock)
            except PodPeerLost:
                self._peer_dead(pid)
                raise
        return out

    def barrier(self, tag="sync", timeout_s=120.0):
        """All processes rendezvous: followers report in, the leader
        acknowledges."""
        del timeout_s
        if self.info.is_leader:
            for pid, got in self.gather().items():
                if got != ("barrier", tag):
                    raise RuntimeError(
                        f"pod barrier {tag!r}: peer {pid} sent {got!r} "
                        "(program groups out of lockstep)")
            self.broadcast(("barrier-ack", tag))
        else:
            self.send_to_leader(("barrier", tag))
            got = self.recv()
            if got != ("barrier-ack", tag):
                raise RuntimeError(
                    f"pod barrier {tag!r}: leader sent {got!r} "
                    "(program groups out of lockstep)")

    def close(self):
        """Clean shutdown: BYE on every watch socket, close everything.
        Idempotent."""
        if self._closing.is_set():
            return
        self._closing.set()
        for sock in self._watch.values():
            try:
                sock.sendall(_BYE)
            except OSError:
                pass
        for sock in list(self._ctl.values()) + list(self._watch.values()):
            try:
                sock.close()
            except OSError:
                pass
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass


def pod_health():
    """JSON-ready pod status for ``/healthz``-style consumers."""
    info = _pod.describe()
    info["channel"] = _channel is not None
    return info


def _reset_for_tests():
    """TESTS ONLY: forget the pod state (the solo fallback returns)."""
    global _pod, _channel
    if _channel is not None:
        _channel.close()
    _pod = _SOLO
    _channel = None


def fake_pod_for_tests(num_processes, process_id=0):
    """TESTS ONLY: install a :class:`PodInfo` without a channel — the
    simulated topology the key audit runs across.  Returns the previous
    state so callers can restore it."""
    global _pod
    prev = _pod
    _pod = PodInfo(process_id=process_id, num_processes=num_processes,
                   initialized=True)
    return prev
