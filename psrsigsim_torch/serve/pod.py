"""Pod-spanning serving: one replica = one pod program group (counterpart:
psrsigsim_tpu/serve/pod.py).

Under a pod (:mod:`psrsigsim_torch.runtime.dist`) a replica is a GROUP:
the leader process owns the HTTP endpoint, the result cache and the request
queue — exactly the single-process serving engine — while follower
processes own the other hosts' cards (or share the leader's) and run their
slab of every batch.  The division of labor:

* :class:`PodProgramRegistry` (leader) — a drop-in
  :class:`~psrsigsim_torch.serve.programs.ProgramRegistry` whose buckets
  span the pod: a batch's rows split one slab a process over
  :func:`~psrsigsim_torch.runtime.dist.pod_process_mesh`, bucket widths
  rounded up to multiples of the process count.  ``execute`` broadcasts
  each batch's inputs over the pod channel BEFORE it runs its own slab, so
  followers run the same bucket on the same batch in the same order; the
  pod exchange that assembles the batch is the rendezvous.  Registry keys
  carry the pod topology (family ``serve_pod_bucket`` +
  :func:`~psrsigsim_torch.runtime.programs.trace_env_key`).
* :func:`pod_serve_follower` — a follower's whole life: obey the leader's
  ``register`` / ``exec`` / ``shutdown`` stream.  Followers have no HTTP
  socket, no cache and no queue; a follower's death surfaces through the
  channel watchdog as a loud group exit the fleet supervisor restarts
  whole (:class:`~psrsigsim_torch.serve.ReplicaFleet` ``group_hosts``).

Byte identity: every response row depends only on its request's key and
parameters (solo == coalesced == any width, the serving layer's batching
contract), and a process's slab is just another bucket width — pod
responses are bit-identical to a single-process replica's.

Keys cross the channel as raw uint32 words, as the single-process buckets
take them.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from .programs import DEFAULT_WIDTHS, ProgramRegistry

__all__ = ["PodProgramRegistry", "build_pod_bucket_fn",
           "pod_serve_follower"]

_FAMILY = "serve_pod_bucket"


def build_pod_bucket_fn(cfg, profiles, scenario, mesh, device=None):
    """The pod twin of
    :func:`~psrsigsim_torch.parallel.build_width_bucket_fn`: the same
    per-row physics over ``mesh``'s obs axis, one slab of the batch a
    position, taking raw key words (uint32 ``(B, 2)``).  Returns ``fn(kd,
    dms, norms, nulls, sc=None, exchange=True)``: this process's slabs run
    on its device, then (with ``exchange``) the pod exchange gives every
    process the whole ``(B, Nchan, Nph)`` batch on ``device``; without it,
    only this process's slabs (the warm run of a build)."""
    import torch

    from ..parallel._collectives import gather_grid
    from ..parallel.ensemble import build_width_bucket_fn
    from ..parallel.mesh import OBS_AXIS

    base = build_width_bucket_fn(cfg, profiles, scenario=scenario,
                                 device=device)
    n = mesh.shape[OBS_AXIS]

    def fn(kd, dms, norms, nulls, sc=None, exchange=True):
        kd = np.asarray(kd, np.uint32)
        width = kd.shape[0]
        if width % n:
            raise ValueError(f"a pod bucket of width {width} does not split "
                             f"over {n} processes")
        per = width // n
        grid = []
        for i in range(n):
            if not mesh.is_local((i, 0)):
                grid.append([None])
                continue
            sl = slice(i * per, (i + 1) * per)
            args = (kd[sl], np.asarray(dms)[sl], np.asarray(norms)[sl],
                    np.asarray(nulls)[sl])
            if sc is not None:
                args = args + (np.asarray(sc)[sl],)
            grid.append([base(*args)])
        if not exchange:
            return torch.cat([row[0] for row in grid if row[0] is not None])
        tag = hashlib.sha256(kd.tobytes()).hexdigest()[:16]
        return gather_grid(grid, (0, None), mesh.first_device, tag=tag)

    return fn


class PodProgramRegistry(ProgramRegistry):
    """Leader-side registry of pod-spanning serving buckets (followers run
    one with ``channel=None``: they execute what the leader broadcasts and
    broadcast nothing).  ``device``: this process's card (default) or
    ``"cpu"``."""

    def __init__(self, widths=DEFAULT_WIDTHS, compile_cache_dir=None,
                 channel=None, device=None):
        from ..runtime.dist import pod_info, pod_process_mesh

        self._pod = pod_info()
        self._channel = channel
        nproc = max(1, self._pod.num_processes)
        # bucket widths must tile the one-position-a-process mesh: each
        # rounds up to a multiple of the process count (rows pad by
        # wrapping, and a row's bytes do not depend on the width)
        rounded = sorted({int(w) + (-int(w)) % nproc if w >= nproc
                          else nproc for w in widths})
        super().__init__(rounded, compile_cache_dir=compile_cache_dir,
                         device=device)
        self._mesh = pod_process_mesh(self.device)
        # one frame-exchange window at a time: a register broadcast landing
        # between an exec frame and its exchange would reach the follower
        # in the middle of the exchange
        self._stream_lock = threading.RLock()

    def register(self, geom_hash, cfg, profiles, noise_norm, warmup=True,
                 scenario=None, canonical=None):
        with self._stream_lock:
            if self._channel is not None and canonical is not None:
                # followers rebuild the identical geometry from the
                # canonical spec and warm the same widths
                self._channel.broadcast({"op": "register",
                                         "canonical": dict(canonical)})
            super().register(geom_hash, cfg, profiles, noise_norm,
                             warmup=warmup, scenario=scenario)

    def program(self, geom_hash, width):
        from ..runtime.programs import trace_env_key

        with self._lock:
            cfg, profiles, _ = self._geoms[geom_hash]
            stack = self._stacks[geom_hash]

        def _build():
            fn = build_pod_bucket_fn(cfg, profiles, stack, self._mesh,
                                     device=self.device)
            # the warm run covers this process's slabs only: a build never
            # exchanges, so leader and followers may build at any time
            fn(*self._example_inputs(int(width), stack),
               exchange=False).cpu()
            return fn

        return self._store.get_or_build(
            (_FAMILY, geom_hash, int(width), trace_env_key(self.device)),
            _build)

    def execute_device(self, geom_hash, width, keys, dms, norms, null_fracs,
                       sc=None):
        kd = np.asarray(keys, np.uint32)
        dms = np.asarray(dms, np.float32)
        norms = np.asarray(norms, np.float32)
        nulls = np.asarray(null_fracs, np.float32)
        sc = None if sc is None else np.asarray(sc, np.float32)
        with self._stream_lock:
            # the exec frame and its exchange are ONE frame-exchange window
            if self._channel is not None:
                self._channel.broadcast({
                    "op": "exec", "gh": geom_hash, "width": int(width),
                    "kd": kd, "dms": dms, "norms": norms, "nulls": nulls,
                    "sc": sc})
            out = self.execute_local(geom_hash, int(width), kd, dms, norms,
                                     nulls, sc)
        key = (geom_hash, int(width))
        with self._lock:
            self.device_calls += 1
            self._calls[key] = self._calls.get(key, 0) + 1
        return out

    def execute_local(self, geom_hash, width, kd, dms, norms, nulls, sc):
        """One pod dispatch from raw inputs (the follower's entry; the
        leader's :meth:`execute_device` lands here after broadcasting).
        Returns the WHOLE batch on this process's device."""
        prog = self.program(geom_hash, width)
        return prog(kd, dms, norms, nulls, sc)

    def shutdown_followers(self):
        """Broadcast the clean end of the stream (the leader's drain)."""
        with self._stream_lock:
            if self._channel is not None:
                self._channel.broadcast({"op": "shutdown"})

    def stats(self):
        out = super().stats()
        out["pod"] = self._pod.describe()
        return out


def pod_serve_follower(widths=DEFAULT_WIDTHS, compile_cache_dir=None,
                       device=None):
    """A pod follower's serve loop: obey the leader's stream until
    ``shutdown`` (clean return of the registry) — every ``exec`` runs this
    process's slab and joins the batch's exchange.  A leader's DEATH is the
    channel watchdog's (a loud exit), not this loop's."""
    from ..runtime.dist import pod_channel
    from ..utils.device import resolve_device
    from .spec import build_geometry, geometry_hash, scenario_stack

    ch = pod_channel()
    if ch is None:
        raise RuntimeError("pod_serve_follower needs the pod channel "
                           "(init_pod with channel=True)")
    dev = resolve_device(device)
    reg = PodProgramRegistry(widths, compile_cache_dir=compile_cache_dir,
                             channel=None, device=dev)
    ctx = _device_context(dev)
    while True:
        msg = ch.recv()
        op = msg.get("op")
        if op == "shutdown":
            return reg
        with ctx():
            if op == "register":
                canonical = msg["canonical"]
                gh = geometry_hash(canonical)
                if not reg.known(gh):
                    cfg, profiles, noise_norm = build_geometry(canonical)
                    reg.register(gh, cfg, profiles, noise_norm, warmup=True,
                                 scenario=scenario_stack(canonical))
            elif op == "exec":
                reg.execute_local(msg["gh"], msg["width"], msg["kd"],
                                  msg["dms"], msg["norms"], msg["nulls"],
                                  msg["sc"])
            else:
                raise RuntimeError(f"pod follower: unknown op {op!r}")


def _device_context(dev):
    import contextlib

    import torch

    if dev.type == "cuda":
        return lambda: torch.cuda.device(dev)
    return contextlib.nullcontext
