"""One program registry: hashable keys -> built artifacts, with build and
hit counts (counterpart: psrsigsim_tpu/runtime/programs.py).

The JAX package resolves every compiled program through this registry
(ensemble chunk programs, Monte-Carlo trial programs, the export's packed
programs and the serving layer's width buckets) so that a geometry is
traced and compiled once per process, and so that the count of builds can
be checked.  The port compiles no programs: its kernels are built once by
``ops/_build.py`` (psrsigsim_torch/DIVERGENCES.md P6).  What it keeps is
the registry's API and counters, for the consumers that stage something
per geometry — the serving layer's buckets
(:class:`psrsigsim_torch.serve.ProgramRegistry`: a geometry's portrait,
frequencies and channel ids on the device, its callable, one warm run):

* ``get_or_build(key, builder)`` — one artifact per hashable key, built
  once (thread-safe; losers of a concurrent build race keep the
  winner's), with per-key build counts and cumulative build seconds, in an
  LRU bounded at ``max_programs``.
* :func:`global_registry` — the process-wide instance.
* :func:`trace_env_key` — the environment switches that change what a
  device callable computes; every key for one includes it.
* :func:`enable_compilation_cache` — accepted for the reference's
  ``compile_cache_dir=``/``--compile-cache-dir``; there is nothing to
  cache, so it returns False.
* Telemetry: :meth:`ProgramRegistry.attach_timers` lands one
  ``"compile"``-stage sample per build in a
  :class:`~psrsigsim_torch.runtime.telemetry.StageTimers`, and
  :meth:`ProgramRegistry.snapshot` summarizes the store.

Host-only: importing this module imports no torch.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["ProgramRegistry", "global_registry", "enable_compilation_cache",
           "trace_env_key", "donation_enabled"]


def donation_enabled(device=None):
    """The JAX package's buffer-donation switch, kept for
    :func:`trace_env_key`'s arity: ``PSS_DONATE`` ``1`` forces on, ``0``
    off, unset/``auto`` means on where the device is CUDA (``device``, or
    the card when None and one is present).  It changes nothing in the
    port — torch frees a chunk's inputs when their last reference dies,
    and no callable aliases its inputs into its outputs."""
    v = os.environ.get("PSS_DONATE", "auto").strip().lower()
    if v in ("1", "on", "true", "yes"):
        return True
    if v in ("0", "off", "false", "no"):
        return False
    if v in ("", "auto"):
        import torch

        if device is None:
            return torch.cuda.is_available()
        return torch.device(device).type == "cuda"
    raise ValueError(f"PSS_DONATE={v!r}: use 1, 0, or auto")


def trace_env_key(device=None):
    """The environment switches that change what a device callable
    COMPUTES (:mod:`psrsigsim_torch.ops.stats` and the pipelines read them
    at call time): the sampler selector ``PSS_SAMPLER``, the exact-χ²
    switch ``PSS_EXACT_CHI2``, the exact-shift switch ``PSS_EXACT_SHIFT``,
    :func:`donation_enabled`, and the pod topology
    (:func:`psrsigsim_torch.runtime.dist.pod_key`: a callable staged for a
    single-process mesh is never served to a pod, and every process of one
    pod resolves identical, process-id-independent keys).  Every registry
    key for a device callable includes this tuple, so an artifact staged
    and warmed under one sampler is never served under another."""
    from .dist import pod_key

    return (os.environ.get("PSS_SAMPLER", "auto"),
            bool(os.environ.get("PSS_EXACT_CHI2")),
            bool(os.environ.get("PSS_EXACT_SHIFT")),
            donation_enabled(device),
            pod_key())


def enable_compilation_cache(path):
    """The JAX package points its persistent compilation cache at ``path``
    (under a pod, :func:`~psrsigsim_torch.runtime.dist.compile_cache_path`'s
    per-host-count directory) so that a restarted server warms from disk.
    The port compiles no programs (its kernels are built by
    ``ops/_build.py`` into ``build/``, keyed by their sources, and every
    process of every topology loads the same files), so there is nothing to
    cache: the path is accepted and ignored, and the return value is False
    (the cache is not enabled)."""
    del path
    return False


class ProgramRegistry:
    """Hashable-key -> built artifact, built once per process.

    ``name`` labels the instance in snapshots (the global instance is
    ``"global"``; the serving layer names its per-service instances
    ``"serve"``).  A build is whatever the consumer's builder does — for
    the serving layer, staging a geometry's inputs on the device and one
    warm run of the width-bucket callable — and build count 1 per key is
    the no-duplicate-work contract the gates pin.
    """

    #: default artifact cap — far above any real process's distinct
    #: geometry count, small enough that a parameter scan over thousands
    #: of distinct geometries cannot grow memory without bound
    DEFAULT_MAX_PROGRAMS = 256

    def __init__(self, name="global", compile_cache_dir=None, timers=None,
                 max_programs=None):
        from collections import OrderedDict

        self.name = str(name)
        self._lock = threading.Lock()
        self._programs = OrderedDict()  # key -> artifact (LRU order)
        self._max_programs = int(max_programs
                                 if max_programs is not None
                                 else self.DEFAULT_MAX_PROGRAMS)
        self._builds = {}         # key -> build count (1 unless evicted)
        self._hits = {}           # key -> get_or_build calls served cached
        self._build_seconds = 0.0
        self._evictions = 0
        self._timers = timers
        self.cache_enabled = (
            enable_compilation_cache(compile_cache_dir)
            if compile_cache_dir else False)

    # -- resolution --------------------------------------------------------

    def get_or_build(self, key, builder):
        """The program for ``key``, building it with ``builder()`` on
        first use.  Concurrent builders of the same key may both run;
        exactly one artifact is kept (both are valid — the counts record
        what actually happened, which is what the single-build gates
        check after warmup).

        The store is an LRU bounded at ``max_programs`` artifacts:
        consumers keep their own references, so eviction only costs a
        rebuild if a long-gone geometry returns (and bumps that key's
        build count past 1 — the single-build gates run at warmup
        scales, far under the cap)."""
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self._hits[key] = self._hits.get(key, 0) + 1
                return prog
        t0 = time.perf_counter()
        built = builder()
        dt = time.perf_counter() - t0
        with self._lock:
            self._builds[key] = self._builds.get(key, 0) + 1
            self._build_seconds += dt
            prog = self._programs.setdefault(key, built)
            self._programs.move_to_end(key)
            while len(self._programs) > self._max_programs:
                self._programs.popitem(last=False)
                self._evictions += 1
            timers = self._timers
        if timers is not None:
            timers.add("compile", dt)
            timers.count("program_builds")
        return prog

    def peek(self, key):
        """The cached program or None — never builds."""
        with self._lock:
            return self._programs.get(key)

    # -- telemetry ---------------------------------------------------------

    def attach_timers(self, timers):
        """Route build telemetry into ``timers`` (a
        :class:`~psrsigsim_torch.runtime.telemetry.StageTimers`): each
        subsequent build adds one ``"compile"`` stage sample and bumps
        the ``program_builds`` counter.  Last attach wins; pass None to
        detach."""
        with self._lock:
            self._timers = timers

    def build_counts(self):
        with self._lock:
            return dict(self._builds)

    def hit_counts(self):
        with self._lock:
            return dict(self._hits)

    def assert_single_build(self, family=None):
        """The shared-registry no-duplicate-work guard: every key (or
        every key of one ``family`` prefix) was built exactly once."""
        bad = {k: c for k, c in self.build_counts().items()
               if c != 1 and (family is None or k[0] == family)}
        if bad:
            raise AssertionError(
                f"registry {self.name!r}: programs built more than once: "
                f"{bad}")

    def snapshot(self):
        """JSON-ready summary (family-aggregated: raw keys hold live
        config objects that do not belong in a manifest)."""
        with self._lock:
            fams = {}
            for k, c in self._builds.items():
                fam = k[0] if isinstance(k, tuple) and k else str(k)
                fams[str(fam)] = fams.get(str(fam), 0) + c
            hits = {}
            for k, c in self._hits.items():
                fam = k[0] if isinstance(k, tuple) and k else str(k)
                hits[str(fam)] = hits.get(str(fam), 0) + c
            return {
                "registry": self.name,
                "programs": len(self._programs),
                "builds_total": int(sum(self._builds.values())),
                "build_seconds": round(self._build_seconds, 6),
                "evictions": self._evictions,
                "builds_by_family": dict(sorted(fams.items())),
                "hits_by_family": dict(sorted(hits.items())),
            }


# the process-wide instance (the JAX package's ensemble, Monte-Carlo and
# export program families resolve through theirs; the port's compile
# nothing, so only callers that stage something use it).  Memory is
# bounded by the LRU cap (DEFAULT_MAX_PROGRAMS).
_GLOBAL = ProgramRegistry("global")


def global_registry():
    """The process-wide shared :class:`ProgramRegistry`."""
    return _GLOBAL
