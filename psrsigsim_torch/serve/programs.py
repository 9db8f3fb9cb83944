"""Shape-bucketed program registry: one staged program per (geometry,
bucket width) (counterpart: psrsigsim_tpu/serve/programs.py).

Serving traffic must never pay a start-up cost: the first request of a
geometry must not wait for kernels to load, cuFFT plans to be made or the
caching allocator to grow, because every request queued behind it waits
too.  The JAX package AOT-compiles one XLA program per (geometry, width)
at registration.  The port compiles nothing (its CUDA kernels are built
once per checkout by ``ops/_build.py``), so a "build" of a bucket here is:

* the geometry's portrait and channel frequencies staged on the device
  (:func:`psrsigsim_torch.parallel.build_width_bucket_fn`; the channel ids
  stay on the host, where the sampler reads the first one);
* the bucket callable returned;
* one run of that callable on the reference's example inputs (zeros and
  keys ``0..width-1``), which loads the kernels, creates the cuFFT plans
  for the width's shapes and warms the allocator.

Builds are counted per key; :meth:`assert_single_compile` is the guard the
tests pin (== 1 per bucket after warmup).  Keys carry
:func:`~psrsigsim_torch.runtime.programs.trace_env_key`, because the
sampler switch is read when the callable runs: a bucket staged and warmed
under ``PSS_SAMPLER=hw`` is never reused under ``threefry``.

Storage and counting live in the shared
:class:`psrsigsim_torch.runtime.ProgramRegistry`, composed here as a
PRIVATE instance per service so the per-service single-build guard keeps
its meaning.  ``enable_compilation_cache`` is re-exported from there (it
accepts a directory and enables nothing).

Widths are the sizes the batcher rounds batches up to (padded rows repeat
the batch's requests and are trimmed); ``bucket_width`` picks the smallest
admitted width that fits.
"""

from __future__ import annotations

import threading

import numpy as np

from ..runtime.programs import ProgramRegistry as _SharedRegistry
from ..runtime.programs import enable_compilation_cache, trace_env_key

__all__ = ["ProgramRegistry", "DEFAULT_WIDTHS", "enable_compilation_cache"]

DEFAULT_WIDTHS = (1, 8, 32)

_FAMILY = "serve_bucket"


def example_keys(width):
    """Key data of ``jax.random.key(i)`` for ``i < width`` (the
    reference's warm-up keys): ``(width, 2)`` uint32, high word 0."""
    keys = np.zeros((int(width), 2), np.uint32)
    keys[:, 1] = np.arange(int(width), dtype=np.uint32)
    return keys


class ProgramRegistry:
    """Staged serving programs, keyed by (geometry hash, width).

    One instance per service; thread-safe (registration happens on the
    batcher thread or at warmup, lookups from anywhere).  ``device``: where
    the buckets run (default: the CUDA card; a service passes its own).
    """

    def __init__(self, widths=DEFAULT_WIDTHS, compile_cache_dir=None,
                 device=None):
        from ..utils.device import resolve_device

        widths = sorted(set(int(w) for w in widths))
        if not widths or widths[0] < 1:
            raise ValueError(f"widths must be positive ints, got {widths}")
        self.widths = tuple(widths)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._geoms = {}          # geom hash -> (cfg, profiles, noise_norm)
        self._stacks = {}         # geom hash -> ScenarioStack or None
        self._store = _SharedRegistry(
            "serve", compile_cache_dir=compile_cache_dir)
        self._calls = {}          # (geom hash, width) -> executions
        self.device_calls = 0

    @property
    def cache_enabled(self):
        return self._store.cache_enabled

    # -- geometry staging --------------------------------------------------

    def geometry(self, geom_hash):
        """The staged ``(cfg, profiles, noise_norm)`` for a registered
        geometry (KeyError when unknown)."""
        with self._lock:
            return self._geoms[geom_hash]

    def known(self, geom_hash):
        with self._lock:
            return geom_hash in self._geoms

    def register(self, geom_hash, cfg, profiles, noise_norm, warmup=True,
                 scenario=None, canonical=None):
        """Stage one geometry bucket; with ``warmup`` (the default) every
        admitted width is built NOW (staged and run once), so the first
        request of this geometry pays no start-up cost on the serving path.
        A build that fails (a kernel that does not build or launch) raises
        here: the geometry fails loudly, nothing falls back.  ``scenario``
        (a :class:`~psrsigsim_torch.scenarios.ScenarioStack` or None) is
        part of the geometry — the hash covers the spec's ``scenarios``
        field — and adds the parameter matrix to the bucket's inputs.
        ``canonical`` is unused (the reference's pod registry broadcasts
        it)."""
        del canonical
        with self._lock:
            if geom_hash not in self._geoms:
                self._geoms[geom_hash] = (cfg, np.asarray(profiles),
                                          float(noise_norm))
                self._stacks[geom_hash] = scenario
        if warmup:
            for w in self.widths:
                self.program(geom_hash, w)

    def scenario_of(self, geom_hash):
        """The registered geometry's scenario stack (None = base)."""
        with self._lock:
            return self._stacks[geom_hash]

    # -- programs ----------------------------------------------------------

    def bucket_width(self, n):
        """The smallest admitted width >= ``n`` (the largest width when
        ``n`` exceeds every bucket — the batcher then splits)."""
        for w in self.widths:
            if w >= n:
                return w
        return self.widths[-1]

    @staticmethod
    def _example_inputs(width, scenario=None):
        z = np.zeros(width, np.float32)
        if scenario is None:
            return example_keys(width), z, z, z
        sc = np.zeros((width, len(scenario.param_names())), np.float32)
        return example_keys(width), z, z, z, sc

    def program(self, geom_hash, width):
        """The bucket callable for (geometry, width) under the current
        :func:`trace_env_key`; built (staged and run once) on first use —
        warmup makes that never the serving path — and counted for the
        single-build guard through the shared runtime registry."""
        with self._lock:
            cfg, profiles, _ = self._geoms[geom_hash]
            stack = self._stacks[geom_hash]

        def _build():
            from ..parallel.ensemble import build_width_bucket_fn

            fn = build_width_bucket_fn(cfg, profiles, scenario=stack,
                                       device=self.device)
            fn(*self._example_inputs(int(width), stack)).cpu()
            return fn

        return self._store.get_or_build(
            (_FAMILY, geom_hash, int(width), trace_env_key(self.device)),
            _build)

    def execute_device(self, geom_hash, width, keys, dms, norms, null_fracs,
                       sc=None):
        """Run one padded batch and return the ``(width, Nchan, Nph)``
        tensor where it lies (the integrity path digests it there); counted
        like :meth:`execute`."""
        prog = self.program(geom_hash, width)
        args = (keys, dms, norms, null_fracs)
        if sc is not None:
            args = args + (sc,)
        out = prog(*args)
        key = (geom_hash, int(width))
        with self._lock:
            self.device_calls += 1
            self._calls[key] = self._calls.get(key, 0) + 1
        return out

    def execute(self, geom_hash, width, keys, dms, norms, null_fracs,
                sc=None):
        """Run one padded batch through the bucket (``sc``: the
        ``(width, n_params)`` scenario parameter matrix, scenario
        geometries only) and return it as host numpy: one device-to-host
        copy per batch, the synchronization point.  With
        :meth:`execute_device`, this is the ONLY device entry of the
        serving layer; ``device_calls`` counts its invocations (the
        result-cache tests assert it stays flat across repeated identical
        requests)."""
        return self.execute_device(geom_hash, width, keys, dms, norms,
                                   null_fracs, sc=sc).cpu().numpy()

    # -- introspection / guards -------------------------------------------

    def compile_counts(self):
        # key[1:3] = (geom_hash, width); trace_env_key rides after them
        return {(k[1], k[2]): c
                for k, c in self._store.build_counts().items()}

    def call_counts(self):
        with self._lock:
            return dict(self._calls)

    def assert_single_compile(self):
        """The single-build guard: every (geometry, width) was built
        exactly once.  More than one means a registration raced or a
        bucket was rebuilt — either way the bounded-start-up contract
        broke."""
        bad = {k: c for k, c in self.compile_counts().items() if c != 1}
        if bad:
            raise AssertionError(
                f"serving programs compiled more than once: {bad}")

    def stats(self):
        """JSON-ready summary for ``/metrics``: per-bucket execution
        counts keyed ``geomprefix/width``, build counts, device calls,
        and the shared-store build snapshot."""
        counts = self.compile_counts()
        with self._lock:
            return {
                "device_calls": self.device_calls,
                "geometries": len(self._geoms),
                "programs": len(counts),
                "compile_counts": {
                    f"{g[:12]}/w{w}": c
                    for (g, w), c in sorted(counts.items())},
                "bucket_calls": {
                    f"{g[:12]}/w{w}": c
                    for (g, w), c in sorted(self._calls.items())},
                "registry": self._store.snapshot(),
            }
