"""Simulation serving layer: concurrent requests -> device batches
(counterpart: psrsigsim_tpu/serve/, its single-process core).

- :mod:`~psrsigsim_torch.serve.spec` — canonical request specs: strict
  validation, canonical JSON, sha256 content addresses, geometry
  bucketing (the JAX package's bytes).
- :mod:`~psrsigsim_torch.serve.service` —
  :class:`SimulationService`: bounded admission queue with explicit
  backpressure and per-request deadlines, a batcher thread coalescing
  compatible requests into padded width buckets, batching-invariant
  per-request RNG (results bit-identical solo vs coalesced vs any
  bucket width), stage telemetry.  Runs on the CUDA card unless given
  ``device="cpu"``.
- :mod:`~psrsigsim_torch.serve.programs` —
  :class:`ProgramRegistry`: one staged bucket per (geometry, width) —
  the portrait on the device, the callable, one warm run — built at
  startup and counted, so no request pays a start-up cost.
- :mod:`~psrsigsim_torch.serve.cache` — :class:`ResultCache`:
  content-addressed journaled artifacts, so repeated identical requests
  never touch the device and a SIGKILLed server restarts with its
  committed results verified and servable.
- :mod:`~psrsigsim_torch.serve.http` / ``python -m psrsigsim_torch.serve``
  — the stdlib ThreadingHTTPServer JSON API (``/simulate``,
  ``/status/<id>``, ``/result/<id>``, ``/healthz``, ``/metrics``) with
  graceful drain on SIGTERM; the endpoint semantics are module-level
  functions shared with the aio front end, so responses are
  byte-identical across front ends.
- :mod:`~psrsigsim_torch.serve.aio` — :class:`AioHTTPServer`: the C10k
  front end over one ``selectors`` event loop (``--frontend aio``).

- :mod:`~psrsigsim_torch.serve.fleet` — :class:`ReplicaFleet`: N
  ``python -m psrsigsim_torch.serve`` replica processes over one shared
  cache, each under a :class:`~psrsigsim_torch.runtime.ProcessSupervisor`
  (restart with jittered backoff), health-polled, autoscaled between
  bounds with hysteresis, drained fleet-wide on SIGTERM.
- :mod:`~psrsigsim_torch.serve.router` — :class:`FleetRouter`:
  rendezvous routing by spec hash, deadline-preserving failover, quorum
  backpressure and per-replica circuit breakers over
  :class:`PooledTransport` keep-alive upstreams; ``make_router_server``
  puts one HTTP address in front of the fleet.

- :mod:`~psrsigsim_torch.serve.pod` — :class:`PodProgramRegistry` and
  ``pod_serve_follower``: one replica as a pod program group, the leader
  serving HTTP while followers run their slab of every batch
  (``python -m psrsigsim_torch.serve --pod-num-hosts N ...``).
"""

from .aio import AioHTTPServer, make_aio_server
from .cache import ByteLRU, ResultCache
from .fleet import ReplicaFleet
from .programs import DEFAULT_WIDTHS, ProgramRegistry, enable_compilation_cache
from .router import (FleetRouter, PooledTransport, RouteFailed,
                     make_router_server)
from .service import (RequestFailed, RequestRejected, SERVE_STAGES,
                      SimulationService)
from .spec import (SpecError, build_geometry, canonicalize, geometry_hash,
                   spec_hash)

__all__ = [
    "SimulationService",
    "RequestRejected",
    "RequestFailed",
    "ResultCache",
    "ByteLRU",
    "ReplicaFleet",
    "FleetRouter",
    "PooledTransport",
    "RouteFailed",
    "make_router_server",
    "AioHTTPServer",
    "make_aio_server",
    "ProgramRegistry",
    "DEFAULT_WIDTHS",
    "SERVE_STAGES",
    "SpecError",
    "canonicalize",
    "spec_hash",
    "geometry_hash",
    "build_geometry",
    "enable_compilation_cache",
]
