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

The JAX package's serving fleet (``ReplicaFleet``, ``FleetRouter``,
``PooledTransport``, ``RouteFailed``, ``make_router_server``) and its pod
registry are not ported yet.
"""

from .aio import AioHTTPServer, make_aio_server
from .cache import ByteLRU, ResultCache
from .programs import DEFAULT_WIDTHS, ProgramRegistry, enable_compilation_cache
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
