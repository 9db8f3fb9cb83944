"""ISM propagation models (counterpart: psrsigsim_tpu/models/ism/)."""

from .ism import ISM, fd_delays_ms, scatter_delays_ms

__all__ = ["ISM", "fd_delays_ms", "scatter_delays_ms"]
