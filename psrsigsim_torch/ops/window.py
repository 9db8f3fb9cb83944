"""Off-pulse window detection and period folding (counterpart:
psrsigsim_tpu/ops/window.py).

The minimum-integral sliding window over the peak profile, adapted by the
reference from PyPulse (psrsigsim/pulsar/portraits.py:62-82): on the host
in float64 (:func:`offpulse_window`), and in tensor ops on the profile's
device (:func:`offpulse_window_jax`, under the JAX package's name).  torch
loads inside the tensor functions: the PSRFITS writer processes import this
module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["offpulse_window", "offpulse_window_jax", "offpulse_window_indices",
           "fold_periods"]


def offpulse_window_indices(nphase, device=None):
    """The circular window offsets of the off-pulse search, as an int64
    tensor on ``device`` (default: the CUDA card; it raises without
    one), and the half width: ``windowsize = nphase/8`` (may be
    fractional); offsets span ``[-ws//2, +ws//2)`` exactly as the
    reference's ``np.arange(i - ws//2, i + ws//2)`` (portraits.py:77)."""
    import torch

    from ..utils.device import resolve_device

    ws = nphase / 8
    half = int(ws // 2)
    return torch.arange(-half, half, device=resolve_device(device)), half


def offpulse_window(max_profile, nphase=None):
    """Bin indices ``(2·(ws//2)+1,)`` of the circular window of width
    ``nphase/8`` with minimal trapezoidal integral, centered on the
    minimum-integral position (reference: portraits.py:62-82).  Float64 on
    the host, for the reference's tie-breaking."""
    prof = np.asarray(max_profile, dtype=np.float64)
    n = prof.shape[-1] if nphase is None else nphase
    ws = n / 8
    half = int(ws // 2)
    offsets = np.arange(-half, half)
    win = (np.arange(n)[:, None] + offsets[None, :]) % n  # (n, 2*half)
    vals = prof[win]
    # np.trapezoid with unit spacing: sum minus half the endpoints
    integral = vals.sum(axis=-1) - 0.5 * (vals[:, 0] + vals[:, -1])
    minind = int(np.argmin(integral))
    return (np.arange(-half, half + 1) + minind) % n


def offpulse_window_jax(max_profile, nphase=None):
    """Tensor twin of :func:`offpulse_window`, on the profile's device (host
    data becomes a CPU tensor; float32 tie-breaking may differ from the
    host version in fully flat off-pulse regions).  The name is the JAX
    package's."""
    import torch

    prof = (max_profile if isinstance(max_profile, torch.Tensor)
            else torch.as_tensor(np.asarray(max_profile, np.float32)))
    n = prof.shape[-1] if nphase is None else nphase
    offsets, half = offpulse_window_indices(n, prof.device)
    centers = torch.arange(n, device=prof.device)[:, None]
    win = (centers + offsets[None, :]) % n  # (n, 2*half)
    vals = prof[win]
    integral = vals.sum(dim=-1) - 0.5 * (vals[:, 0] + vals[:, -1])
    minind = torch.argmin(integral)
    return (torch.arange(-half, half + 1, device=prof.device) + minind) % n


def fold_periods(data, nph):
    """Fold a single-pulse time stream into one summed profile per channel.

    Args:
        data: ``(..., Nsamp)`` tensor (or array).
        nph: phase bins per period.

    Returns:
        ``(..., nph)`` — the sum over all complete periods.
    """
    *lead, nsamp = data.shape
    nfold = nsamp // nph
    trimmed = data[..., : nfold * nph]
    return trimmed.reshape(*lead, nfold, nph).sum(-2)
