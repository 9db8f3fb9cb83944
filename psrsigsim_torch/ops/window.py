"""Off-pulse window detection, host side, and period folding (counterpart:
psrsigsim_tpu/ops/window.py).

The minimum-integral sliding window over the peak profile, adapted by the
reference from PyPulse (psrsigsim/pulsar/portraits.py:62-82).
"""

from __future__ import annotations

import numpy as np

__all__ = ["offpulse_window", "fold_periods"]


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
