"""PCHIP (monotone piecewise-cubic Hermite) interpolation (counterpart:
psrsigsim_tpu/ops/interp.py).

The reference builds data portraits through ``scipy.interpolate.
PchipInterpolator(phases, profiles, axis=1)`` (psrsigsim/pulsar/
portraits.py:252).  Profile building runs once per configuration, on the
host in float64, so the port delegates to scipy exactly as the JAX
package's host path does (:func:`pchip_fit_np`, :func:`pchip_eval_np`).

The device half (:func:`pchip_slopes`, :func:`pchip_fit`,
:func:`pchip_eval`) evaluates the same interpolant in float32 tensor ops
on the tensors' device: the Fritsch–Carlson slopes vectorized over
channels (scipy's ``_find_derivatives``: weighted harmonic mean inside,
Fritsch–Butland one-sided edges with the monotonicity clamps) and the
evaluation as a gather plus the cubic Hermite polynomial.  torch loads
inside those functions: the PSRFITS writer processes import this module
and must not import torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["PchipCoeffs", "pchip_slopes", "pchip_fit", "pchip_eval",
           "pchip_fit_np", "pchip_eval_np"]


class PchipCoeffs(NamedTuple):
    """Interpolant state: breakpoints ``x (N,)``, values ``y (..., N)``,
    endpoint slopes ``d (..., N)``."""

    x: np.ndarray
    y: np.ndarray
    d: np.ndarray


def _tensor(a, device):
    """``a`` as a tensor: a tensor stays where it is; host data goes to
    ``device`` (float64 arrays as float32, as the JAX package's arrays are
    with 64-bit types off)."""
    import torch

    from ..utils.device import resolve_device

    if isinstance(a, torch.Tensor):
        return a
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=resolve_device(device))


def pchip_slopes(x, y, device=None):
    """Fritsch–Carlson derivative estimates for shape-preserving cubics.

    Args:
        x: breakpoints ``(N,)``, strictly increasing, N >= 2.
        y: values ``(..., N)`` (batched over leading axes, e.g. channels).
        device: where host arrays go (default: the CUDA card); tensors
            stay on their device.

    Returns:
        slopes ``(..., N)``.
    """
    import torch

    x = _tensor(x, device)
    y = _tensor(y, device)
    h = torch.diff(x)                        # (N-1,)
    delta = torch.diff(y, dim=-1) / h        # (..., N-1)
    if x.shape[-1] == 2:
        return delta.expand(y.shape[:-1] + (1,)).repeat_interleave(2, dim=-1)

    hk, hkm1 = h[1:], h[:-1]
    dk, dkm1 = delta[..., 1:], delta[..., :-1]
    w1 = 2 * hk + hkm1
    w2 = hk + 2 * hkm1
    # weighted harmonic mean; zero when the slopes differ in sign or one is 0
    smooth = torch.sign(dkm1) * torch.sign(dk) > 0
    one = torch.ones((), dtype=y.dtype, device=y.device)
    denom = torch.where(smooth, w1 / torch.where(dkm1 == 0, one, dkm1)
                        + w2 / torch.where(dk == 0, one, dk), one)
    whmean = torch.where(smooth, (w1 + w2) / denom, torch.zeros_like(denom))
    d_start = _edge_slope(h[0], h[1], delta[..., 0], delta[..., 1])
    d_end = _edge_slope(h[-1], h[-2], delta[..., -1], delta[..., -2])
    return torch.cat([d_start[..., None], whmean, d_end[..., None]], dim=-1)


def _edge_slope(h0, h1, d0, d1):
    """Three-point one-sided slope with scipy's monotonicity clamps
    (scipy ``PchipInterpolator._edge_case``)."""
    import torch

    d = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
    d = torch.where(torch.sign(d) != torch.sign(d0), torch.zeros_like(d), d)
    return torch.where((torch.sign(d0) != torch.sign(d1))
                       & (torch.abs(d) > 3 * torch.abs(d0)), 3 * d0, d)


def pchip_fit(x, y, device=None):
    """A PCHIP interpolant over the last axis of ``y``, as tensors
    (arguments as :func:`pchip_slopes`)."""
    x = _tensor(x, device)
    y = _tensor(y, device)
    return PchipCoeffs(x=x, y=y, d=pchip_slopes(x, y))


def pchip_eval(coeffs, xq):
    """Evaluate a PCHIP interpolant of tensors at query points.

    Args:
        coeffs: :class:`PchipCoeffs` of tensors, ``y``/``d`` ``(..., N)``.
        xq: query points ``(M,)`` (host data goes to ``coeffs.x``'s
            device).

    Returns:
        values ``(..., M)``.  Queries outside ``[x[0], x[-1]]`` extrapolate
        with the terminal cubic, as scipy does by default.
    """
    import torch

    x, y, d = coeffs
    xq = _tensor(xq, x.device)
    n = x.shape[0]
    idx = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, n - 2)
    x0 = x[idx]
    h = x[idx + 1] - x0
    t = (xq - x0) / h                        # (M,)
    y0, y1 = y[..., idx], y[..., idx + 1]
    d0, d1 = d[..., idx], d[..., idx + 1]
    # cubic Hermite basis
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return y0 * h00 + d0 * (h * h10) + y1 * h01 + d1 * (h * h11)


def pchip_fit_np(x, y):
    """Host float64 PCHIP fit via scipy; the slopes are the interpolant's
    derivative at the breakpoints.

    scipy's harmonic-mean slope formula overflows in an intermediate divide
    for near-zero secant slopes (flat off-pulse regions) and discards the
    result itself; that benign warning is silenced here, and the check that
    matters — every returned slope finite — is made loudly."""
    from scipy.interpolate import PchipInterpolator

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        interp = PchipInterpolator(x, y, axis=-1)
        slopes = interp.derivative()(x)
    if not np.all(np.isfinite(slopes)):
        raise FloatingPointError(
            "scipy PCHIP produced non-finite derivative(s): the input "
            "profile is degenerate (non-finite values, or duplicate "
            "breakpoints)")
    return PchipCoeffs(x=x, y=y, d=slopes)


def pchip_eval_np(coeffs, xq):
    """Host float64 PCHIP evaluation (scipy); the output is asserted
    finite."""
    from scipy.interpolate import PchipInterpolator

    x, y, _ = coeffs
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        interp = PchipInterpolator(np.asarray(x), np.asarray(y), axis=-1)
        out = interp(np.asarray(xq, dtype=np.float64))
    if not np.all(np.isfinite(out)):
        raise FloatingPointError(
            "scipy PCHIP evaluation produced non-finite value(s) — "
            "degenerate interpolant or query points")
    return out
