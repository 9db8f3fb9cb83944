"""Host PCHIP (monotone piecewise-cubic Hermite) interpolation (counterpart:
psrsigsim_tpu/ops/interp.py, its host half).

The reference builds data portraits through ``scipy.interpolate.
PchipInterpolator(phases, profiles, axis=1)`` (psrsigsim/pulsar/
portraits.py:252).  Profile building runs once per configuration, on the
host in float64, so the port delegates to scipy exactly as the JAX
package's host path does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["PchipCoeffs", "pchip_fit_np", "pchip_eval_np"]


class PchipCoeffs(NamedTuple):
    """Interpolant state: breakpoints ``x (N,)``, values ``y (..., N)``,
    endpoint slopes ``d (..., N)``."""

    x: np.ndarray
    y: np.ndarray
    d: np.ndarray


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
