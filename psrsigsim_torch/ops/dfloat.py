"""Double-float (two-float32) arithmetic for phase accumulation (counterpart:
psrsigsim_tpu/ops/dfloat.py).

Dispersion phases reach 1e5-1e7 cycles, far beyond float32's resolution.
A per-observation DM makes the phase ramp a device computation, and the
reference builds it with the classical error-free transformations
(Dekker 1971 / Knuth) on (hi, lo) float32 pairs, giving a ~48-bit mantissa
before the mod-1 reduction.  The port follows the same IEEE operation
sequence so its ramps match the reference's.

PyTorch runs each operation eagerly and rounds it, so no optimization
barrier is needed to stop an algebraic simplifier from rewriting
``(a + b) - a`` to ``b`` (the reason the reference wraps intermediates).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_f64", "two_sum", "two_prod", "df_mul_f32",
           "df_mul_f32_fused", "df_recip", "df_mod1", "df_div_f32"]

# Veltkamp splitter for float32 (24-bit mantissa): 2^12 + 1
_SPLITTER = 4097.0


def split_f64(values):
    """Host-side: split float64 values into (hi, lo) float32 planes with
    hi + lo == value to ~2^-48 relative."""
    v = np.asarray(values, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _veltkamp(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    """two_sum assuming |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, via Veltkamp splitting)."""
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def df_mul_f32(a, bhi, blo):
    """(hi, lo) product of an exact float32 ``a`` with a double-float b."""
    p, e = two_prod(a, bhi)
    return _quick_two_sum(p, e + a * blo)


def df_mul_f32_fused(a, bhi, blo):
    """:func:`df_mul_f32` as XLA's CPU backend compiles the reference's:
    the low-order term ``e + a·blo`` contracted into one fused multiply-add
    (the reference's optimization barriers pin the sums, not that add).
    The coherent-dispersion transfer function takes it, so its cycles equal
    the JAX package's bit for bit."""
    from .stats import fma

    p, e = two_prod(a, bhi)
    return _quick_two_sum(p, fma(a, blo, e))


def df_recip(b):
    """Double-float reciprocal of a float32 ``b`` (one Newton step)."""
    r = 1.0 / b
    p, e = two_prod(r, b)
    return _quick_two_sum(r, ((1.0 - p) - e) * r)


def df_div_f32(a, b):
    """a / b as a double-float, for exact float32 inputs."""
    rhi, rlo = df_recip(b)
    return df_mul_f32(a, rhi, rlo)


def df_mod1(hi, lo):
    """Fractional part of hi + lo in [0, 1) as plain float32."""
    frac = hi - torch.floor(hi)
    s, e = two_sum(frac, lo)
    s = s - torch.floor(s)
    out = s + e
    return out - torch.floor(out)
