"""Random draws for pulse and noise synthesis (counterpart:
psrsigsim_tpu/ops/stats.py).

Two samplers draw the per-channel χ² fields of the pipelines:

* ``threefry`` — the JAX package's blocked ``jax.random`` draws, ported bit
  for bit: keys folded by (global channel, global 4096-sample block), then
  ``jax.random.normal``'s uniform → ``sqrt(2)·erf_inv(u)`` mapping, then
  the χ² transform.  ``erf_inv`` is XLA's single-precision Giles
  polynomial, evaluated with the operation sequence XLA's CPU backend
  emits (fused multiply-adds, its own ``log``/``log1p``), so the port's
  normals reproduce the reference's on the CPU; ``torch.erfinv`` is a
  different function and differs by tens of ulps.  This is the parity
  sampler: plain torch ops, on either device.
* ``hw`` — the hand-written CUDA kernel of :mod:`.rng_hw` (the counterpart
  of the TPU hardware-PRNG kernel), the default on the card.

χ² routing follows the reference's ``chi2_sample``: df = 1 draws ``z²``
exactly, a static df ≥ 50 draws the Wilson–Hilferty cube of a normal, and a
per-observation df tensor (the reference's traced df) selects between the
two in the graph.  SEARCH mode draws its fields from the flat whole-tile
stream (``flat_normal_field``, ``flat_chi2_field``): the kernel's flat
layout on the card, the blocked draws reordered elsewhere.  The
object-oriented flow draws jax's flat
``random.normal`` stream over a whole ``(Nchan, Nsamp)`` block
(``normal_sample``, ``chi2_sample``, and ``chi2_sample_compiled``, the
arithmetic XLA compiles for the JAX package's jitted kernels).  The exact gamma sampler (static df < 50, or
``PSS_EXACT_CHI2=1``) is not ported yet and raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.rng import fold_in, randint, random_bits

__all__ = ["SEQ_RNG_BLOCK", "CHI2_WH_MIN_DF", "fma", "exp", "erf_inv",
           "uniform", "normal", "normal_sample", "chi2_sample",
           "chi2_sample_compiled", "blocked_chan_chi2",
           "blocked_chan_normal", "sampler_backend",
           "chan_chi2_field", "chan_normal_field", "FLAT_TILE",
           "FLAT_MAX_OFFSET", "flat_normal_field", "flat_chi2_field",
           "flat_chi2_ok", "chi2_draw_norm", "choice", "fixed_histogram",
           "exponential"]

# Fixed span of global time samples per RNG key: every pipeline draw is keyed
# by (stage, channel, global block index), so a seed gives the same stream
# for any split of the time axis.
SEQ_RNG_BLOCK = 4096

# Above this df, χ² draws use the Wilson–Hilferty transform of one normal
# (psrsigsim_tpu/ops/stats.py CHI2_WH_MIN_DF; the JAX package's
# DIVERGENCES #21).
CHI2_WH_MIN_DF = 50.0

_F32 = torch.float32


# -- XLA's float32 arithmetic, op for op -------------------------------------


def fma(a, b, c):
    """Correctly rounded float32 ``a*b + c`` (a fused multiply-add, as XLA
    emits it): the product is exact in float64, the sum is rounded to odd
    (so the final rounding to float32 is not a double rounding)."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else float(b))
    cd = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(_F32)


def _f32(v):
    return float(np.float32(v))


# Cephes/Eigen logf coefficients, as XLA's CPU backend evaluates them
_LOG_P = [_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _log(x):
    """float32 natural log with XLA CPU's polynomial (frexp, then a degree-8
    polynomial on [sqrt(1/2)-1, sqrt(2)-1]).  Positive finite inputs only,
    which is all :func:`_log1p` passes it."""
    x = torch.clamp(x, min=_FLT_MIN)
    bits = x.view(torch.int32)
    e = (((bits >> 23) & 0x1FF) - 127).to(_F32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    small = m < _SQRTHF
    e = e - small.to(_F32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, m, _LOG_P[2])
    y1 = fma(y1, m, _LOG_P[5])
    y2 = fma(y2, m, _LOG_P[8])
    y = fma(y, m3, y1)
    y = fma(y, m3, y2)
    y = fma(y, m3, e * _LOG_Q1)
    m = m - m2 * 0.5
    m = m + y
    return m + e * _LOG_Q2


_LOG1P_NUM = [_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]


def _log1p(x):
    """float32 ``log1p`` as XLA emits it: a Cephes rational approximation
    for ``|x| < sqrt(2) - 1``, else ``log(1 + x)``."""

    def poly(coeffs):
        r = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            r = fma(r, x, c)
        return r

    x2 = x * x
    small = poly(_LOG1P_NUM) / poly(_LOG1P_DEN)
    small = x + ((-0.5 * x2) + (x * x2) * small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log(x + 1.0))


def _sqrt(x):
    """Correctly rounded float32 square root, as XLA's CPU backend emits it
    (``vsqrtps``); torch's vectorized float32 ``sqrt`` on the host is an ulp
    off now and then.  The float64 root rounds to the float32 one."""
    return torch.sqrt(x.double()).to(_F32)


# Cephes/Eigen expf, as XLA's CPU backend evaluates it
_EXP_LO = _f32(-87.8)
_EXP_HI = _f32(88.8)
_LOG2E = _f32(1.44269504088896341)
_EXP_C1 = 0.693359375
_EXP_C2 = _f32(-2.12194440e-4)
_EXP_P = [_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1)]


def exp(x):
    """float32 ``exp`` with XLA CPU's polynomial: ``x = n·ln2 + r`` with
    ``n = floor(x·log2(e) + 1/2)`` clamped to [-127, 127] and ``r`` reduced
    in two fused steps, a degree-5 polynomial in ``r``, then ``n`` put into
    the exponent bits; a subnormal result flushes to zero, as XLA's CPU
    code runs with flush-to-zero."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_EXP_C1, x)
    r = fma(n, -_EXP_C2, r)
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    y = y * ((n.to(torch.int32) + 127) << 23).view(_F32)
    return torch.where(y < _FLT_MIN, torch.zeros_like(y), y)


_ERFINV_LT5 = [_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def erf_inv(x):
    """XLA's float32 ``erf_inv`` (Giles' single-precision polynomial,
    ``w = -log1p(-x²)``), the function ``jax.random.normal`` is built on."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lt_c, ge_c in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, lt_c, ge_c))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# -- jax.random samplers ------------------------------------------------------


def uniform(key, n, minval=0.0, maxval=1.0, start=0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for keys
    of shape ``(..., 2)`` -> ``(..., n)`` (elements ``start ..
    start+n-1`` of the stream)."""
    bits = random_bits(key, n, start)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0
    lo = torch.full((), minval, dtype=_F32, device=key.device)
    hi = torch.full((), maxval, dtype=_F32, device=key.device)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def exponential(key, n):
    """``jax.random.exponential(key, (n,), float32)`` for keys ``(..., 2)``
    -> ``(..., n)``: ``-log1p(-u)`` of the uniform draws, with XLA's
    ``log1p``.  Many keys with ``n = 1`` are the batched form of jax's
    one-draw call ``exponential(key, ())``."""
    return -_log1p(-uniform(key, n))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = _f32(np.sqrt(2))


def _from_uniform(key, n, transform):
    """``transform(u)`` of the ``(..., n)`` uniform (-1, 1) draws of
    ``jax.random.normal``.  Long draws go in spans of the flat stream;
    every element is the same as in one pass."""
    # on the host a span's temporaries stay in cache (four times faster
    # than one pass at 2**22 elements and more); on the card a span bounds
    # the int64 and float64 temporaries
    span = (1 << 18) if key.device.type == "cpu" else (1 << 24)
    if n <= span:
        return transform(uniform(key, n, _NORMAL_LO, 1.0))
    out = torch.empty(key.shape[:-1] + (n,), dtype=_F32, device=key.device)
    for s in range(0, n, span):
        m = min(span, n - s)
        out[..., s:s + m] = transform(uniform(key, m, _NORMAL_LO, 1.0, start=s))
    return out


def normal(key, n):
    """``jax.random.normal(key, (n,), float32)``: ``sqrt(2)·erf_inv(u)``
    with ``u`` uniform on (-1, 1)."""
    return _from_uniform(key, n, lambda u: _SQRT2 * erf_inv(u))


def _shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(d) for d in shape)


def normal_sample(key, shape):
    """``jax.random.normal(key, shape, float32)`` (reference:
    ``normal_sample``): jax's partitionable stream is the flat index, so a
    ``(Nchan, W)`` draw is the flat ``Nchan·W`` draw reshaped.  Keys
    ``(..., 2)`` -> ``(..., *shape)``."""
    shape = _shape(shape)
    return normal(key, int(np.prod(shape))).reshape(key.shape[:-1] + shape)


# -- chi-squared routing -------------------------------------------------------


def _exact_chi2_unported(df):
    raise NotImplementedError(
        f"chi2 df={df}: the exact gamma sampler (static df < "
        f"{CHI2_WH_MIN_DF:.0f}, or PSS_EXACT_CHI2=1) is not ported yet; "
        "the port draws df=1 exactly and df >= 50 by Wilson-Hilferty")


def _static_df(df):
    """A Python float for a scalar df, None for a per-observation tensor
    (the reference's traced df)."""
    if isinstance(df, torch.Tensor):
        return None
    return float(df)


def wilson_hilferty(z, df, fused=False):
    """``max(k·(1 - c + z·sqrt(c))³, 0)`` with ``c = 2/(9k)`` in float32,
    the reference's order of operations (``**3`` is ``t·(t·t)``); with
    ``fused`` the add is contracted into a multiply-add, as XLA compiles
    the JAX package's jitted flat fields."""
    k = df if isinstance(df, torch.Tensor) else torch.full(
        (), df, dtype=_F32, device=z.device)
    c = 2.0 / (9.0 * k)
    if fused:
        t = fma(z, _sqrt(c), 1.0 - c)
    else:
        t = (1.0 - c) + z * _sqrt(c)
    return torch.clamp_min(k * (t * (t * t)), 0.0)


def _chi2_from_normal(z, df):
    """χ² draws from standard normals ``z`` (``(..., C, L)``) with the
    reference's df routing.  A df tensor has one entry per leading index of
    ``z`` (one per observation)."""
    if os.environ.get("PSS_EXACT_CHI2"):
        _exact_chi2_unported(df)
    static_df = _static_df(df)
    if static_df == 1.0:
        return z * z
    if static_df is not None:
        if static_df < CHI2_WH_MIN_DF:
            _exact_chi2_unported(static_df)
        return wilson_hilferty(z, static_df)
    k = df.to(device=z.device, dtype=_F32).reshape(
        df.shape + (1,) * (z.dim() - df.dim()))
    return torch.where(k == 1.0, z * z, wilson_hilferty(z, k))


def chi2_sample(key, df, shape):
    """χ²(df) draws ``(..., *shape)`` from one key per leading index
    (reference: ``chi2_sample``); ``shape`` an int or a tuple, drawn as
    :func:`normal_sample` draws it."""
    return _chi2_from_normal(normal_sample(key, shape), df)


def chi2_sample_compiled(key, df, shape):
    """:func:`chi2_sample` for a static df, with the arithmetic XLA
    compiles when the caller is jitted with df static (the JAX package's
    object-oriented kernels: ``Pulsar._fold_pulse_kernel``,
    ``Receiver._add_pow_noise_kernel``).  XLA folds ``sqrt(2)`` of the
    normal and ``sqrt(c)`` of Wilson–Hilferty into one float32 constant and
    contracts the add, so ``t = fma(erf_inv(u), f32(sqrt(2)·sqrt(c)),
    1 - c)``; df = 1 (``z²``) compiles to :func:`chi2_sample`'s
    arithmetic."""
    static_df = _static_df(df)
    if (static_df is None or static_df == 1.0 or static_df < CHI2_WH_MIN_DF
            or os.environ.get("PSS_EXACT_CHI2")):
        return chi2_sample(key, df, shape)
    k = torch.tensor(static_df, dtype=_F32)
    c = 2.0 / (9.0 * k)
    scale = float(torch.tensor(_SQRT2, dtype=_F32) * _sqrt(c))
    one_c = float(1.0 - c)
    k = float(k)

    def wh(u):
        t = fma(erf_inv(u), scale, one_c)
        return torch.clamp_min((t * t) * t * k, 0.0)

    shape = _shape(shape)
    return _from_uniform(key, int(np.prod(shape)), wh).reshape(
        key.shape[:-1] + shape)


def blocked_chan_normal(key, chan_ids, t0, length, block=SEQ_RNG_BLOCK):
    """Blocked threefry normal draws (reference: ``blocked_chan_normal``):
    standard normals for global span ``[t0, t0+length)`` of every channel,
    keyed by ``(channel, global block index)``: ``(..., C, length)`` for
    keys ``(..., 2)``.  Whole blocks are drawn and the span sliced out, so
    any split of the time axis gives the same stream."""
    return _blocked_chan_draw(key, chan_ids, t0, length, block,
                              lambda u: _SQRT2 * erf_inv(u))


def _blocked_chan_draw(key, chan_ids, t0, length, block, transform):
    """``transform(u)`` of the uniform (-1, 1) draws behind
    :func:`blocked_chan_normal`, over the same blocks and span."""
    t0 = int(t0)
    b0 = t0 // block
    off = t0 - b0 * block
    nblk = -(-(off + length) // block)
    chan_ids = to_device(torch.as_tensor(chan_ids, dtype=torch.int64), key.device)
    ck = fold_in(key[..., None, :], chan_ids)                    # (..., C, 2)
    blocks = torch.arange(b0, b0 + nblk, dtype=torch.int64, device=key.device)
    kb = fold_in(ck[..., None, :], blocks)                       # (..., C, nblk, 2)
    z = _from_uniform(kb, block, transform)                      # (..., C, nblk, block)
    z = z.reshape(z.shape[:-2] + (nblk * block,))
    return z[..., off:off + length]


def blocked_chan_chi2(key, chan_ids, df, t0, length, block=SEQ_RNG_BLOCK):
    """Blocked threefry χ² draws (reference: ``blocked_chan_chi2``).  A df
    tensor (one per observation, the reference's traced df) takes the
    arithmetic XLA compiles for it: ``sqrt(2)`` of the normal folded into
    Wilson–Hilferty's ``sqrt(c)``, the add fused, ``t = fma(erf_inv(u),
    f32(sqrt(2)·sqrt(c)), 1 - c)``, and ``z²`` where df = 1."""
    if not isinstance(df, torch.Tensor) or os.environ.get("PSS_EXACT_CHI2"):
        return _chi2_from_normal(
            blocked_chan_normal(key, chan_ids, t0, length, block), df)
    e = _blocked_chan_draw(key, chan_ids, t0, length, block, erf_inv)
    k = df.to(device=e.device, dtype=_F32).reshape(
        df.shape + (1,) * (e.dim() - df.dim()))
    c = 2.0 / (9.0 * k)
    t = fma(e, _SQRT2 * _sqrt(c), 1.0 - c)
    z = _SQRT2 * e
    return torch.where(k == 1.0, z * z,
                       torch.clamp_min(k * (t * (t * t)), 0.0))


# -- sampler dispatch -----------------------------------------------------------


def sampler_backend(device):
    """Which field sampler draws on ``device``: ``"hw"`` (the CUDA kernel of
    :mod:`.rng_hw`) or ``"threefry"`` (the blocked draws above).

    * ``PSS_SAMPLER=threefry`` or ``PSS_SAMPLER=hw`` forces one;
    * ``PSS_EXACT_CHI2=1`` forces threefry (where the exact sampler raises);
    * otherwise ``auto``: ``hw`` on a CUDA device, threefry elsewhere — as
      the reference picks its hardware sampler only on a TPU.

    The two draw DIFFERENT streams of the same distributions; split
    invariance holds within each (psrsigsim_torch/DIVERGENCES.md P1).
    """
    env = os.environ.get("PSS_SAMPLER", "auto")
    if env == "threefry" or os.environ.get("PSS_EXACT_CHI2"):
        return "threefry"
    if env == "hw":
        return "hw"
    if env != "auto":
        raise ValueError(f"PSS_SAMPLER={env!r}: use 'auto', 'hw' or 'threefry'")
    return "hw" if torch.device(device).type == "cuda" else "threefry"


def _hw_chi2_mode(df):
    """The kernel's transform mode for a χ² df (None where the routing needs
    the exact gamma sampler, which stays on the threefry path)."""
    static_df = _static_df(df)
    if static_df is None:
        return "chi2_sel"
    if static_df == 1.0:
        return "chi2_1"
    if static_df >= CHI2_WH_MIN_DF:
        return "chi2_wh"
    return None


def _hw_field_span(key, chan_ids, dfv, t0, mode, length):
    """Kernel draws for a possibly block-UNALIGNED global span: draw the
    whole RNG blocks covering ``[t0, t0+length)`` (one block of overdraw
    when unaligned, as the threefry path does) and slice the span out.
    ``chan_ids`` is read on the host: keep it a CPU tensor."""
    from .rng_hw import RNG_BLOCK, hw_chan_field

    chan0 = int(chan_ids[0])
    nchan = int(chan_ids.shape[0])
    t0 = int(t0)
    if t0 % RNG_BLOCK == 0:
        return hw_chan_field(key, chan0, dfv, t0, mode=mode, nchan=nchan,
                             length=length)
    pad_len = (-(-length // RNG_BLOCK) + 1) * RNG_BLOCK
    b0 = t0 // RNG_BLOCK
    field = hw_chan_field(key, chan0, dfv, b0 * RNG_BLOCK, mode=mode,
                          nchan=nchan, length=pad_len)
    off = t0 - b0 * RNG_BLOCK
    return field[..., off:off + length]


def chan_chi2_field(key, chan_ids, df, t0, length, block=SEQ_RNG_BLOCK):
    """Per-channel χ² fields — the pipelines' entry point: ``(..., C,
    length)`` for keys ``(..., 2)``, contiguous GLOBAL channel ids
    ``chan_ids`` and global first sample ``t0``.

    Dispatches between the CUDA kernel and the blocked threefry draws (see
    :func:`sampler_backend`); the choice never depends on span alignment,
    so split invariance holds on either.  On the kernel path the first
    channel id should be a multiple of 8 for cross-split stream equality.
    """
    if sampler_backend(key.device) == "hw" and block == SEQ_RNG_BLOCK:
        mode = _hw_chi2_mode(df)
        if mode is not None:
            dfv = 0.0 if mode == "chi2_1" else df
            return _hw_field_span(key, chan_ids, dfv, t0, mode, length)
    return blocked_chan_chi2(key, chan_ids, df, t0, length, block)


def chan_normal_field(key, chan_ids, t0, length, block=SEQ_RNG_BLOCK):
    """Per-channel standard-normal fields (see :func:`chan_chi2_field`)."""
    if sampler_backend(key.device) == "hw" and block == SEQ_RNG_BLOCK:
        return _hw_field_span(key, chan_ids, 0.0, t0, "normal", length)
    return blocked_chan_normal(key, chan_ids, t0, length, block)


# one sampler tile: 8 channel rows x one RNG block
FLAT_TILE = 8 * SEQ_RNG_BLOCK

# the largest global flat offset a flat stream may reach: the JAX package
# carries flat offsets as int32, so a consumer past it keeps the
# per-channel-keyed path (and the kernel's offsets are int32 too)
FLAT_MAX_OFFSET = 2**31 - 1


def _flat_draw(key, f0, length, mode, df):
    """The flat stream's span ``[f0, f0 + length)`` for keys ``(..., 2)``
    in the kernel's ``mode``: ``(..., length)``.  Whole tiles from tile
    ``f0 // FLAT_TILE`` on, one tile of overdraw when ``f0`` is not a tile
    boundary, as the reference does."""
    f0, length = int(f0), int(length)
    b0, skip = divmod(f0, FLAT_TILE)
    lead = key.shape[:-1]
    if sampler_backend(key.device) == "hw":
        from .rng_hw import rng_flat_field, seed_words

        seeds = seed_words(key.reshape(-1, 2)).contiguous()
        B = seeds.shape[0]
        if isinstance(df, torch.Tensor):
            dfs = df.to(device=key.device, dtype=_F32).expand(lead)
            dfs = dfs.reshape(B).contiguous()
        else:
            dfs = torch.full((B,), float(df), dtype=_F32, device=key.device)
        pos = torch.zeros((B, 2), dtype=torch.int32, device=key.device)
        pos[:, 1] = b0
        out = rng_flat_field(seeds, dfs, pos, mode, skip, length)
        return out.reshape(lead + (length,))
    if mode != "normal":
        raise ValueError("the threefry flat stream draws normals only")
    nt = -(-(skip + length) // FLAT_TILE)
    z = blocked_chan_normal(key, torch.arange(8), b0 * SEQ_RNG_BLOCK,
                            nt * SEQ_RNG_BLOCK)
    flat = z.reshape(lead + (8, nt, SEQ_RNG_BLOCK)).transpose(-3, -2)
    return flat.reshape(lead + (nt * FLAT_TILE,))[..., skip:skip + length]


def flat_normal_field(key, f0, length):
    """A standard-normal stream at GLOBAL flat offset ``f0`` (reference:
    ``flat_normal_field``): ``(..., length)`` for keys ``(..., 2)``.

    The stream is whole ``(8, SEQ_RNG_BLOCK)`` tiles of channel group 0,
    keyed by (channel 0-7, global block), flattened in (block, channel,
    sample) order, so every drawn sample is used whatever the consumer's
    channel count, and any span is the same for any split.  On the card
    the sampler kernel stores that order directly (``rng_flat_field``);
    elsewhere the blocked threefry rows are reordered, as the JAX package
    does off a TPU.
    """
    return _flat_draw(key, f0, length, "normal", 0.0)


def flat_chi2_field(key, f0, length, df):
    """χ² draws from the flat normal stream (reference:
    ``flat_chi2_field``): df = 1 is ``z²``, a static df ≥ 50 the
    Wilson–Hilferty cube of ``z``, a per-observation df tensor selects
    between the two.  On the card the transform runs in the kernel's
    registers.  A static df below 50 (other than 1) raises: the gamma
    sampler has no flat-normal form (:func:`flat_chi2_ok` guards it)."""
    static_df = _static_df(df)
    if (static_df is not None and static_df != 1.0
            and static_df < CHI2_WH_MIN_DF):
        raise ValueError(
            f"flat_chi2_field needs df=1 or df >= {CHI2_WH_MIN_DF:.0f} "
            f"(got {static_df}): small-df chi2 uses the gamma rejection "
            "sampler, which has no flat-normal form — use chan_chi2_field")
    if sampler_backend(key.device) == "hw":
        mode = _hw_chi2_mode(df)
        return _flat_draw(key, f0, length, mode,
                          0.0 if mode == "chi2_1" else df)
    z = flat_normal_field(key, f0, length)
    if static_df == 1.0:
        return z * z
    if static_df is not None:
        return wilson_hilferty(z, static_df, fused=True)
    k = df.to(device=z.device, dtype=_F32).reshape(
        df.shape + (1,) * (z.dim() - df.dim()))
    return torch.where(k == 1.0, z * z, wilson_hilferty(z, k, fused=True))


def flat_chi2_ok(df, span_end=None):
    """Whether :func:`flat_chi2_field` may draw ``df`` (reference:
    ``flat_chi2_ok``): not under ``PSS_EXACT_CHI2=1``, not for a span whose
    largest GLOBAL flat offset ``span_end`` passes
    :data:`FLAT_MAX_OFFSET` (callers pass the global bound, so every split
    picks the same realization), and only for df = 1, df ≥ 50 or a
    per-observation df tensor."""
    if os.environ.get("PSS_EXACT_CHI2"):
        return False
    if span_end is not None and int(span_end) > FLAT_MAX_OFFSET:
        return False
    static_df = _static_df(df)
    if static_df is None:
        return True
    return static_df == 1.0 or static_df >= CHI2_WH_MIN_DF


def choice(key, n, p=None):
    """``jax.random.choice(key, n, p=p)`` (one draw, with replacement) for
    keys ``(..., 2)`` -> ``(...)`` int64 indices in ``[0, n)``.  Without
    ``p`` it is :func:`~psrsigsim_torch.utils.rng.randint`; with ``p``
    (float32 probabilities) jax draws ``r = cumsum(p)[-1] · (1 - u)`` for
    one uniform ``u`` and takes the first index whose running sum reaches
    ``r``.  The running sum is sequential float32, as XLA's CPU backend
    computes ``jnp.cumsum`` of a short vector."""
    n = int(n)
    if p is None:
        return randint(key, n)
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {p.shape}")
    cum = torch.as_tensor(np.cumsum(p, dtype=np.float32), device=key.device)
    u = uniform(key, 1)[..., 0]
    r = cum[-1] * (1.0 - u)
    return torch.searchsorted(cum, r.contiguous(), side="left")


def fixed_histogram(x, lo, hi, nbins, weights=None):
    """Fixed-bin histograms (counterpart: ``fixed_histogram`` of the JAX
    package): int32 counts of ``x`` ``(..., N)`` over ``nbins`` equal bins
    spanning ``[lo, hi)``, one histogram per leading index -> ``(...,
    nbins)``.  ``lo``/``hi`` broadcast against the leading axes;
    ``weights`` are int 0/1 validity masks shaped like ``x`` (default all
    ones).

    Out-of-range values clamp into the edge bins and a NaN lands in bin 0,
    as XLA's saturating float → int32 conversion puts them; the counts are
    integers, so merging chunks is exact in any order."""
    nbins = int(nbins)
    if nbins <= 0:
        raise ValueError(f"nbins={nbins} must be positive")
    x = x.to(_F32)

    def bound(v):   # numbers become fills, never host->device copies
        if isinstance(v, torch.Tensor):
            return v.to(device=x.device, dtype=_F32)
        return torch.full((), float(v), dtype=_F32, device=x.device)

    lo, hi = bound(lo)[..., None], bound(hi)[..., None]
    span = torch.clamp_min(hi - lo, 1e-30)
    v = torch.floor((x - lo) / span * nbins)
    idx = torch.clamp(torch.nan_to_num(v, nan=0.0), 0, nbins - 1).to(
        torch.int64)
    w = (torch.ones_like(idx) if weights is None
         else torch.as_tensor(weights, device=x.device).to(
             torch.int64).expand_as(idx))
    counts = torch.zeros(idx.shape[:-1] + (nbins,), dtype=torch.int64,
                         device=x.device)
    return counts.scatter_add_(-1, idx, w).to(torch.int32)


def chi2_draw_norm(dtype, df):
    """Dynamic-range normalization for intensity draws (host-side, static):
    float32 signals draw unnormalized with clip ceiling 200; int8 signals
    map the 99.9th percentile of χ²(df) to ``int8 max`` (reference:
    psrsigsim/signal/fb_signal.py:114-121).  Returns
    ``(draw_max, draw_norm)``."""
    from scipy import stats as _sps

    if dtype == np.int8 or dtype == torch.int8:
        limit = _sps.chi2.ppf(0.999, df)
        draw_max = float(np.iinfo(np.int8).max)
        return draw_max, draw_max / float(limit)
    return 200.0, 1.0
