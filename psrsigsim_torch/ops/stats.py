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
arithmetic XLA compiles for the JAX package's jitted kernels).  A static
df below 50 (other than 1), and every χ² draw under ``PSS_EXACT_CHI2=1``,
takes the exact branch: ``2·jax.random.gamma(key, df/2)``, drawn bit for
bit (``gamma_plain``, with XLA's arithmetic for a static or a traced α)
by the exact-gamma kernel of :mod:`.gamma` on the card, from the same
keys the reference splits: one per (channel, block) for the blocked
fields, one per shape-level draw.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..runtime.telemetry import count, span
from ..utils.device import to_device
from ..utils.rng import fold_in, randint, random_bits, threefry2x32
from ._xla_tables import _EXP2F, _POWF_LOG2, _RSQRT_TABLE

__all__ = ["SEQ_RNG_BLOCK", "CHI2_WH_MIN_DF", "fma", "exp", "erf_inv",
           "uniform", "normal", "normal_sample", "chi2_sample",
           "chi2_sample_compiled", "chi2_noise_compiled", "blocked_chan_chi2",
           "blocked_chan_normal", "sampler_backend",
           "chan_chi2_field", "chan_normal_field", "FLAT_TILE",
           "FLAT_MAX_OFFSET", "flat_normal_field", "flat_chi2_field",
           "flat_chi2_ok", "flat_spans", "chi2_draw_norm", "choice",
           "fixed_histogram", "exponential"]

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
    return _bits_uniform(random_bits(key, n, start), minval, maxval)


def _bits_uniform(bits, minval, maxval):
    """jax's float32 uniform of 32-bit words: the top 23 bits as a
    mantissa in [1, 2), minus 1, scaled into ``[minval, maxval)`` by one
    fused multiply-add (XLA drops the ``* 1 + 0`` of ``[0, 1)``)."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return torch.clamp_min(floats, 0.0)
    lo = torch.full((), minval, dtype=_F32, device=bits.device)
    hi = torch.full((), maxval, dtype=_F32, device=bits.device)
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


_THIRD = _f32(1.0 / 3.0)
_SQUEEZE = _f32(0.0331)


def _log0(x):
    """:func:`_log` with XLA's ``log(0) = -inf`` (the acceptance test's
    uniform can be 0)."""
    return torch.where(x == 0.0, float("-inf"), _log(x))


def _flush(x):
    """XLA's CPU code runs with flush-to-zero: a subnormal result is 0."""
    return torch.where(x.abs() < _FLT_MIN, torch.zeros_like(x), x)


_TABLES = {}


def xla_tables(dev):
    """The host libraries' tables (:mod:`._xla_tables`) on ``dev``, made
    once per device: glibc's powf tables as one float64 tensor
    (``__powf_log2_data``'s 37 values, then ``__exp2f_data``'s 36: the
    layout the exact-gamma kernel reads) and the ``rsqrtss`` estimates as
    int64 words."""
    dev = torch.device(dev)
    t = _TABLES.get(dev)
    if t is None:
        words = [int(_RSQRT_TABLE[i:i + 4], 16)
                 for i in range(0, len(_RSQRT_TABLE), 4)]
        t = (torch.cat([_f64(_POWF_LOG2), _f64(_EXP2F)]).to(dev),
             torch.tensor(words, dtype=torch.int64, device=dev))
        _TABLES[dev] = t
    return t


def _rsqrt_estimate(x):
    """x86 ``rsqrtss`` of positive normal float32 ``x``: the estimate for
    the exponent's parity and top 10 mantissa bits from
    :data:`._xla_tables._RSQRT_TABLE`, scaled by ``2^-(e - parity)/2``."""
    bits = x.view(torch.int32).to(torch.int64)
    e = (bits >> 23) - 127
    par = e & 1
    j = (par << 10) | ((bits >> 13) & 0x3FF)
    y0 = (7 << 27) | (xla_tables(x.device)[1][j] << 11)
    y0 = y0 - (((e - par) >> 1) << 23)
    return y0.to(torch.int32).view(_F32)


def rsqrt_xla(x):
    """XLA CPU's float32 ``rsqrt`` of positive normal ``x``: the
    ``rsqrtss`` estimate, then two Newton steps ``y += (-y/2)·(x·y·y - 1)``
    with the multiply-adds XLA's code contracts, ``fma(-y/2, fma(x·y, y,
    -1), y)``."""
    y = _rsqrt_estimate(x)
    for _ in range(2):
        y = fma(y * -0.5, fma(x * y, y, -1.0), y)
    return y


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(x):
    c = x * 134217729.0          # 2**27 + 1, Veltkamp's split
    hi = c - (c - x)
    return hi, x - hi


def fma64(a, b, c):
    """Correctly rounded float64 ``a*b + c`` from float64 operations
    (Boldo and Melquiond's emulation: the exact product as a pair, an
    exact sum with ``c``, the low parts added with rounding to odd, one
    final rounding).  Finite operands without overflow or underflow."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def _f64(words):
    """float64 values of their bit patterns."""
    return torch.from_numpy(np.array(words, np.uint64).view(np.float64))


def powf(x, y):
    """glibc's float32 ``powf(x, y)`` — the function XLA's CPU code calls
    for a float32 power — for positive normal ``x`` and finite ``y > 0``
    with ``x^y`` at most 1 (the gamma sampler's boost): float64 ``log2``
    from its table and polynomial, times ``y``, float64 ``exp2`` from its
    table and polynomial, each multiply-add fused as its FMA build has it
    (:func:`fma64`), rounded to float32 and flushed as XLA's code runs
    (:data:`._xla_tables._POWF_LOG2`)."""
    tab = xla_tables(x.device)[0]
    lg, ex = tab[:len(_POWF_LOG2)], tab[len(_POWF_LOG2):]
    ix = x.to(_F32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = torch.where(top >= 2**31, top - 2**32, top) >> 23
    z = torch.where(iz >= 2**31, iz - 2**32, iz).to(torch.int32).view(
        _F32).double()
    invc, logc = lg[2 * i], lg[2 * i + 1]
    r = fma64(z, invc, -1.0)
    y0 = logc + k.double()
    yy = fma64(r, lg[32], lg[33])
    p = fma64(r, lg[34], lg[35])
    r2 = r * r
    q = fma64(r, lg[36], y0)
    r4 = r2 * r2
    q = fma64(r2, p, q)
    logx = fma64(yy, r4, q)
    ylogx = y.to(_F32).double() * logx
    kd = ylogx + ex[32]
    ki = kd.view(torch.int64)
    kd = kd - ex[32]
    r = ylogx - kd
    t = ex[:32].view(torch.int64)[ki & 31] + ((ki & 0x1FFFF) << 47)
    s = t.view(torch.float64)
    zz = fma64(r, ex[33], ex[34])
    r2 = r * r
    yv = fma64(r, ex[35], 1.0)
    yv = fma64(zz, r2, yv) * s
    # y·log2(x) <= -150 is glibc's underflow branch (a zero)
    return _flush(torch.where(ylogx <= -150.0, 0.0, yv).to(_F32))


def check_alpha(alpha):
    """Raise ``ValueError`` unless every float32 ``alpha`` is > 0 (NaN
    fails it).  It reads ``alpha`` on the host: free for a CPU tensor, a
    sync for a card tensor, counted in ``gamma.host_checks``."""
    if alpha.device.type != "cpu":
        count("gamma.host_checks")
    if not bool((alpha > 0).all()):
        raise ValueError("gamma needs alpha > 0")


def gamma_consts(alpha, traced=False):
    """Per-row constants of jax's Marsaglia–Tsang sampler for float32
    ``alpha`` (> 0): ``(boost, d, c, inv_alpha)`` — α < 1 is boosted to
    α + 1, ``d = α - 1/3``, ``c = (1/3) / sqrt(d)``, and ``1/α`` (of the
    unboosted α) for the boost's power.  A static α (``traced=False``, the
    JAX package's jitted pipelines) has its constants folded by XLA's
    evaluator, correctly rounded; a traced one (an eager call, a
    per-observation df) computes ``c = (1/3) · rsqrt(d)``, XLA's
    :func:`rsqrt_xla` (psrsigsim_torch/DIVERGENCES.md P21).  ``alpha`` is
    checked first (:func:`check_alpha`).  The constants are the same bits
    on the host and on the card;
    :func:`~psrsigsim_torch.ops.gamma.gamma_field` computes them on the
    host for every α it is given (``gamma.host_alpha``)."""
    alpha = alpha.to(_F32)
    check_alpha(alpha)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - _THIRD
    if traced:
        c = rsqrt_xla(d) * _THIRD
    else:
        c = torch.full_like(d, _THIRD) / _sqrt(d)
    return boost, d, c, torch.ones_like(alpha) / alpha


def _tf(k0, k1, ctr):
    """Both threefry words of counter ``ctr`` (a split key)."""
    z = torch.zeros_like(k0)
    return threefry2x32(k0, k1, z, z + ctr)


def _tf_bits(k0, k1):
    """The 32 random bits of one draw from key ``(k0, k1)``."""
    o0, o1 = _tf(k0, k1, 0)
    return o0 ^ o1


def gamma_plain(keys, alpha, n, start=0, traced=False, scale=1.0,
                cube=False, counts=None):
    """``jax.random.gamma(key, alpha, (N,), float32)`` elements ``start ..
    start+n-1`` for each row, times ``scale``: ``(R, n)`` float32 for keys
    ``(R, 2)`` and float32 ``alpha`` ``(R,)`` — bit for bit, the plain
    version of the exact-gamma kernel (``ops/gamma.py``); ``traced``
    selects the constants of a traced α (:func:`gamma_consts`); ``cube``
    returns the accepted ``V = v³`` instead, for rows with α ≥ 1 (the form
    XLA folds ``d`` out of, :func:`chi2_noise_compiled`).  A ``counts``
    dict gets the passes the draw took added to its ``"outer"``,
    ``"inner"`` and ``"boost"`` entries (the work a kernel's bound counts).

    jax splits the row key into one key per element (element ``i``'s key is
    both threefry words of counter ``i``) and runs Marsaglia–Tsang on each
    (``_gamma_one``): ``key, subkey = split(key)``; then rejection passes,
    each ``key, kx, ku = split(key, 3)``, an inner ``while v <= 0`` loop of
    ``kx, k = split(kx)``, ``x = normal(k)``, ``v = 1 + x·c``, and ``U =
    uniform(ku)``, until ``U < 1 - 0.0331·X²`` or ``log U < X/2 + d·(1 - V
    + log V)`` with ``X = x²``, ``V = v³``; the draw is ``d·V`` times
    ``(1 - uniform(subkey))^(1/α)`` where α was boosted.  The arithmetic is
    what XLA's CPU backend compiles for it (psrsigsim_torch/DIVERGENCES.md
    P21): ``v = fma(x, c, 1)``, the
    squeeze bound ``fma(-X·X, 0.0331, 1)``, ``log`` XLA's polynomial with
    ``log(0) = -inf``, ``X/2 + d·s`` (the multiply-add XLA contracts there
    is exact: ``X/2`` is), the power glibc's ``powf`` (:func:`powf`) except
    where XLA rewrites a static power of 2 or 3 as products, subnormals
    flushed.  Each loop runs over its still-active elements only, and a
    split key is derived only where the draw reads it (the subkey for a
    boosted α, the next key after a rejection, the next kx after ``v <=
    0``): the same keys."""
    dev = keys.device
    R = keys.shape[0]
    alpha = alpha.to(device=dev, dtype=_F32).reshape(R)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=dev)
    e0, e1 = threefry2x32(keys[:, 0, None], keys[:, 1, None],
                          idx >> 32, idx & 0xFFFFFFFF)
    e0, e1 = e0.reshape(-1), e1.reshape(-1)
    boost, d, c, inv_alpha = (t[:, None].expand(R, n).reshape(-1)
                              for t in gamma_consts(alpha, traced))
    k0, k1 = _tf(e0, e1, 0)
    V = torch.empty(R * n, dtype=_F32, device=dev)
    act = torch.arange(R * n, dtype=torch.int64, device=dev)
    tally = counts if counts is not None else {}
    for name in ("outer", "inner", "boost"):
        tally.setdefault(name, 0)
    while act.numel():
        tally["outer"] += act.numel()
        a0, a1 = k0[act], k1[act]
        x0, x1 = _tf(a0, a1, 1)
        ca = c[act]
        x = torch.zeros(act.shape, dtype=_F32, device=dev)
        v = torch.full(act.shape, -1.0, dtype=_F32, device=dev)
        inner = torch.arange(act.numel(), dtype=torch.int64, device=dev)
        while inner.numel():
            tally["inner"] += inner.numel()
            b0, b1 = x0[inner], x1[inner]
            w0, w1 = _tf(b0, b1, 1)
            u = _bits_uniform(_tf_bits(w0, w1), _NORMAL_LO, 1.0)
            xi = _SQRT2 * erf_inv(u)
            vi = fma(xi, ca[inner], 1.0)
            x[inner], v[inner] = xi, vi
            again = vi <= 0.0
            inner = inner[again]
            x0[inner], x1[inner] = _tf(b0[again], b1[again], 0)
        X = x * x
        Vn = (v * v) * v
        U = _bits_uniform(_tf_bits(*_tf(a0, a1, 2)), 0.0, 1.0)
        reject = ((U >= fma(-(X * X), _SQUEEZE, 1.0))
                  & (_log0(U) >= X * 0.5 + d[act] * ((1.0 - Vn) + _log0(Vn))))
        V[act] = Vn
        act = act[reject]
        k0[act], k1[act] = _tf(a0[reject], a1[reject], 0)
    if cube:
        return V.reshape(R, n)
    out = d * V
    b = boost.nonzero().reshape(-1)
    if b.numel():
        tally["boost"] += b.numel()
        samples = 1.0 - _bits_uniform(_tf_bits(*_tf(e0[b], e1[b], 1)),
                                      0.0, 1.0)
        ia = inv_alpha[b]
        pw = powf(samples, ia)
        if not traced:  # XLA rewrites a constant power 2 or 3 as products
            pw = torch.where(ia == 2.0, samples * samples, pw)
            pw = torch.where(ia == 3.0, (samples * samples) * samples, pw)
        out[b] = _flush(out[b] * pw)
    return (out * scale).reshape(R, n)


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


def _gamma_routed(df):
    """Whether the reference draws χ²(df) through the exact gamma sampler:
    everywhere under ``PSS_EXACT_CHI2=1`` (df = 1 and a per-observation df
    included), else a static df below :data:`CHI2_WH_MIN_DF` other than 1
    (reference: ``chi2_sample``)."""
    if os.environ.get("PSS_EXACT_CHI2"):
        return True
    static_df = _static_df(df)
    return (static_df is not None and static_df != 1.0
            and static_df < CHI2_WH_MIN_DF)


def _exact_chi2(key, df, shape, traced):
    """``2·jax.random.gamma(key, df/2, shape)`` for keys ``(..., 2)`` ->
    ``(..., *shape)`` (reference: ``_exact_chi2``): one row of
    ``prod(shape)`` elements per key, α = float32(df)/2; a df tensor has
    one entry per leading index of the keys (per observation) or of a
    prefix of them.  Drawn by :func:`~psrsigsim_torch.ops.gamma.gamma_field`
    (the kernel on the card, :func:`gamma_plain` on the host); ``traced``
    as there.  α goes down where it was born: a static df as the Python
    number float32(df)/2, a host df tensor as a CPU tensor, so that
    ``gamma_field`` checks α (> 0; ``ValueError`` before any draw) and
    computes its constants on the host, and the launch reads nothing back
    (``gamma.host_alpha``); a df tensor on the card is read back once
    for it, a sync (``gamma.host_checks``)."""
    from .gamma import gamma_field

    shape = _shape(shape)
    lead = key.shape[:-1]
    if isinstance(df, torch.Tensor):
        k = df.to(dtype=_F32)
        if k.device.type != "cpu":
            k = k.to(key.device)
        k = k.reshape(k.shape + (1,) * (len(lead) - k.dim())).expand(lead)
        alpha = (k / 2.0).reshape(-1).contiguous()
    else:
        alpha = float(np.float32(df) / np.float32(2.0))
    out = gamma_field(key.reshape(-1, 2), alpha, int(np.prod(shape)),
                      scale=2.0, traced=traced)
    return out.reshape(lead + shape)


def _chi2_from_normal(z, df):
    """χ² draws from standard normals ``z`` (``(..., C, L)``) for the df
    the reference transforms normals for: df = 1 is ``z²``, a static df ≥
    50 Wilson–Hilferty, a df tensor (one entry per leading index of ``z``,
    one per observation) selects between the two."""
    static_df = _static_df(df)
    if static_df == 1.0:
        return z * z
    if static_df is not None:
        return wilson_hilferty(z, static_df)
    k = df.to(device=z.device, dtype=_F32).reshape(
        df.shape + (1,) * (z.dim() - df.dim()))
    return torch.where(k == 1.0, z * z, wilson_hilferty(z, k))


def chi2_sample(key, df, shape):
    """χ²(df) draws ``(..., *shape)`` from one key per leading index
    (reference: ``chi2_sample``, called eagerly); ``shape`` an int or a
    tuple.  df = 1, df ≥ 50 and a df tensor transform the draws of
    :func:`normal_sample`; a static df below 50, or anything under
    ``PSS_EXACT_CHI2=1``, draws the exact gamma with the arithmetic of an
    eager call (jax traces α: :func:`gamma_consts`)."""
    if _gamma_routed(df):
        return _exact_chi2(key, df, shape, traced=True)
    return _chi2_from_normal(normal_sample(key, shape), df)


def chi2_sample_compiled(key, df, shape):
    """:func:`chi2_sample` for a static df, with the arithmetic XLA
    compiles when the caller is jitted with df static (the JAX package's
    object-oriented kernels: ``Pulsar._fold_pulse_kernel``,
    ``Receiver._add_pow_noise_kernel``).  XLA folds ``sqrt(2)`` of the
    normal and ``sqrt(c)`` of Wilson–Hilferty into one float32 constant and
    contracts the add, so ``t = fma(erf_inv(u), f32(sqrt(2)·sqrt(c)),
    1 - c)``; df = 1 (``z²``) compiles to :func:`chi2_sample`'s
    arithmetic; the exact gamma (a df below 50, or ``PSS_EXACT_CHI2=1``)
    takes the constants XLA folds for a static α."""
    static_df = _static_df(df)
    if _gamma_routed(df):
        return _exact_chi2(key, df, shape, traced=static_df is None)
    if static_df is None or static_df == 1.0:
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


def chi2_noise_compiled(key, df, data, norm):
    """``data + χ²(df)·norm`` with the arithmetic XLA compiles for the JAX
    package's ``Receiver._add_pow_noise_kernel`` (jitted, df static): the
    scale-and-add is one fused multiply-add, ``fma(χ², norm, data)``.  An
    exact-gamma draw of α = df/2 ≥ 1 is ``(d·V)·2``, and there XLA folds
    the constants into the scalar, ``fma(V, f32(norm·f32(2d)), data)``;
    below α = 1 the boost stands between them and only the 2 moves, which
    changes no bit.  α goes to ``gamma_field`` as a host number, checked
    and its constants computed on the host, as in :func:`_exact_chi2`."""
    static_df = _static_df(df)
    shape = tuple(data.shape)
    if (static_df is not None and static_df >= 2.0
            and _gamma_routed(static_df)):
        from .gamma import gamma_field

        alpha = torch.full((1,), static_df, dtype=_F32) / 2.0
        d = gamma_consts(alpha)[1]
        c = float(torch.tensor(norm, dtype=_F32) * (d * 2.0))
        v = gamma_field(key.reshape(-1, 2), float(alpha),
                        int(np.prod(shape)), cube=True)
        return fma(v.reshape(key.shape[:-1] + shape), c, data)
    return fma(chi2_sample_compiled(key, df, shape), norm, data)


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
    kb, off = _block_keys(key, chan_ids, t0, length, block)
    z = _from_uniform(kb, block, transform)                      # (..., C, nblk, block)
    z = z.reshape(z.shape[:-2] + (z.shape[-2] * block,))
    return z[..., off:off + length]


def _block_keys(key, chan_ids, t0, length, block):
    """The (channel, global block) keys ``(..., C, nblk, 2)`` covering the
    global span ``[t0, t0+length)``, and the span's offset in the first
    block."""
    t0 = int(t0)
    b0 = t0 // block
    off = t0 - b0 * block
    nblk = -(-(off + length) // block)
    chan_ids = to_device(torch.as_tensor(chan_ids, dtype=torch.int64), key.device)
    ck = fold_in(key[..., None, :], chan_ids)                    # (..., C, 2)
    blocks = torch.arange(b0, b0 + nblk, dtype=torch.int64, device=key.device)
    return fold_in(ck[..., None, :], blocks), off                # (..., C, nblk, 2)


def _blocked_chan_gamma(key, chan_ids, df, t0, length, block):
    """Exact-gamma χ² fields over the blocks of :func:`blocked_chan_normal`:
    each (channel, global block) key draws ``chi2_sample(k, df, (block,))``
    through the gamma sampler, as the reference's blocked draw does; a
    static df takes XLA's folded constants, a df tensor (one per leading
    index of the keys) the traced ones.  The blocked keys and the draws
    are timed as a child ``fields`` of the span open on this thread (a
    chunk's ``dispatch.fields`` under ``iter_chunks``; nothing without
    one)."""
    with span("fields"):
        kb, off = _block_keys(key, chan_ids, t0, length, block)
        z = _exact_chi2(kb, df, (block,),
                        traced=isinstance(df, torch.Tensor))
    z = z.reshape(z.shape[:-2] + (z.shape[-2] * block,))
    return z[..., off:off + length]


def blocked_chan_chi2(key, chan_ids, df, t0, length, block=SEQ_RNG_BLOCK):
    """Blocked threefry χ² draws (reference: ``blocked_chan_chi2``).  A df
    tensor (one per observation, the reference's traced df) takes the
    arithmetic XLA compiles for it: ``sqrt(2)`` of the normal folded into
    Wilson–Hilferty's ``sqrt(c)``, the add fused, ``t = fma(erf_inv(u),
    f32(sqrt(2)·sqrt(c)), 1 - c)``, and ``z²`` where df = 1.  A static df
    below 50 (other than 1), or any df under ``PSS_EXACT_CHI2=1``, draws
    the exact gamma of each (channel, block) key instead
    (:func:`_blocked_chan_gamma`)."""
    if _gamma_routed(df):
        return _blocked_chan_gamma(key, chan_ids, df, t0, length, block)
    if not isinstance(df, torch.Tensor):
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
    * ``PSS_EXACT_CHI2=1`` forces threefry, whose χ² fields are then the
      exact gamma draws (:func:`blocked_chan_chi2`);
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


def _check_flat_df(df):
    """A static df's value (None for a tensor), after refusing one the flat
    stream cannot draw."""
    static_df = _static_df(df)
    if (static_df is not None and static_df != 1.0
            and static_df < CHI2_WH_MIN_DF):
        raise ValueError(
            f"flat_chi2_field needs df=1 or df >= {CHI2_WH_MIN_DF:.0f} "
            f"(got {static_df}): small-df chi2 uses the gamma rejection "
            "sampler, which has no flat-normal form — use chan_chi2_field")
    return static_df


def flat_chi2_field(key, f0, length, df):
    """χ² draws from the flat normal stream (reference:
    ``flat_chi2_field``): df = 1 is ``z²``, a static df ≥ 50 the
    Wilson–Hilferty cube of ``z``, a per-observation df tensor selects
    between the two.  On the card the transform runs in the kernel's
    registers.  A static df below 50 (other than 1) raises: the gamma
    sampler has no flat-normal form (:func:`flat_chi2_ok` guards it)."""
    static_df = _check_flat_df(df)
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


def flat_spans(key, f0s, length, df=None):
    """Several spans of one flat stream: ``(..., len(f0s), length)``, span
    ``s`` equal to ``flat_normal_field(key, f0s[s], length)`` (``df``
    None) or ``flat_chi2_field(key, f0s[s], length, df)``, bit for bit —
    e.g. a time slab of every channel, at offsets ``c·nsamp + t0``.

    On the card the spans that share a tile phase ``f0 % FLAT_TILE`` are
    one launch of the flat kernel, a row per (key, span) with the span's
    first block in the row's position; elsewhere each span is drawn as
    above."""
    f0s = [int(f) for f in f0s]
    if df is not None:
        _check_flat_df(df)
    if sampler_backend(key.device) != "hw":
        return torch.stack([flat_normal_field(key, f, length) if df is None
                            else flat_chi2_field(key, f, length, df)
                            for f in f0s], dim=-2)
    from .rng_hw import rng_flat_field, seed_words

    mode = "normal" if df is None else _hw_chi2_mode(df)
    dev = key.device
    lead = key.shape[:-1]
    seeds = seed_words(key.reshape(-1, 2))
    B = seeds.shape[0]
    if isinstance(df, torch.Tensor):
        dfs = df.to(device=dev, dtype=_F32).expand(lead).reshape(B)
    else:
        dfv = 0.0 if mode in ("normal", "chi2_1") else float(df)
        dfs = torch.full((B,), dfv, dtype=_F32, device=dev)
    out = torch.empty((B, len(f0s), int(length)), dtype=_F32, device=dev)
    groups = {}
    for s, f in enumerate(f0s):
        b0, skip = divmod(f, FLAT_TILE)
        groups.setdefault(skip, []).append((s, b0))
    for skip, members in groups.items():
        G = len(members)
        pos = torch.zeros((B * G, 2), dtype=torch.int32)
        pos[:, 1] = torch.tensor([b0 for _, b0 in members],
                                 dtype=torch.int32).repeat(B)
        rows = rng_flat_field(
            seeds.repeat_interleave(G, dim=0).contiguous(),
            dfs.repeat_interleave(G).contiguous(), to_device(pos, dev),
            mode, skip, int(length))
        idx = [s for s, _ in members]
        if idx == list(range(idx[0], idx[0] + G)):
            out[:, idx[0]:idx[0] + G] = rows.view(B, G, -1)
        else:
            out[:, idx] = rows.view(B, G, -1)
    return out.reshape(lead + (len(f0s), int(length)))


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
