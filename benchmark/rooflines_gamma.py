"""Operation and byte counts of K9 (``csrc/gamma_field.cu``, the exact
chi-square branch's gamma draws) and the least time one NVIDIA H100 SXM
could take for them, from the output's shape and the stream it must
reproduce (``jax.random.gamma``'s Marsaglia-Tsang draws, bit for bit),
never from the launch layout.

Per accepted draw at a static alpha >= 1, the stream needs threefry2x32
calls for: the element's key (its row key's split) and the first pass's
key; each rejection pass's ``kx``, ``ku`` and ``U``'s bits, and the next
pass's key after a rejection; each inner pass's normal key and bits, and
the next ``kx`` after a repeat.  With ``o`` passes and ``i`` inner passes
a draw that is ``1 + 3 o + 3 i`` calls.  The expected passes follow from
the acceptance probability of Marsaglia and Tsang's test,
``P = e^d Gamma(alpha) / (3 c sqrt(2 pi) d^alpha)`` (the accepted
density's integral over the normal's), and the inner loop repeats with
probability ``Phi(-1/c)``.

Operations by pipe: the XORs and rotates of threefry and the bit
extraction of each uniform run on the integer pipe only (``int32``, 64 an
SM a clock); every operation, the adds included (ptxas issues part of them
as IMAD on the FMA pipe), takes an issue slot, 128 an SM a clock, the
``fp32`` class's rate in ``rooflines.RATES``.  The bound is the larger of
the two and of the bytes: the draws written, each row's key and constants
read.
"""

from __future__ import annotations

import math

from benchmark.rooflines import bound_s

# threefry2x32, 20 rounds: per round an add, a rotate and an XOR; the key
# added before the rounds (2); five key injections of two adds and the
# round counter's add folded into one of them (2 each); the key schedule's
# XOR of both words and the constant (one three-input logic op)
THREEFRY_ROTATE_XOR = 20 * 2 + 1
THREEFRY_OPS = 20 * 3 + 2 + 5 * 2 + 1
# a uniform from a call's two words: their XOR, the shift and the OR of
# the exponent (integer pipe), the float subtract of 1 (and for the normal
# the scale and offset, counted in its float work)
UNIFORM_INT = 3
# K9's float32 work, counted from csrc/gamma_field.cu: an inner pass
# draws a normal (the uniform's scale and clamp 3; log1p's small branch
# 20: 12 FMAs, the division as one, 7 more; erf_inv's 8 FMAs, 8
# coefficient selects and 7 more) and v = fma(x, c, 1) with its test: 48;
# an outer pass forms X, V and U (5), the squeeze bound and its test (3),
# two XLA logs (26 each) and the log test (7): 67; the draw d * V * scale:
# 2.  The division's and the selects' expansions are not counted, so the
# bound is a lower one.
FP32_INNER, FP32_OUTER, FP32_DRAW = 48, 67, 2


def constants(alpha):
    """Marsaglia and Tsang's ``(d, c)`` for ``alpha >= 1``."""
    d = alpha - 1.0 / 3.0
    return d, 1.0 / (3.0 * math.sqrt(d))


def passes(alpha):
    """``(outer, inner)``: the expected rejection passes and inner passes
    of one accepted draw at ``alpha >= 1``."""
    d, c = constants(alpha)
    accept = math.exp(d + math.lgamma(alpha) - math.log(3.0 * c)
                      - 0.5 * math.log(2.0 * math.pi) - alpha * math.log(d))
    repeat = 0.5 * math.erfc(1.0 / (c * math.sqrt(2.0)))
    outer = 1.0 / accept
    return outer, outer / (1.0 - repeat)


def ops_per_draw(alpha):
    """Operations of one accepted draw by class (``int32``: the integer
    pipe's own; ``fp32``: every operation, at the issue rate) and the
    threefry calls among them."""
    o, i = passes(alpha)
    calls = 1 + 3 * o + 3 * i
    uniforms = o + i
    int_only = THREEFRY_ROTATE_XOR * calls + UNIFORM_INT * uniforms
    every = (THREEFRY_OPS * calls + UNIFORM_INT * uniforms
             + FP32_INNER * i + FP32_OUTER * o + FP32_DRAW)
    return {"int32": int_only, "fp32": every}, calls


def k9_gamma_field(rows, n, alpha):
    """K9 for ``rows`` rows of ``n`` draws at ``alpha``: ``(seconds,
    bound_by)``; the draws written as float32, each row's key pair and its
    four float32 constants read."""
    ops, _ = ops_per_draw(alpha)
    draws = rows * n
    return bound_s(ops, draws, 4 * draws + rows * (8 + 16))


def k9_chunk(nobs, nchan, nsamp, nfold, block=4096):
    """One ``iter_chunks`` chunk's two exact fields (pulse, noise), one K9
    launch each over (observation, channel, 4096-sample block) rows:
    ``(seconds of one launch, bound_by)``."""
    rows = nobs * nchan * -(-nsamp // block)
    return k9_gamma_field(rows, block, float(nfold) / 2.0)
