"""Operation and byte counts of the program's kernels, and the least time
one NVIDIA H100 SXM could take for them.

A kernel's bound is the larger of its operations over the issue rate of
their class and its bytes over the HBM bandwidth.  The counts follow from
the output's shape and the stream the output must reproduce, never from a
launch layout, so they read the same work whatever implements it.

Peaks (NVIDIA's data sheet, SXM part at its 700 W limit): 3.35 TB/s of
HBM3, 132 SMs at 1.98 GHz.  Issue rates per SM per clock on compute
capability 9.0 (CUDA C++ programming guide, arithmetic instruction
throughput): float32 add and multiply 128; 32-bit integer multiply, add,
logic, shift, compare, min and max 64; special functions and conversions
16.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
RATES = {"int32": 64 * SMS * CLOCK_HZ, "fp32": 128 * SMS * CLOCK_HZ,
         "sfu": 16 * SMS * CLOCK_HZ}

# Operations per output sample by class that the stream itself needs.  One
# Philox4x32-10 call makes four samples: 10 rounds of 2 low and 2 high
# 32x32 multiplies and 2 three-input XORs, plus 9 key bumps of 2 adds (78
# integer), and 4 mask ANDs; two Box-Muller pairs of 7 float32 add/mul
# each, and per sample the Wilson-Hilferty map (6); per pair log, sqrt,
# sin, cos and 2 int->float conversions (6 special).  The accurate libm
# routines expand into more float work than one special op each, so the
# bound is a lower one.
PHILOX_INT_OPS = 78 + 4
DRAW_OPS = {"int32": PHILOX_INT_OPS / 4, "fp32": (2 * 7) / 4 + 6,
            "sfu": (2 * 6) / 4}
# fold -> quantize -> pack: two draws per sample, the fold (2 multiplies,
# 1 add), min, max and isfinite (3 compares), the quantizer (subtract and
# multiply; clamp 2 compares; rint and float->int conversions)
FUSED_OPS = {"int32": 2 * DRAW_OPS["int32"] + 3 + 2,
             "fp32": 2 * DRAW_OPS["fp32"] + 3 + 2,
             "sfu": 2 * DRAW_OPS["sfu"] + 2}


def bound_s(ops, n, nbytes):
    """``(seconds, bound_by)``: the least time for ``n`` samples of
    ``ops`` operations per sample by class moving ``nbytes``."""
    t_ops = max(ops[c] * n / RATES[c] for c in ops)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k3_fold_quantize(nobs, nchan, nsub, nph):
    """K3' (fold, quantize and pack) for ``nobs`` observations: the codes
    and their DAT_SCL/DAT_OFFS written, the shifted portraits read, the
    per-(subint, channel) finite flags, and each observation's two seed
    pairs, two dfs and noise scale."""
    n = nobs * nchan * nsub * nph
    nbytes = (4 * nobs * nchan * nph
              + 2 * nobs * nsub * nchan * (nph + 4)
              + nobs * nsub * nchan
              + nobs * (2 * 8 + 2 * 4 + 4))
    return bound_s(FUSED_OPS, n, nbytes)


def k1_field(rows, nchan, length):
    """K1' (the field sampler) for ``rows`` fields of ``nchan x length``
    float32 samples: the samples written, each row's seed pair, df and
    position read."""
    n = rows * nchan * length
    return bound_s(DRAW_OPS, n, 4 * n + rows * 20)
