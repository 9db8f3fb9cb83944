#!/usr/bin/env python3
"""The x86 ``rsqrtss`` estimate table behind XLA's float32 ``rsqrt``.

    python3 psrsigsim_torch/tools/rsqrt_table.py [--check]

XLA's CPU backend computes ``rsqrt(x)`` as the hardware estimate
``rsqrtss`` refined by two Newton steps, so its last bits depend on the
estimate.  On Intel CPUs the estimate is a function of the exponent's
parity and the top 10 mantissa bits: 2048 entries of 12 significant bits
(``ops/stats.py::_RSQRT_TABLE``, as 16-bit words ``yb >> 11`` of the
estimate's bits ``yb`` for inputs in [1, 4)).  This script compiles a probe
with the host C compiler into ``build/``, reads every entry from the
host's ``rsqrtss`` and prints the table as one hex string; ``--check``
also runs the estimate over every 97th positive normal float32, holds it
to the table's reconstruction (``ops/stats.py::_rsqrt_estimate``), and
compares the printed table with the committed one.  Needs an x86 host
with a C compiler; exits 1 on any mismatch.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_PROBE = r"""
#include <immintrin.h>
#include <stdint.h>
#include <string.h>
void rsqrt_estimate(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    y[i] = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x[i])));
}
"""


def _probe():
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "rsqrt_probe.c")
    so = os.path.join(build, "rsqrt_probe.so")
    with open(src, "w") as f:
        f.write(_PROBE)
    subprocess.run(["cc", "-O2", "-msse", "-shared", "-fPIC", "-o", so, src],
                   check=True)
    fn = ctypes.CDLL(so).rsqrt_estimate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]

    def run(x):
        x = np.ascontiguousarray(x, np.float32)
        y = np.empty_like(x)
        fn(x.ctypes.data, y.ctypes.data, x.size)
        return y
    return run


def main():
    run = _probe()
    j = np.arange(2048, dtype=np.uint32)
    yb = run((np.uint32(0x3F800000) + (j << 13)).view(np.float32)).view(
        np.uint32)
    if np.any(yb >> 27 != 7) or np.any(yb & 0x7FF):
        print("estimate outside the table's form", file=sys.stderr)
        return 1
    table = "".join(f"{w:04x}" for w in (yb >> 11) & 0xFFFF)
    print(table)
    if "--check" not in sys.argv[1:]:
        return 0
    sys.path.insert(0, ROOT)
    import torch

    from psrsigsim_torch.ops import stats

    bits = np.arange(0x00800000, 0x7F800000, 97, dtype=np.int64).astype(
        np.uint32)
    x = bits.view(np.float32)
    host = run(x)
    mine = stats._rsqrt_estimate(torch.from_numpy(x.copy())).numpy()
    bad = int(np.count_nonzero(host.view(np.uint32) != mine.view(np.uint32)))
    same = table == stats._RSQRT_TABLE
    print(f"{bits.size} inputs, {bad} differ; committed table "
          f"{'equal' if same else 'DIFFERS'}")
    return 0 if bad == 0 and same else 1


if __name__ == "__main__":
    sys.exit(main())
