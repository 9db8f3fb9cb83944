#!/usr/bin/env python3
"""Run one cell of the psrsigsim_torch benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Builds the program's kernels into the
checkout's ``build/`` (or loads them from there), stages and warms the
cell's shapes, measures for ``--seconds`` seconds, checks what the window
produced against the plain reference under ``benchmark/reference/``, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the ``checks``,
each compared number beside its limit (also the last lines on standard
error).  Exits non-zero without a result when there is no CUDA card, when
the program is missing, or when JAX or the JAX package was loaded.
"""

import os
import sys
import time

_T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], _T0))
