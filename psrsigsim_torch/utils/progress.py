"""Host-side progress reporting for long ensemble runs.

The reference's only user-facing progress signal is a ``\\r``-rewritten
percent line inside the per-channel shift loops (reference:
ism/ism.py:50-74).  Here device pipelines are single fused programs, so
progress lives at the chunk loop driving them
(:meth:`~psrsigsim_torch.parallel.FoldEnsemble.iter_chunks`): any callable
``progress(done, total)`` works; :class:`ConsoleProgress` reproduces the
reference-style percent/elapsed line.
"""

from __future__ import annotations

import sys
import time

__all__ = ["ConsoleProgress"]


class ConsoleProgress:
    """Render ``progress(done, total)`` as a rewritten console line:

    ``98% complete, elapsed time: 12.3 s`` (mirroring ism/ism.py:62-74),
    with a newline once done == total.
    """

    def __init__(self, label="simulating", stream=None, min_interval_s=0.0):
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval_s = min_interval_s
        self._t0 = None
        self._last = 0.0

    def __call__(self, done, total):
        now = time.time()
        if self._t0 is None:
            self._t0 = now
        if done < total and (now - self._last) < self.min_interval_s:
            return
        self._last = now
        pct = 100.0 * done / total if total else 100.0
        self.stream.write(
            f"\r{self.label}: {pct:3.0f}% complete, elapsed time: "
            f"{now - self._t0:.1f} s"
        )
        if done >= total:
            self.stream.write("\n")
            # reset so the same instance can drive another run
            self._t0 = None
            self._last = 0.0
        self.stream.flush()
