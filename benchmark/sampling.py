"""A uniform sample of the answers a window produced, drawn from the
run's seed.  Each answer is a candidate with the chance ``1 / every``
(thinning), and the candidates go through a reservoir by skips (Li's
Algorithm L); both are drawn as jumps, so the window draws a few random
numbers for each answer kept, about ``k * (1 + ln(c / k))`` of ``c``
candidates, and none for the others.  Thinning spreads the copies of the
kept answers over the window: without it the reservoir copies ``k``
answers and replaces most of them again in the window's first batches."""

from __future__ import annotations

import math


class Reservoir:
    """Keeps at most ``k`` items; ``offer(make, n)`` offers a batch of
    ``n`` answers, ``make(i, slot)`` copying answer ``i`` only when it is
    kept, into the item ``slot`` (0 to ``k - 1``) whose answer it drops."""

    def __init__(self, k, rng, every=1):
        self.k = int(k)
        self.rng = rng
        self.share = 1.0 / float(every)
        self.items = []
        self.seen = 0
        self._w = 1.0
        self._no = -1       # the number of the candidate at answer _at
        self._at = -1
        self._keep = 0      # the number of the next candidate kept

    def _u(self):
        return 1.0 - float(self.rng.random())     # in (0, 1]

    def _skip(self, last):
        """Draw the number after candidate ``last`` of the next one kept."""
        self._w *= math.exp(math.log(self._u()) / self.k)
        gap = (math.floor(math.log(self._u()) / math.log1p(-self._w))
               if self._w < 1.0 else 0)
        self._keep = last + 1 + gap

    def _advance(self, m):
        """Move to the ``m``-th candidate after the current one: ``m``
        answers and the non-candidates before them (negative binomial)."""
        fails = (int(self.rng.negative_binomial(m, self.share))
                 if self.share < 1.0 else 0)
        self._at += m + fails
        self._no += m

    def offer(self, make, n):
        base = self.seen
        self.seen += n
        while True:
            if self._no < self._keep:
                self._advance(self._keep - self._no)
            if self._at >= self.seen:
                return
            i = self._at - base
            if len(self.items) < self.k:
                self.items.append(make(i, len(self.items)))
                if len(self.items) < self.k:
                    self._keep = self._no + 1
                else:
                    self._skip(self._no)
            else:
                slot = int(self.rng.integers(self.k))
                self.items[slot] = make(i, slot)
                self._skip(self._no)
