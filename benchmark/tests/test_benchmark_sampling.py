"""The window's sample: every answer offered is equally likely to be kept,
the same seed keeps the same answers, and only the kept answers are
copied (some tens over a window's hundreds of thousands), spread over the
window when the answers are thinned."""

import math
from collections import Counter

import numpy as np
import pytest

from benchmark.sampling import Reservoir


def _fill(seed, k, batches, n, every=1):
    r = Reservoir(k, np.random.default_rng(seed), every)
    made = []
    for b in range(batches):
        def make(i, slot, b=b):
            assert 0 <= slot < k
            made.append(b * n + i)
            return b * n + i
        r.offer(make, n)
    return r, made


@pytest.mark.parametrize("every", [1, 7])
def test_every_answer_is_equally_likely(every):
    k, batches, n, runs = 4, 10, 10, 4000
    counts = Counter()
    for seed in range(runs):
        r, _ = _fill(seed, k, batches, n, every)
        assert len(set(r.items)) == k
        counts.update(r.items)
    p = k / (batches * n)
    sd = math.sqrt(runs * p * (1 - p))
    got = np.array([counts[i] for i in range(batches * n)])
    assert np.abs(got - runs * p).max() < 5 * sd


def test_same_seed_same_sample():
    assert _fill(2**31 + 5, 16, 50, 128)[0].items == \
        _fill(2**31 + 5, 16, 50, 128)[0].items


@pytest.mark.parametrize("every", [1, 2048])
def test_only_kept_answers_are_copied(every):
    k, batches, n = 16, 3000, 128
    r, made = _fill(1, k, batches, n, every)
    assert len(r.items) == k and set(r.items) <= set(made)
    assert len(made) < 3 * k * (1 + math.log(batches * n / every / k))


def test_thinning_spreads_the_copies():
    """With one candidate in 2,048 answers no batch of 128 copies more
    than a few answers; without thinning the first copies them all."""
    per_batch = Counter(i // 128 for i in _fill(2, 16, 3000, 128, 2048)[1])
    assert max(per_batch.values()) <= 3
    assert Counter(i // 128 for i in _fill(2, 16, 3000, 128)[1])[0] >= 16


def test_fewer_answers_than_the_sample_keeps_them_all():
    r, made = _fill(3, 16, 1, 10)
    assert r.items == list(range(10)) == made
