"""Capped exponential backoff for self-healing host-side loops.

The run supervisor and the export writer pool share one retry idiom:
attempt, back off exponentially up to a cap, give up after a bounded
number of attempts and let the caller degrade (pool -> serial writer,
retry -> quarantine record).  Centralizing it here keeps the policy
testable in isolation and the call sites honest about their bounds —
an unbounded `while True: respawn()` is exactly the failure amplifier
a multi-hour 10k-observation export cannot afford.

Host-only module: nothing here touches torch.  A copy of
psrsigsim_tpu/runtime/retry.py, which the port cannot import.
"""

from __future__ import annotations

import time

__all__ = ["RetryPolicy", "call_with_retry", "RetriesExhausted"]


class RetriesExhausted(RuntimeError):
    """All attempts of :func:`call_with_retry` failed.

    The last underlying exception is chained as ``__cause__`` and kept
    on :attr:`last_error`; :attr:`attempts` records how many were made.
    """

    def __init__(self, attempts, last_error):
        self.attempts = int(attempts)
        self.last_error = last_error
        super().__init__(
            f"gave up after {attempts} attempt(s); last error: "
            f"{last_error!r}")


class RetryPolicy:
    """Capped exponential backoff schedule, optionally jittered.

    ``delay(k)`` is the sleep before retry ``k`` (0-based):
    ``min(max_delay, base_delay * multiplier**k)``.  ``max_attempts``
    bounds the total number of attempts (first try included); the
    policy object is immutable and shareable across call sites.

    ``permanent_on`` (a tuple of exception types, default empty)
    classifies errors: an exception matching it is PERMANENT — retrying
    cannot help — and :func:`call_with_retry` re-raises it immediately
    instead of burning the backoff budget on it.  The canonical case is
    :class:`~psrsigsim_torch.runtime.integrity.IntegrityError`: a
    corruption that survived its one verified re-execution already has
    two independent executions disagreeing, so a retry loop treating it
    like a flaky writer would just re-prove the disagreement slowly
    while the audit evidence went stale.  Transient-vs-permanent is the
    policy's call, not the loop's: every call site sharing a policy
    shares one classification.

    ``jitter`` (0..1, default 0 = exactly the deterministic schedule)
    spreads each delay uniformly over the bounded band
    ``[d*(1-jitter), min(max_delay, d*(1+jitter))]`` around the
    deterministic value ``d``.  A fleet of replicas/writers respawning
    after a shared outage otherwise backs off in lockstep and
    thundering-herds whatever shared resource (the cache lock, the
    device) killed them in the first place; successive draws from each
    process's own ``rng`` stream decorrelate the herd while the band
    keeps every delay within a tested bound of the schedule.  ``rng`` is
    an injectable zero-argument callable returning floats in ``[0, 1)``
    (e.g. ``random.Random(seed).random``) so tests replay schedules
    exactly; jitter without an rng falls back to a private
    ``random.Random`` seeded from ``os.urandom``.
    """

    def __init__(self, max_attempts=3, base_delay=0.5, max_delay=30.0,
                 multiplier=2.0, jitter=0.0, rng=None, permanent_on=()):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if base_delay < 0 or max_delay < 0:
            raise ValueError("delays must be >= 0")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.permanent_on = tuple(permanent_on)
        if rng is None and self.jitter > 0.0:
            import random

            rng = random.Random().random
        self._rng = rng

    def delay(self, retry_index):
        """Backoff before the ``retry_index``-th retry (0-based)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** retry_index)
        if self.jitter == 0.0 or self._rng is None:
            return d
        lo = d * (1.0 - self.jitter)
        hi = min(self.max_delay, d * (1.0 + self.jitter))
        return lo + self._rng() * (hi - lo)

    def is_permanent(self, err):
        """Error classification: True means retrying cannot help and the
        caller must fail fast (with whatever evidence the error
        carries) instead of spending the backoff budget."""
        return isinstance(err, self.permanent_on)

    def delays(self):
        """The full schedule: one delay per retry (``max_attempts - 1``)."""
        return [self.delay(k) for k in range(self.max_attempts - 1)]

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_delay={self.base_delay}, max_delay={self.max_delay}, "
                f"multiplier={self.multiplier}, jitter={self.jitter})")


def call_with_retry(fn, policy=None, retry_on=(Exception,), on_retry=None,
                    sleep=time.sleep):
    """Call ``fn()`` under ``policy``, retrying on ``retry_on``.

    ``on_retry(attempt_index, error, delay)`` is invoked before each
    backoff sleep — call sites log/count there.  Raises
    :class:`RetriesExhausted` (with the last error chained) once the
    attempt budget is spent.  ``sleep`` is injectable so tests run the
    schedule without wall-clock cost.

    Errors the policy classifies PERMANENT (``policy.is_permanent``)
    are re-raised immediately — no backoff, no further attempts: the
    evidence they carry (an integrity mismatch's audit trail) reaches
    the operator fresh instead of after a spent retry budget.
    """
    policy = policy or RetryPolicy()
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as err:  # noqa: PERF203 — retry loop by design
            if policy.is_permanent(err):
                raise
            last = err
            if attempt == policy.max_attempts - 1:
                break
            d = policy.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, err, d)
            if d > 0:
                sleep(d)
    raise RetriesExhausted(policy.max_attempts, last) from last
