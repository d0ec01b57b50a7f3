"""Bounded-backoff retry with deadlines (a copy of
``factormodeling_tpu/resil/retry.py``, which imports nothing of JAX).

``retry_call`` runs a callable under a deterministic, jitterless backoff
ladder (:func:`backoff_schedule`), propagates the last real failure, lets
``no_retry`` exceptions through at once, stops retrying once the next
backoff would cross a deadline, and takes a pluggable clock and sleep so a
caller on a virtual timeline stays reproducible. Host IO of the snapshot
layer (:mod:`.checkpoint`) runs under it.
"""

from __future__ import annotations

import math
import time

__all__ = ["DeadlineExceeded", "backoff_schedule", "retry_call"]


class DeadlineExceeded(RuntimeError):
    """The deadline passed before the first attempt could even start —
    there is no underlying failure to propagate, so this names the budget
    itself as the reason."""


def backoff_schedule(retries: int, *, base: float = 0.05,
                     factor: float = 2.0,
                     max_delay_s: float = math.inf) -> tuple:
    """The deterministic delay ladder: ``min(base * factor**i, max_delay_s)``
    for each retry ``i`` — a pure function of its arguments (no jitter;
    module docs explain why)."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if base < 0 or factor <= 0:
        raise ValueError(f"backoff base must be >= 0 and factor > 0, got "
                         f"base={base}, factor={factor}")
    return tuple(min(base * factor ** i, max_delay_s)
                 for i in range(retries))


def retry_call(fn, *, retries: int = 3, backoff: float = 0.05,
               factor: float = 2.0, max_delay_s: float = math.inf,
               exceptions=(OSError,), no_retry=(), deadline_s=None,
               clock=None, sleep=None, on_retry=None):
    """Run ``fn()`` with up to ``retries`` retries on ``exceptions``,
    sleeping the :func:`backoff_schedule` between attempts.

    The LAST failure propagates — retry hides transient faults, not real
    ones — and ``no_retry`` exceptions propagate IMMEDIATELY (a
    deterministic condition like a missing snapshot is not a fault to
    wait out). With ``deadline_s`` (absolute seconds on ``clock``'s
    timeline): a deadline already passed before the first attempt raises
    :class:`DeadlineExceeded`; after a failure, if the next backoff would
    reach the deadline, the failure propagates without the pointless
    sleep. ``clock`` is a zero-arg "now in seconds" callable (default
    ``time.monotonic``), ``sleep`` takes seconds (default ``time.sleep``)
    — the serving queue passes its virtual clock for both. ``on_retry``
    (optional) is called as ``on_retry(attempt_index, exc, delay_s)``
    before each sleep, which is how the queue counts retries into its
    telemetry."""
    schedule = backoff_schedule(retries, base=backoff, factor=factor,
                                max_delay_s=max_delay_s)
    now = clock if clock is not None else time.monotonic
    do_sleep = sleep if sleep is not None else time.sleep
    if deadline_s is not None and now() >= deadline_s:
        raise DeadlineExceeded(
            f"deadline {deadline_s:.6g}s already passed at "
            f"{now():.6g}s before the first attempt")
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if isinstance(e, no_retry) or attempt == retries:
                raise
            delay = schedule[attempt]
            if deadline_s is not None and now() + delay >= deadline_s:
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            do_sleep(delay)
