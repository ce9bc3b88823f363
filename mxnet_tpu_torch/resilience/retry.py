"""Jittered-exponential-backoff retry with a deadline (port of
``mxnet_tpu/resilience/retry.py``, subset: ``backoff_delays`` and
``retry_call``).

Everything time-related is injectable (``sleep``, ``clock``, ``rng``),
so tests run deterministic backoff schedules with no real sleeping.  The
serve batcher draws its dispatcher-restart delays from
:func:`backoff_delays`.
"""

from __future__ import annotations

import logging
import random
import time

__all__ = ["backoff_delays", "retry_call"]

log = logging.getLogger(__name__)


def backoff_delays(attempts, base_delay, max_delay, multiplier, jitter,
                   rng):
    """The delay after attempt i (1-based): capped exponential with
    multiplicative jitter in ``[1 - jitter, 1]``."""
    for i in range(1, attempts):
        delay = min(max_delay, base_delay * multiplier ** (i - 1))
        if jitter:
            delay *= 1.0 - jitter * rng.random()
        yield delay


def retry_call(fn, args=(), kwargs=None, *, attempts=5, base_delay=0.05,
               max_delay=2.0, multiplier=2.0, jitter=0.5, deadline=None,
               retry_on=(OSError,), give_up_on=(), sleep=time.sleep,
               clock=time.monotonic, rng=None, logger=None, on_retry=None):
    """Call ``fn(*args, **kwargs)``, retrying on *retry_on* exceptions.

    *give_up_on* exceptions propagate immediately even when they
    subclass a *retry_on* type.  *deadline* bounds the total time: a
    retry whose backoff would overrun it re-raises instead of sleeping.
    The last exception always propagates unwrapped.
    """
    kwargs = kwargs or {}
    rng = rng if rng is not None else random.Random()
    delays = backoff_delays(attempts, base_delay, max_delay, multiplier,
                            jitter, rng)
    lg = logger or log
    start = clock()
    attempt = 1
    while True:
        try:
            return fn(*args, **kwargs)
        except give_up_on:
            raise
        except retry_on as exc:
            if attempt >= attempts:
                raise
            delay = next(delays)
            if deadline is not None and \
                    (clock() - start) + delay > deadline:
                lg.debug("retry: deadline %.3fs would be exceeded; "
                         "giving up after attempt %d (%s)", deadline,
                         attempt, exc)
                raise
            lg.debug("retry: attempt %d/%d failed (%s: %s); backing off "
                     "%.3fs", attempt, attempts, type(exc).__name__, exc,
                     delay)
            from ..observability import events as _obs_events
            from ..observability import metrics as _metrics
            _metrics.counter(
                "retry_attempts_total",
                "retried (failed-then-backed-off) attempts across "
                "every retry_call site").inc()
            _obs_events.emit("retry", fn=getattr(fn, "__name__",
                                                 repr(fn)[:80]),
                             attempt=attempt, of=attempts,
                             error="%s: %s" % (type(exc).__name__,
                                               str(exc)[:200]),
                             backoff_s=round(delay, 4))
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
            attempt += 1
