"""Retry policy: bounded exponential backoff with deterministic jitter —
the port's copy of `coconut_tpu/retry.py`.

The supervision layer around `stream.verify_stream` and the serve engine
re-attempts a batch whose dispatch or readback raised a
`TransientBackendError`. Backoff is exponential and bounded; jitter is
DETERMINISTIC — derived from crc32((key, attempt)) rather than a PRNG — so
a checkpointed rerun replays the identical schedule (the fault-injection
suite depends on this) while distinct batches still desynchronize their
re-dispatches.

Counters (metrics.py): "retries" increments per re-attempt, "fallbacks"
per degradation to the fallback backend.

Tracing (obs/): when a span is active, the ladder narrates
itself onto it — "retry" (with the backoff chosen) per re-attempt,
"attempt_failed" (with the error class) per transient failure, and
"fallback" when the ladder degrades — so a single request's trace shows
its exact attempt history, not just the run-wide counters.
"""

import time
import zlib

from . import metrics
from .errors import TransientBackendError
from .obs import trace as otrace


class RetryPolicy:
    """How many times to re-attempt a transient failure, and how to wait.

    max_attempts: TOTAL attempts per unit of work (1 = no retry);
    base_delay / max_delay: seconds; re-attempt `a` (1-indexed) waits
      min(max_delay, base_delay * 2**(a-1)) scaled by the jitter factor;
    jitter: fraction in [0, 1] — the delay is scaled into
      [(1-jitter) * raw, raw] by a crc32-derived factor of (key, attempt);
    retryable: exception classes worth re-attempting (everything else is
      permanent and propagates);
    sleep: injectable for tests (defaults to time.sleep)."""

    def __init__(
        self,
        max_attempts=4,
        base_delay=0.05,
        max_delay=5.0,
        jitter=0.5,
        retryable=(TransientBackendError,),
        sleep=time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (got %r)" % max_attempts)
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1] (got %r)" % jitter)
        if base_delay < 0 or max_delay < 0:
            raise ValueError("delays must be >= 0")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.jitter = jitter
        self.retryable = tuple(retryable)
        self.sleep = sleep

    def backoff(self, attempt, key=0):
        """Delay in seconds before re-attempt `attempt` (1-indexed) of the
        work unit `key` (e.g. a batch index). Pure: same (key, attempt) ->
        same delay."""
        raw = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        h = zlib.crc32(("%s:%s" % (key, attempt)).encode()) / 0xFFFFFFFF
        return raw * (1.0 - self.jitter * h)


def note_attempt(attempts, exc):
    """Append one attempt-history record (the dead-letter `attempts`
    format) for a failed attempt."""
    attempts.append(
        {
            "attempt": len(attempts) + 1,
            "error": type(exc).__name__,
            "detail": str(exc),
        }
    )


def call_with_retry(fn, policy, key=0, attempts=None, fallback=None):
    """Run `fn()` under `policy`'s retry ladder.

    Re-attempts (with backoff sleep and a "retries" count) while `fn`
    raises a `policy.retryable` exception and attempts remain. `attempts`
    may arrive pre-populated (the stream's pipelined dispatch consumes the
    first attempt eagerly); records for further failures are appended in
    place. On exhaustion: runs `fallback()` if given (counted under
    "fallbacks"), else re-raises the last transient error."""
    attempts = [] if attempts is None else attempts
    last = None
    while len(attempts) < policy.max_attempts:
        if attempts:
            metrics.count("retries")
            delay = policy.backoff(len(attempts), key=key)
            otrace.event(
                "retry", attempt=len(attempts) + 1, backoff_s=round(delay, 6)
            )
            policy.sleep(delay)
        try:
            return fn()
        except policy.retryable as e:
            last = e
            note_attempt(attempts, e)
            otrace.event(
                "attempt_failed",
                attempt=len(attempts),
                error=type(e).__name__,
            )
    if fallback is not None:
        metrics.count("fallbacks")
        otrace.event("fallback", after_attempts=len(attempts))
        return fallback()
    if last is None:
        # every attempt was consumed by the caller before we ran
        raise TransientBackendError(
            "retries exhausted after %d attempt(s): %r"
            % (len(attempts), attempts)
        )
    raise last
