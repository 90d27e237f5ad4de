"""Deadline-driven coalescer: turn a trickle of individual requests into
device-sized batches without blowing per-request latency — the port's copy
of `coconut_tpu/serve/batcher.py`.

Flush policy (the dynamic-batching rule every inference server converges
on):

  - FULL FLUSH: the moment `max_batch` requests are queued, pop a full
    batch — the device-optimal shape, zero extra waiting.
  - DEADLINE FLUSH: otherwise, flush a PARTIAL batch the moment the
    EARLIEST queued deadline (submit time + that request's `max_wait_ms`)
    expires — a request never waits longer than its own latency budget
    for company, whatever lane or arrival order it had.
  - CLOSE FLUSH: a closed queue flushes whatever remains immediately, so
    drain never strands a request behind a deadline.

Partial batches are PADDED back to `max_batch` with identity-signature
lanes (`sigma_1 = None`), the reference's convention: every dispatched
program keeps the one batch shape (which the reference's jit cache needs;
the port has no jit, so a padded lone request pays for a full batch).
Identity lanes verify False by construction (every backend's
`batch_verify` rejects identity sigma_1) and the demux never reads them.

Demux is the inverse of coalescing: the [B] verdict bits come back and
each request's future resolves with ITS lane's bit — one forged credential
fails its own future, not its cohabitants'.

Waiting runs on the queue's condition variable with the wait bounded by
the time to the oldest deadline (and a small poll cap so an injected fake
clock can't strand the waiter); the clock is injectable end-to-end, so the
deadline tests advance time explicitly and never sleep.
"""

import time

from .. import metrics
from ..obs import trace as otrace
from .queue import LANES  # noqa: F401  (re-export for callers)

#: cap on any single condition wait: keeps the batcher responsive to fake
#: clocks and to close() even if a notify is missed
_POLL_CAP_S = 0.05


class _PadCredential:
    """Identity-signature filler for the padded lanes of a partial batch:
    `sigma_1 is None` makes every backend verify the lane False and the
    encode path treat it as the point at infinity."""

    __slots__ = ()
    sigma_1 = None
    sigma_2 = None


PAD_CREDENTIAL = _PadCredential()


class Batcher:
    """Pops deadline-coalesced batches off a serve.queue.RequestQueue.

    `next_batch(block=True)` returns a non-empty list of Requests, or None:
    with block=True, None means the queue is closed AND empty (the
    supervisor's exit signal); with block=False, None just means nothing
    is ready to flush yet (the supervisor uses this to settle in-flight
    work instead of idling)."""

    def __init__(self, queue, max_batch, clock=time.monotonic, metric_ns=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1 (got %r)" % (max_batch,))
        self.queue = queue
        self.max_batch = max_batch
        self.clock = clock
        # counter namespace: follow the queue's unless overridden
        self.metric_ns = (
            metric_ns
            if metric_ns is not None
            else getattr(queue, "metric_ns", "serve")
        )

    def _ready_locked(self):
        """(flush_now, wait_s): whether a batch should flush immediately,
        else how long to wait before re-checking."""
        q = self.queue
        n = q._depth_locked()
        if n >= self.max_batch:
            return True, 0.0
        if n > 0:
            if q.closed:
                return True, 0.0
            deadline = q._earliest_deadline_locked()
            left = deadline - self.clock()
            if left <= 0:
                return True, 0.0
            return False, min(left, _POLL_CAP_S)
        return False, _POLL_CAP_S

    def next_batch(self, block=True, ready=None):
        """ready: optional zero-arg predicate consulted before any flush —
        the dispatcher pool's backpressure seam. While it returns False
        the batcher HOLDS the backlog in the queue (where admission
        control can see and bound it) instead of popping work no device
        executor can accept yet; whoever frees capacity must kick() the
        queue so the wait here re-checks. A CLOSED queue bypasses the
        gate: at drain the backlog must flush (the placer's forced-spill
        placement still settles it) rather than park forever behind a
        pool that lost its capacity."""
        q = self.queue
        with q.cond:
            while True:
                if ready is not None and not q.closed and not ready():
                    wait_s = _POLL_CAP_S
                else:
                    flush, wait_s = self._ready_locked()
                    if flush:
                        batch = q._pop_locked(self.max_batch)
                        metrics.count("%s_batches" % self.metric_ns)
                        metrics.count(
                            "%s_batched_requests" % self.metric_ns, len(batch)
                        )
                        for req in batch:
                            # queue_wait ends the moment the request is IN
                            # a coalesced batch — its dur is the admission->
                            # flush latency the per-stage breakdown reports
                            req.queue_span.end(coalesced_with=len(batch))
                        return batch
                if q.closed and q._depth_locked() == 0:
                    return None
                if not block:
                    return None
                q.cond.wait(wait_s)


def pad_batch(requests, max_batch):
    """(sigs, messages_list, n_pad) for a coalesced batch, identity-padded
    up to `max_batch` so the dispatched program shape is constant.

    Pad lanes reuse the first request's message vector (right length for
    the verkey; the identity sigma alone forces the lane False). Counted
    under "serve_pad_lanes"."""
    sigs = [r.sig for r in requests]
    messages_list = [r.messages for r in requests]
    n_pad = max(0, max_batch - len(requests))
    if n_pad:
        sigs.extend([PAD_CREDENTIAL] * n_pad)
        messages_list.extend([list(requests[0].messages)] * n_pad)
        metrics.count("serve_pad_lanes", n_pad)
        # annotate the active (coalesce) span so a padded flush is
        # visible per-batch in the trace, not only in aggregate
        otrace.event("pad_lanes", n=n_pad)
    return sigs, messages_list, n_pad


def demux(requests, bits, clock=time.monotonic):
    """Resolve each request's future with its own lane's verdict bit
    (padding lanes beyond len(requests) are ignored), recording the
    per-request latency histogram and verdict counters. Each request's
    root span ends here, stamped with its verdict — the trace covers
    admission through verdict delivery."""
    with otrace.span("demux", n=len(requests)):
        now = clock()
        n_valid = 0
        for req, bit in zip(requests, bits):
            ok = bool(bit)
            n_valid += ok
            metrics.observe("serve_latency_s", now - req.t_submit)
            req.span.end(verdict=ok)
            req.future.set_result(ok)
        metrics.count("serve_valid", n_valid)
        metrics.count("serve_invalid", len(requests) - n_valid)


def fail_all(requests, exc, counter="serve_failed_requests"):
    """Resolve every request's future with `exc` (the batch-level failure
    and shutdown paths) — a future must never be left dangling. Request
    spans (root + a possibly still-open queue_wait) end with the error
    class, so abandoned requests are visible in the trace, not dropped."""
    for req in requests:
        req.queue_span.end()
        req.span.end(error=type(exc).__name__)
        req.future.set_exception(exc)
    if requests:
        metrics.count(counter, len(requests))
