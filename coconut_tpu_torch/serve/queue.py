"""Thread-safe request queue: per-request futures, priority lanes, and
bounded-depth admission control — the port's copy of
`coconut_tpu/serve/queue.py`.

The online path's front door. Client threads `submit()` individual
show/verify requests; the batcher (serve/batcher.py) pops them in
device-sized groups. Three properties the offline stream never needed:

  - PER-REQUEST FUTURES: every request carries a `ServeFuture` the client
    blocks on; the supervisor resolves it with the request's own verdict
    (or an exception) after demux. A future always resolves — drain,
    shutdown, and worker-crash paths all sweep stragglers.

  - PRIORITY LANES: "interactive" requests (a user at a turnstile) pop
    before "bulk" ones (a ledger backfill) within every coalesced batch,
    so bulk traffic can saturate the device without starving the latency-
    sensitive lane. FIFO within a lane, so each lane's head is its oldest
    request and the earliest deadline is min over the two heads.

  - BOUNDED-DEPTH ADMISSION CONTROL: `submit()` raises
    `ServiceOverloadedError` (errors.py) the moment the queue holds
    `max_depth` requests. Rejecting loudly at the front door is the only
    stable overload behavior — an unbounded queue converts overload into
    unbounded latency for EVERY request and an eventual OOM, while a
    typed error lets the client back off, shed load, or route elsewhere.
    Counters: "serve_admitted" / "serve_rejected".

Time comes from an injectable `clock` (default time.monotonic) so deadline
logic is testable with a fake clock and zero real sleeps; `kick()` wakes
the batcher to re-read the clock after a test advances it.

TRACING (obs/, COCONUT_TRACE=1): admission is where a
request's trace is BORN — `submit()` starts the per-request root span
("request") plus its "queue_wait" child, and stamps the trace_id onto the
returned ServeFuture so a client can join its verdict (or a dead-letter
line) back to the trace. Rejected submissions allocate nothing: no
admission, no trace. With tracing disabled every hook is the shared no-op
span — zero allocations on the admission path.
"""

import threading
import time
from collections import deque

from .. import metrics
from ..errors import ServiceClosedError, ServiceOverloadedError
from ..obs import trace as otrace

#: priority lanes, pop order: interactive requests coalesce ahead of bulk
LANES = ("interactive", "bulk")

#: default per-request coalescing deadline (ms) when the submitter gives none
DEFAULT_MAX_WAIT_MS = 20.0


class ServeFuture:
    """Single-assignment result slot a client thread blocks on.

    Resolves exactly once, with either a verdict (`set_result`) or an
    exception (`set_exception`); later resolutions are ignored so the
    supervisor's crash-sweep can never clobber a real verdict. `result()`
    returns the verdict or re-raises the stored exception.

    `add_done_callback` registers a fire-once completion hook (called
    with the future, on the resolving thread — or immediately on the
    caller's thread if already resolved): the seam a network front end
    uses to answer the moment the engine settles, without parking a
    thread per in-flight request.
    Callback exceptions are contained (counted under
    "future_callback_errors") so a broken hook can never poison the
    settling executor thread."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc = None
        self._cb_lock = threading.Lock()
        self._callbacks = []
        #: trace id of the request this future resolves (None with
        #: tracing disabled) — the join key against trace exports,
        #: flight records, and dead-letter lines
        self.trace_id = None

    def done(self):
        return self._done.is_set()

    def _settle(self, result, exc):
        with self._cb_lock:
            if self._done.is_set():
                return
            self._result = result
            self._exc = exc
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            self._run_callback(cb)

    def _run_callback(self, cb):
        try:
            cb(self)
        except Exception:
            metrics.count("future_callback_errors")

    def set_result(self, value):
        self._settle(value, None)

    def set_exception(self, exc):
        self._settle(None, exc)

    def add_done_callback(self, fn):
        """Call `fn(self)` exactly once when the future resolves —
        immediately (on this thread) if it already has."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def exception(self, timeout=None):
        """The stored exception (None if the future resolved with a
        verdict); raises TimeoutError if unresolved within `timeout`."""
        if not self._done.wait(timeout):
            raise TimeoutError("request future unresolved")
        return self._exc

    def result(self, timeout=None):
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._result


class Request:
    """One queued credential-verify request: the credential, its message
    vector, the lane, the coalescing deadline, and the client's future."""

    __slots__ = (
        "sig",
        "messages",
        "lane",
        "max_wait_ms",
        "t_submit",
        "future",
        "span",
        "queue_span",
        "redispatches",
        "program",
        "settled",
    )

    def __init__(self, sig, messages, lane, max_wait_ms, t_submit):
        if lane not in LANES:
            raise ValueError("unknown lane %r (want one of %s)" % (lane, LANES))
        self.sig = sig
        self.messages = messages
        self.lane = lane
        self.max_wait_ms = max_wait_ms
        self.t_submit = t_submit
        self.future = ServeFuture()
        # which engine program this request belongs to (stamped by the
        # owning queue at admission; None for a bare Request, which the
        # engine resolves to its primary program)
        self.program = None
        # times this request was re-placed after its executor crashed or
        # hung (serve/service.py redistribution); capped by the service's
        # max_redispatch so a poisonous batch can't serially kill the pool
        self.redispatches = 0
        # set once by the engine's first settle of this request's batch
        # (engine/core.py `_claim`): a redistributed batch can settle twice
        self.settled = False
        # root span + queue-wait child start at ADMISSION (submit sets
        # them after the request clears admission control); both are the
        # shared no-op span while tracing is disabled
        self.span = otrace.NOOP
        self.queue_span = otrace.NOOP

    @property
    def deadline(self):
        """Absolute clock time by which this request wants to be IN a
        flushed batch (submit time + its max_wait_ms budget)."""
        return self.t_submit + self.max_wait_ms / 1000.0


class RequestQueue:
    """Bounded two-lane FIFO with a condition variable shared by submitters
    and the batcher. All waiting/flush policy lives in serve/batcher.py;
    this class owns admission, ordering, and close semantics."""

    def __init__(
        self,
        max_depth=1024,
        clock=time.monotonic,
        metric_ns="serve",
        program=None,
    ):
        """metric_ns: the counter namespace admissions report under
        ("serve" for the verify service). The queue itself is
        payload-agnostic: `sig` is whatever the owning service coalesces.
        program: the engine program name stamped onto every admitted
        request (and carried by overload rejections) so heterogeneous
        lanes sharing one executor pool stay attributable."""
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1 (got %r)" % (max_depth,))
        self.max_depth = max_depth
        self.clock = clock
        self.metric_ns = metric_ns
        self.program = program
        self.cond = threading.Condition()
        self.closed = False
        self._lanes = {lane: deque() for lane in LANES}

    # -- submit side --------------------------------------------------------

    def submit(self, sig, messages, lane="interactive", max_wait_ms=None):
        """Admit one request and return its ServeFuture. Raises
        ServiceClosedError after close(), ServiceOverloadedError at the
        admission bound (counted under "serve_rejected")."""
        if max_wait_ms is None:
            max_wait_ms = DEFAULT_MAX_WAIT_MS
        req = Request(sig, messages, lane, max_wait_ms, self.clock())
        req.program = self.program
        with self.cond:
            if self.closed:
                raise ServiceClosedError(
                    "service is draining/shut down: submission refused"
                )
            depth = self._depth_locked()
            if depth >= self.max_depth:
                metrics.count("%s_rejected" % self.metric_ns)
                raise ServiceOverloadedError(
                    depth,
                    self.max_depth,
                    program=self.program,
                    retry_after_s=max_wait_ms / 1000.0,
                )
            req.span = otrace.start_span(
                "request", root=True, lane=lane, max_wait_ms=max_wait_ms
            )
            req.queue_span = otrace.start_span("queue_wait", parent=req.span)
            req.future.trace_id = req.span.trace_id
            self._lanes[lane].append(req)
            metrics.count("%s_admitted" % self.metric_ns)
            self.cond.notify_all()
        return req.future

    def close(self):
        """Stop admitting; wake the batcher so it flushes the remainder."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def kick(self):
        """Wake any batcher wait so it re-reads the clock — used after a
        test's fake clock advances past a deadline."""
        with self.cond:
            self.cond.notify_all()

    # -- batcher side (call with self.cond held) -----------------------------

    def _depth_locked(self):
        return sum(len(d) for d in self._lanes.values())

    def _earliest_deadline_locked(self):
        """Earliest deadline over EVERYTHING queued — not just the lane
        heads: a later arrival with a tighter max_wait_ms budget can owe a
        flush before the (older) head does. O(depth), and depth is bounded
        by admission control. None when empty."""
        earliest = None
        for d in self._lanes.values():
            for req in d:
                if earliest is None or req.deadline < earliest:
                    earliest = req.deadline
        return earliest

    def _pop_locked(self, n):
        """Pop up to n requests, interactive lane first."""
        out = []
        for lane in LANES:
            d = self._lanes[lane]
            while d and len(out) < n:
                out.append(d.popleft())
        return out

    def depth(self):
        with self.cond:
            return self._depth_locked()

    def depths(self):
        """{lane: queued count} — the per-lane backlog readout behind the
        "serve_queue_depth" gauge and the placement policy's view of how
        latency-sensitive the current backlog is."""
        with self.cond:
            return {lane: len(d) for lane, d in self._lanes.items()}

    def drain_pending(self):
        """Pop EVERYTHING queued (the non-draining shutdown path: the
        caller fails these futures with ServiceClosedError)."""
        with self.cond:
            out = self._pop_locked(self._depth_locked())
            self.cond.notify_all()
            return out
