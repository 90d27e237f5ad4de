"""Request-scoped tracing: spans, a thread-safe tracer, and contextvar
propagation — the Dapper-style complement to metrics.py's aggregates.

metrics.py answers "how many retries happened this run"; this module
answers "what happened to THAT request": every admitted serve request (and
every streamed batch) gets a trace — a tree of timed spans — so a
credential that survives a retry->fallback->bisection ladder before
dead-lettering leaves a joinable record of exactly that path.

Design constraints, in order:

  - ZERO-COST WHEN OFF (the default): every entry point first checks the
    module-level `_tracer is None` and returns the shared `NOOP` span —
    no Span is ever allocated, no lock taken, no clock read. The serve
    and bench hot paths run with tracing off unless `COCONUT_TRACE=1`.
  - BOUNDED MEMORY: finished spans land in a ring buffer
    (`COCONUT_TRACE_RING`, default 4096) — a million-request run retains
    the most recent few thousand spans, kilobytes not gigabytes. The
    flight recorder (obs/flight.py) exists precisely because the ring
    forgets: it dumps a request's tree at the moment of failure.
  - INJECTABLE CLOCK: `enable(clock=...)` takes any monotonic callable,
    so span durations are testable exactly with a fake clock and zero
    real sleeps (the same discipline serve/queue.py uses). Spans are
    stamped on that clock; the tracer also keeps `anchor`, one reading
    of it beside `time.time_ns()` taken when it is made, so the Chrome
    export (obs/export.py) can put a stamp on the Unix epoch, the clock
    of torch.profiler's events.
  - CROSS-THREAD TREES: propagation inside one thread rides a
    contextvar (`span()` activates, nested spans parent automatically);
    across threads — a request admitted on a client thread, batched on
    the supervisor — the span object itself is handed over and re-entered
    with `use()`. Spans are safe to start/annotate/end from any thread.

Span taxonomy:

  per-request trace:  request            admission -> verdict (root)
                        queue_wait       admission -> popped into a batch
  per-batch trace:    batch | stream_batch   (root; links member traces
                                              via the members attr, and
                                              each request span carries
                                              batch_trace back)
                        coalesce         pad/assemble the device batch
                        dispatch         host encode + device dispatch
                          lock_wait.dispatch
                                         waiting for gpu/serial.DEVICE_LOCK
                                         (only when another thread holds it)
                          encode         TorchBackend.encode_verify_batch:
                                         static operands, comb digits,
                                         signature encode and upload
                          enqueue        the fused_verify call: every
                                         operator launch of the program,
                                         or on `cuda` its graphs' input
                                         copies and replays
                            graph_capture
                                         a shape key's capture into
                                         CUDA graphs (its second call)
                            comb_msm     the verkey comb MSM
                            affine       the accumulator's normalization
                            miller_loop  the pairing's Miller loop
                            final_exp    final exponentiation + GT == 1
                        device           blocking wait on the device
                          lock_wait.device
                                         the readback waiting for the lock
                                         (eager batches only: a replayed
                                         batch's readback waits for its
                                         own event, without the lock)
                        demux            verdict bits -> futures
                        bisect           grouped-failure culprit isolation

  The backend's spans (`gpu/backend.py`) time the host's enqueue of a
  stage's operators, never the device's run of them: no span
  synchronizes or reads a device value. `affine`, `miller_loop` and
  `final_exp` come from verify_tail, so the show and sharded programs
  record them too (under their own parents); a replayed verify records
  each around the replay of its stage's graph. A wait for the device lock
  is named after the span it waits under, `lock_wait.<parent>` (plain
  `lock_wait` under none), so the prefetch worker's waits and the
  settle's sum apart; it carries the waiting thread's name (`thread`).

  events (timestamped points on a span): retry / attempt_failed /
  fallback (retry.py ladder), split (each bisection halving),
  dead_letter, pad_lanes, checkpoint.

  Against the serve dispatcher pool, "batch" and "dispatch"/"device"
  spans carry `device` (the executor label: "0".."N-1" or "mesh") and
  the batch root carries `placement` ("single" | "sharded") — so a
  dead-lettered request's span tree names the device that rejected it
  and which side of the adaptive routing policy its batch took.

`metrics.snapshot()` gains a "trace_stages" section while tracing is
enabled (per-span-name count/total/mean — the queue-wait vs coalesce vs
encode vs device vs demux breakdown), via metrics' provider hook so the
two modules stay decoupled.
"""

import contextvars
import itertools
import os
import threading
import time
from collections import deque

#: env knobs: COCONUT_TRACE=1 enables at import; COCONUT_TRACE_RING sizes
#: the finished-span ring buffer
ENV_FLAG = "COCONUT_TRACE"
ENV_RING = "COCONUT_TRACE_RING"
DEFAULT_RING = 4096

_FALSY = ("", "0", "false", "off", "no")


class _NoopSpan:
    """The shared do-nothing span every entry point returns while tracing
    is disabled. One module-level instance, no per-call allocation; every
    method is a no-op, it is falsy, and it nests as a context manager
    without touching the contextvar."""

    __slots__ = ()
    name = None
    trace_id = None
    span_id = None
    parent_id = None
    t0 = None
    t1 = None

    def __bool__(self):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def end(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP = _NoopSpan()


class Span:
    """One timed operation in a trace tree.

    Starts at construction (via Tracer.start), ends exactly once via
    `end()` (idempotent — a defensive second end is ignored, so sweep
    paths can close spans unconditionally). `set()` merges attributes,
    `event()` records a timestamped point annotation. Entering a Span as
    a context manager activates it on the current context (nested
    `span()` calls parent under it) and ends it on exit, recording an
    `error` attribute if the body raised."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "t0",
        "t1",
        "tid",
        "attrs",
        "events",
        "_tracer",
        "_token",
    )

    def __init__(self, tracer, name, trace_id, span_id, parent_id, t0):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = None
        self.tid = threading.get_ident()
        self.attrs = {}
        self.events = []
        self._tracer = tracer
        self._token = None

    @property
    def dur(self):
        """Span duration in seconds (None while still live)."""
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs):
        with self._tracer._lock:
            self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        """Record a timestamped point annotation (retry, split, ...)."""
        t = self._tracer
        with t._lock:
            self.events.append({"ts": t._clock(), "name": name, **attrs})
        return self

    def end(self, **attrs):
        """Finish the span: stamp t1, move it from the live set to the
        ring buffer, fold its duration into the per-stage totals.
        Idempotent — only the first end() sticks."""
        t = self._tracer
        with t._lock:
            if self.t1 is not None:
                return self
            if attrs:
                self.attrs.update(attrs)
            self.t1 = t._clock()
            t._live.pop(self.span_id, None)
            t._ring.append(self)
            agg = t._stages.get(self.name)
            if agg is None:
                agg = t._stages[self.name] = [0, 0.0]
            agg[0] += 1
            agg[1] += self.t1 - self.t0
        return self

    def to_dict(self):
        """JSON-ready record (the JSONL export / flight-recorder shape)."""
        with self._tracer._lock:
            return {
                "name": self.name,
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "t0": self.t0,
                "dur": self.dur,
                "tid": self.tid,
                "attrs": dict(self.attrs),
                "events": list(self.events),
            }

    # -- context-manager activation ------------------------------------------

    def __enter__(self):
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.end(error=exc_type.__name__)
        else:
            self.end()
        return False


class Tracer:
    """Thread-safe span factory + bounded ring buffer of finished spans.

    One RLock guards id allocation, the live-span table, the ring, and
    the per-stage aggregates — span operations are short critical
    sections, never user code under the lock."""

    def __init__(self, clock=time.monotonic, ring=DEFAULT_RING):
        self._lock = threading.RLock()
        self._clock = clock
        self.anchor = (clock(), time.time_ns())
        self._ring = deque(maxlen=max(1, int(ring)))
        self._live = {}  # span_id -> Span
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._stages = {}  # span name -> [count, total_seconds]

    def start(self, name, parent=None, trace_id=None, attrs=None):
        """Create a live span. parent=None with no trace_id starts a new
        trace (a root span); a parent Span propagates its trace."""
        with self._lock:
            if parent is not None and parent.trace_id is not None:
                tid = parent.trace_id
                pid = parent.span_id
            else:
                tid = trace_id or "t%08x" % next(self._trace_ids)
                pid = None
            span = Span(self, name, tid, next(self._span_ids), pid, self._clock())
            self._live[span.span_id] = span
            if attrs:
                span.attrs.update(attrs)
            return span

    # -- readout -------------------------------------------------------------

    def tail(self, n=None):
        """The most recent finished spans, oldest first (whole ring when
        n is None)."""
        with self._lock:
            spans = list(self._ring)
        return spans if n is None else spans[-n:]

    def live_snapshot(self):
        """Spans started but not yet ended, in start order."""
        with self._lock:
            return sorted(self._live.values(), key=lambda s: s.span_id)

    def spans_for(self, trace_id, follow_links=True):
        """Every retained span (finished + live) of `trace_id`, in
        span_id order. With follow_links, traces referenced by a
        `batch_trace` attribute (the request->batch join the serve layer
        records) are included — the "full span tree" a flight-recorder
        dump wants."""
        if trace_id is None:
            return []
        with self._lock:
            universe = list(self._ring) + list(self._live.values())
        wanted = {trace_id}
        out = [s for s in universe if s.trace_id in wanted]
        if follow_links:
            linked = {
                s.attrs.get("batch_trace")
                for s in out
                if s.attrs.get("batch_trace")
            } - wanted
            if linked:
                wanted |= linked
                out = [s for s in universe if s.trace_id in wanted]
        return sorted(out, key=lambda s: s.span_id)

    def stage_summary(self):
        """{span name: {count, total_s, mean_s}} over every FINISHED span
        — the per-stage breakdown metrics.snapshot() embeds while tracing
        is on (queue_wait / coalesce / dispatch / device / demux)."""
        with self._lock:
            return {
                name: {
                    "count": c,
                    "total_s": round(tot, 6),
                    "mean_s": round(tot / c, 6) if c else None,
                }
                for name, (c, tot) in sorted(self._stages.items())
            }


# -- module-level switchboard (the instrumented seams call these) ------------

_tracer = None
_current = contextvars.ContextVar("coconut_trace_span", default=None)


def enabled():
    return _tracer is not None


def get_tracer():
    """The installed Tracer, or None while tracing is disabled."""
    return _tracer


def enable(clock=time.monotonic, ring=None, tracer=None):
    """Install a (new) global tracer and register the per-stage breakdown
    with metrics.snapshot(). Returns the tracer. Re-enabling replaces the
    previous tracer (fresh ring, fresh ids)."""
    global _tracer
    if ring is None:
        ring = int(os.environ.get(ENV_RING, str(DEFAULT_RING)))
    _tracer = tracer if tracer is not None else Tracer(clock=clock, ring=ring)
    from .. import metrics

    metrics.register_provider(
        "trace_stages", lambda: _tracer.stage_summary() if _tracer else {}
    )
    return _tracer


def disable():
    """Back to the zero-cost no-op path; drops the tracer and its ring."""
    global _tracer
    _tracer = None
    from .. import metrics

    metrics.unregister_provider("trace_stages")


def start_span(name, parent=None, root=False, **attrs):
    """Create a live span WITHOUT activating it on the current context —
    the cross-thread form (the serve queue starts a request's span on the
    client thread; the supervisor ends it after demux). Parent resolution:
    explicit `parent` wins; `root=True` forces a new trace; otherwise the
    context-active span (if any) is the parent. Returns NOOP when
    tracing is disabled."""
    t = _tracer
    if t is None:
        return NOOP
    if parent is None and not root:
        parent = _current.get()
    if parent is NOOP or (parent is not None and parent.trace_id is None):
        parent = None
    return t.start(name, parent=parent, attrs=attrs or None)


def span(name, parent=None, root=False, **attrs):
    """`with span("dispatch"): ...` — start + activate + end-on-exit.
    The no-op singleton when tracing is disabled."""
    return start_span(name, parent=parent, root=root, **attrs)


class _Use:
    """Activate an EXISTING span on the current context without ending it
    on exit — how the supervisor re-enters a batch span it created during
    launch when it later settles the batch."""

    __slots__ = ("_span", "_token")

    def __init__(self, s):
        self._span = s
        self._token = None

    def __enter__(self):
        if self._span is not None and self._span is not NOOP:
            self._token = _current.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        return False


def use(s):
    """Context manager: make `s` the current span without owning its
    lifetime (no-op for None / NOOP)."""
    return _Use(s)


def current():
    """The context-active Span, or None (never NOOP)."""
    s = _current.get()
    return None if s is NOOP else s


def event(name, **attrs):
    """Record a timestamped event on the context-active span, if any —
    the retry ladder's hook: zero-cost when tracing is off or nothing is
    active."""
    if _tracer is None:
        return
    s = _current.get()
    if s is not None and s is not NOOP:
        s.event(name, **attrs)


def end_span(s, **attrs):
    """End a span defensively (None / NOOP / already-ended all safe)."""
    if s is not None and s is not NOOP:
        s.end(**attrs)


def _env_enabled(value):
    """COCONUT_TRACE parse: unset/0/false/off/no -> disabled."""
    return value is not None and value.strip().lower() not in _FALSY


if _env_enabled(os.environ.get(ENV_FLAG)):  # pragma: no cover - env-driven
    enable()
