"""One device's serving loop — the port's copy of
`coconut_tpu/engine/executor.py`: an inbox worker thread running the
launch/settle double buffer for its device, built with its primary
program's device-pinned dispatch closure, plus a per-program dispatch
registry: `seed()` registers another program's closure and
`dispatch_for()` resolves a program name to its closure (falling back to
the primary), so one pool multiplexes heterogeneous batches — a prepare
batch and a show-verify batch ride the same inbox, each dispatched through
its own program's closure.
"""

import threading
from collections import deque

from .. import metrics


class Executor:
    """One device's serving loop: an inbox worker thread running the
    launch/settle async double-buffer for ITS device.

    Load accounting (`load()`: unsettled request lanes) drives the
    placer's least-loaded pick; `can_accept()` bounds unsettled batches
    to 1 (sync dispatch) or 2 (async: one in flight + one being encoded),
    which is the pool-shaped generalization of the old single supervisor's
    double buffer — anything beyond that stays in the request queue where
    admission control is. Settling kicks the engine's queues so a
    capacity-gated placer re-checks.

    GENERATIONS: the worker thread carries the generation it was spawned
    under. `abandon()` (crash containment, watchdog timeout) bumps the
    generation and drops the thread reference — the old worker, possibly
    still stuck inside a hung dispatch, becomes STALE: `_next`/`_finish`
    ignore it, and the engine's stale-settle guard discards whatever it
    eventually returns. `start()` can then respawn a FRESH worker for the
    probation probe."""

    def __init__(
        self,
        service,
        index,
        label=None,
        device=None,
        dispatch=None,
        is_async=False,
        placement="single",
    ):
        self.service = service
        self.index = index
        self.label = str(index) if label is None else label
        self.device = device
        self.dispatch = dispatch
        self.is_async = is_async
        self.placement = placement  # "single" | "sharded"
        self._prog_dispatch = {}
        self.busy_timer = "serve_dev%s_busy_s" % self.label
        self._cond = threading.Condition()
        self._inbox = deque()
        self._load = 0  # unsettled request lanes (queued + in flight)
        self._batches_out = 0  # unsettled batches (capacity bound)
        self._closed = False
        self._gen = 0
        self._thread = None

    # -- program registry ----------------------------------------------------

    def seed(self, program, dispatch):
        """Register `program`'s device dispatch closure on this executor.
        The primary program keeps the bare `.dispatch` attribute (tests
        stub it directly)."""
        self._prog_dispatch[program] = dispatch

    def dispatch_for(self, program):
        """The dispatch closure for `program`, falling back to the primary
        `.dispatch` when the program was never seeded here."""
        return self._prog_dispatch.get(program, self.dispatch)

    def supports(self, program):
        return program in self._prog_dispatch or self.dispatch is not None

    # -- placer side ---------------------------------------------------------

    def load(self):
        with self._cond:
            return self._load

    def batches_out(self):
        with self._cond:
            return self._batches_out

    def can_accept(self):
        with self._cond:
            return self._batches_out < (2 if self.is_async else 1)

    def submit_batch(self, requests):
        with self._cond:
            self._inbox.append(requests)
            self._load += len(requests)
            self._batches_out += 1
            load = self._load
            self._cond.notify_all()
        metrics.set_gauge("serve_dev%s_load" % self.label, load)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Spawn the worker thread — a no-op while one is running (or
        after close()). Also the PROBATION revival path: after abandon()
        the thread slot is empty, so start() spawns a fresh worker under
        the new generation."""
        with self._cond:
            if self._closed or self._thread is not None:
                return
            gen = self._gen
            self._thread = threading.Thread(
                target=self._run,
                args=(gen,),
                name="coconut-serve-dev%s.g%d" % (self.label, gen),
                daemon=True,
            )
            thread = self._thread
        thread.start()

    def close(self):
        """Stop accepting; the loop still settles its inbox, then exits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def join(self, timeout=None):
        """Wait for the current worker. The thread is read once, under the
        lock: abandon() may clear it while we wait (a watchdog expiry
        during a drain, or a park), and a worker abandoned meanwhile is
        done as far as the caller is concerned — its work was handed on.
        (The reference reads `_thread` again after the wait, which raises
        AttributeError when abandon() ran in between.)"""
        with self._cond:
            thread = self._thread
        if thread is None:
            return True
        thread.join(timeout)
        with self._cond:
            abandoned = self._thread is not thread
        return abandoned or not thread.is_alive()

    def has_worker(self):
        """A live (non-abandoned) worker thread exists — the executor can
        still settle batches, even quarantined."""
        with self._cond:
            return self._thread is not None and self._thread.is_alive()

    def is_current(self, gen):
        with self._cond:
            return gen == self._gen

    def abandon(self):
        """Crash/hang containment: bump the generation (the old worker —
        possibly stuck inside a dispatch that will never return — becomes
        stale), sweep the inbox, zero the load so the placer never routes
        here until a probation probe revives it. Returns the swept
        batches; the CALLER owns redistributing them. Unlike poison(),
        the executor is NOT closed: start() can respawn it."""
        with self._cond:
            self._gen += 1
            self._thread = None
            swept = list(self._inbox)
            self._inbox.clear()
            self._load = 0
            self._batches_out = 0
            self._cond.notify_all()
        metrics.set_gauge("serve_dev%s_load" % self.label, 0)
        return swept

    def sweep_inbox(self):
        """Pull every QUEUED (not yet launched) batch back out — the soft
        quarantine path: the worker stays alive to settle what's in
        flight, but its backlog moves to survivors."""
        with self._cond:
            swept = list(self._inbox)
            self._inbox.clear()
            for batch in swept:
                self._load = max(0, self._load - len(batch))
                self._batches_out = max(0, self._batches_out - 1)
            load = self._load
            self._cond.notify_all()
        metrics.set_gauge("serve_dev%s_load" % self.label, load)
        return swept

    def poison(self, exc):
        """Crash sweep: refuse everything still queued on this device."""
        from ..serve.batcher import fail_all

        with self._cond:
            self._closed = True
            swept = list(self._inbox)
            self._inbox.clear()
            self._load = 0
            self._batches_out = 0
            self._cond.notify_all()
        for batch in swept:
            fail_all(batch, exc)

    # -- worker loop ---------------------------------------------------------

    def _next(self, gen, block):
        with self._cond:
            while True:
                if self._gen != gen:
                    return None  # abandoned: this worker is stale — exit
                if self._inbox:
                    return self._inbox.popleft()
                if self._closed or not block:
                    return None
                self._cond.wait()

    def _finish(self, gen, n_lanes):
        with self._cond:
            if self._gen != gen:
                return  # stale worker: accounting belongs to the new gen
            self._load = max(0, self._load - n_lanes)
            self._batches_out = max(0, self._batches_out - 1)
            load = self._load
        metrics.set_gauge("serve_dev%s_load" % self.label, load)
        # capacity freed: wake every placer gated on ready()
        self.service._kick_all()

    def _run(self, gen):
        svc = self.service
        pending = None  # launched, unsettled (async double-buffer slot)
        current = None  # popped from the inbox, not yet fully handled
        try:
            while True:
                current = self._next(gen, block=pending is None)
                if current is not None:
                    launched = svc._launch(current, self)
                    if pending is not None:
                        svc._settle(*pending)
                        self._finish(gen, len(pending[1]))
                        pending = None
                    if self.is_async:
                        # double-buffer: leave this batch in flight and go
                        # take the next while the device runs
                        pending = launched
                    else:
                        svc._settle(*launched)
                        self._finish(gen, len(current))
                    current = None
                    continue
                if pending is not None:
                    # nothing ready to overlap with: settle the in-flight
                    # batch now instead of holding its latency hostage
                    svc._settle(*pending)
                    self._finish(gen, len(pending[1]))
                    pending = None
                    continue
                # closed/abandoned and inbox empty: exit
                return
        except BaseException as e:  # loop-level crash (a code bug escaping
            # the per-batch containment in _launch/_settle): hand THIS
            # executor's unsettled batches — in-flight and mid-launch — to
            # the engine for quarantine + redistribution; the pool
            # survives unless this was the last executor
            batches = []
            spans = []
            if pending is not None:
                batches.append(pending[1])
                spans.append(pending[6])
            if current is not None and (
                pending is None or current is not pending[1]
            ):
                batches.append(current)
            svc._executor_failed(self, e, batches, spans, gen)
