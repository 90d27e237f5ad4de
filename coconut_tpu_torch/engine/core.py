"""ExecutionEngine: the executor fabric every online Coconut phase runs on
— the port's copy of `coconut_tpu/engine/core.py`, with the same metric and
span names. The engine owns:

  ADMISSION    one bounded RequestQueue + Batcher per registered program
               (its metric namespace, max_batch, deadline and depth
               bound); brownout shedding applies the program's SLO class
               before the lane check.
  THE POOL     Executor workers (engine/executor.py), one per device,
               plus the optional mesh-sharded lane (which the port cannot
               build yet: its services refuse `mesh=`, but the engine
               stays mesh-agnostic). One pool serves every registered
               pool program: executors carry a per-program dispatch
               registry (`_seed_pool_program`), and the placer routes
               each coalesced batch by its program's rules; new (program,
               placement, shape) keys are counted under "%ns_jit_shapes".
  PLACERS      one thread per program popping its batcher behind its
               capacity gate.
  SELF-HEALING the per-executor circuit breakers, the hung-dispatch
               watchdog, probation revival, redistribution with hop caps,
               and brownout.
  LIFECYCLE    start/drain/shutdown with ONE shared deadline across
               every join; a placer crash or the death of the last
               executor sweeps every program's futures — none dangle.

serve.CredentialService and issue.IssuanceService subclass this engine and
register one program each (VerifyProgram / MintProgram);
engine.session.ProtocolEngine registers all five phases on one instance.
The pool's metric names ("serve_dev*", "serve_placed_*",
"serve_healthy_executors", ...) are the pool's whatever program a batch
belongs to; per-program names use the program's namespace
("%ns_batch_wait_s", "%ns_admitted", ...)."""

import threading
import time

from .. import metrics
from ..errors import ServiceBrownoutError, ServiceClosedError
from ..obs import trace as otrace
from ..retry import call_with_retry, note_attempt
from ..serve import health as _health
from ..serve.batcher import Batcher, fail_all
from ..serve.queue import RequestQueue
from .executor import Executor


def _next_pow2(n):
    """Smallest power of two >= n (and >= 2) — the grouped and combined
    programs' padded batch shape."""
    return 1 << max(1, (n - 1).bit_length())


def _remaining(deadline):
    """Seconds left until `deadline` on the REAL clock (thread joins are
    wall-time waits even under an injected fake clock); None = no bound."""
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


class _Runtime:
    """One registered program's runtime state on the engine."""

    __slots__ = ("program", "queue", "batcher", "thread")

    def __init__(self, program, queue, batcher):
        self.program = program
        self.queue = queue
        self.batcher = batcher
        self.thread = None


class ExecutionEngine:
    """The shared fabric. Subclasses (CredentialService, IssuanceService,
    ProtocolEngine) register programs, build the pool, and expose their
    public submit() APIs over `submit_request`."""

    def __init__(
        self,
        name="coconut-engine",
        metric_ns="serve",
        clock=time.monotonic,
        mesh=None,
        sharded_min_lanes=None,
        health_policy=None,
        watchdog=None,
        watchdog_interval_s=0.25,
        brownout=None,
        max_redispatch=None,
    ):
        self.name = name
        self.metric_ns = metric_ns
        self.clock = clock
        self.mesh = mesh
        self.sharded_min_lanes = sharded_min_lanes
        self._runtimes = {}
        self._order = []
        self._executors = []
        self._mesh_executor = None
        self._is_async = False
        self._thread = None
        self._placers = []
        self._seq_lock = threading.Lock()
        self._batch_seq = 0  # batch ids + fan-out ids + retry jitter keys
        self._crashed = None
        self._crash_msg = "service supervisor crashed: %r"
        #: (program, placement, shape) triples already dispatched — the
        #: per-program jit-shape cache bookkeeping behind "%ns_jit_shapes"
        self._shape_keys = set()

        # self-healing surfaces (serve/health.py)
        self.health_policy = (
            health_policy
            if health_policy is not None
            else _health.HealthPolicy()
        )
        self._watchdog = (
            watchdog if watchdog is not None else _health.Watchdog(clock=clock)
        )
        self._watchdog_interval_s = watchdog_interval_s
        self._brownout = (
            brownout if brownout is not None else _health.BrownoutPolicy()
        )
        self._healths = {}
        self.max_redispatch = 1 if max_redispatch is None else max_redispatch
        self._wd_stop = threading.Event()
        self._wd_thread = None
        #: health-history durability: journal callable + seed records,
        #: wired by attach_health_journal(store)
        self._health_journal = None
        self._health_seed = {}

    # -- program registry ----------------------------------------------------

    def register(self, program):
        """Register one program: bind it, give it a bounded queue and a
        batcher in ITS metric namespace. The FIRST registration is the
        engine's primary program (`_queue`/`_batcher` aliases, the bare
        placer thread name)."""
        program.bind(self)
        queue = RequestQueue(
            max_depth=program.max_depth,
            clock=self.clock,
            metric_ns=program.metric_ns,
            program=program.name,
        )
        rt = _Runtime(
            program, queue, Batcher(queue, program.max_batch, clock=self.clock)
        )
        self._runtimes[program.name] = rt
        self._order.append(rt)
        return rt

    def program(self, name):
        return self._runtimes[name].program

    @property
    def _queue(self):
        """The primary program's queue (the single-program services' —
        and their tests' — historical attribute)."""
        return self._order[0].queue

    @property
    def _batcher(self):
        return self._order[0].batcher

    def _program_of(self, requests):
        """Resolve a batch to its program runtime via the stamp the
        owning queue left on each request; bare Requests (tests build
        them directly) fall back to the primary program."""
        name = None
        if requests:
            name = getattr(requests[0], "program", None)
        rt = self._runtimes.get(name) if name is not None else None
        return rt if rt is not None else self._order[0]

    def _next_seq(self):
        with self._seq_lock:
            seq = self._batch_seq
            self._batch_seq += 1
        return seq

    # -- pool construction ---------------------------------------------------

    def _add_executor(self, device=None, dispatch=None, is_async=False):
        ex = Executor(
            self,
            len(self._executors),
            device=device,
            dispatch=dispatch,
            is_async=is_async,
        )
        self._executors.append(ex)
        return ex

    def _set_mesh_executor(self, dispatch):
        self._mesh_executor = Executor(
            self,
            len(self._executors),
            label="mesh",
            dispatch=dispatch,
            is_async=True,
            placement="sharded",
        )
        return self._mesh_executor

    def _seed_pool_program(self, program):
        """Give every pool executor `program`'s device-pinned dispatch
        closure (the cross-program multiplexing seam)."""
        for ex in self._executors:
            made = program.make_dispatch(device=ex.device)
            if made is not None:
                dispatch, _ = made
                ex.seed(program.name, dispatch)

    def _finalize_pool(self, max_redispatch=None):
        """After the pool is built: create every executor's breaker, fix
        the redispatch hop cap, publish the health gauges."""
        all_ex = self._all_executors()
        for ex in all_ex:
            self._health_of(ex.label)
        if max_redispatch is None:
            self.max_redispatch = max(1, len(all_ex) - 1)
        else:
            self.max_redispatch = max_redispatch
        if all_ex:
            self._is_async = self._executors[0].is_async
        for ex in all_ex:
            metrics.set_gauge(
                "serve_dev%s_health" % ex.label, _health.HEALTHY
            )
        self._refresh_health_gauges()

    def _all_executors(self):
        if self._mesh_executor is not None:
            return self._executors + [self._mesh_executor]
        return list(self._executors)

    # -- client side ---------------------------------------------------------

    def submit_request(
        self, program, payload, messages, lane="interactive", max_wait_ms=None
    ):
        """Admit one request on `program`'s queue; returns its ServeFuture.
        Raises ServiceBrownoutError when graded load-shedding refuses the
        program's SLO-mapped lane (retriable, carries the program name
        and a retry-after hint), ServiceOverloadedError at the admission
        bound, ServiceClosedError after drain/shutdown."""
        if self._crashed is not None:
            raise ServiceClosedError(self._crash_msg % (self._crashed,))
        rt = self._runtimes[program]
        prog = rt.program
        depth = rt.queue.depth()
        capacity = prog.capacity_fraction()
        active, retry_after = self._brownout.check(
            prog.shed_lane(lane), depth, rt.queue.max_depth, capacity
        )
        metrics.set_gauge(
            "%s_brownout" % prog.metric_ns, 1 if active else 0
        )
        if retry_after is not None:
            metrics.count("%s_shed_bulk" % prog.metric_ns)
            raise ServiceBrownoutError(
                lane,
                retry_after,
                depth=depth,
                capacity_fraction=capacity,
                program=prog.name,
            )
        return rt.queue.submit(
            payload,
            messages,
            lane=lane,
            max_wait_ms=(
                prog.max_wait_ms if max_wait_ms is None else max_wait_ms
            ),
        )

    def depth(self):
        return self._order[0].queue.depth()

    def kick(self):
        """Wake the placers to re-read the clock (fake-clock tests)."""
        self._kick_all()

    def _kick_all(self):
        for rt in self._order:
            rt.queue.kick()

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is None:
            for ex in self._all_executors():
                ex.start()
            for rt in self._order:
                rt.program.start_workers()
            self._placers = []
            for i, rt in enumerate(self._order):
                tname = (
                    self.name
                    if i == 0
                    else "%s-%s" % (self.name, rt.program.name)
                )
                rt.thread = threading.Thread(
                    target=self._run_program,
                    args=(rt,),
                    name=tname,
                    daemon=True,
                )
                self._placers.append(rt.thread)
            self._thread = self._placers[0]
            for t in self._placers:
                t.start()
            if self._watchdog_interval_s is not None:
                self._wd_thread = threading.Thread(
                    target=self._watchdog_loop,
                    name="%s-watchdog" % self.name,
                    daemon=True,
                )
                self._wd_thread.start()
        return self

    def _close_pool_and_workers(self, deadline, ok):
        """Join the pool and every program's own workers after
        intake+placement ended; every inbox batch still settles first.
        `deadline` is the drain/shutdown call's SINGLE shared deadline —
        each join gets whatever budget remains, not a fresh per-thread
        timeout. The watchdog goes LAST: it can still expire a hung
        dispatch (and redistribute its batch) while the pool drains."""
        for ex in self._all_executors():
            ex.close()
        for ex in self._all_executors():
            ok = ex.join(_remaining(deadline)) and ok
        for rt in self._order:
            rt.program.close_workers()
        for rt in self._order:
            ok = rt.program.join_workers(deadline) and ok
        for rt in self._order:
            rt.program.on_drain()
        return self._stop_watchdog(deadline) and ok

    def _stop_watchdog(self, deadline):
        thread = self._wd_thread
        if thread is None:
            return True
        self._wd_stop.set()
        thread.join(_remaining(deadline))
        return not thread.is_alive()

    def drain(self, timeout=None):
        """Close intake, settle every accepted request, join the placers,
        the executor pool, and every program's own workers. Every
        accepted future is resolved on return (True iff all threads
        exited within `timeout` — ONE deadline shared across every join,
        not a per-thread allowance)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for rt in self._order:
            rt.queue.close()
        ok = True
        if self._thread is None:
            # never started: nothing will settle the queues — fail loudly
            for rt in self._order:
                fail_all(
                    rt.queue.drain_pending(),
                    ServiceClosedError("service drained before start()"),
                    counter="%s_cancelled" % rt.program.metric_ns,
                )
        else:
            for t in self._placers:
                t.join(_remaining(deadline))
            ok = not any(t.is_alive() for t in self._placers)
        return self._close_pool_and_workers(deadline, ok)

    def shutdown(self, drain=True, timeout=None):
        """drain=True: alias for drain(). drain=False: refuse the queued
        backlog (futures fail with ServiceClosedError) but still settle
        work already placed on executors, then join — `timeout` again one
        shared deadline across all joins."""
        if drain:
            return self.drain(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        for rt in self._order:
            rt.queue.close()
            fail_all(
                rt.queue.drain_pending(),
                ServiceClosedError(
                    "service shut down before this request ran"
                ),
                counter="%s_cancelled" % rt.program.metric_ns,
            )
        ok = True
        if self._thread is not None:
            for t in self._placers:
                t.join(_remaining(deadline))
            ok = not any(t.is_alive() for t in self._placers)
        return self._close_pool_and_workers(deadline, ok)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.drain()
        return False

    # -- health (serve/health.py integration) --------------------------------

    def _health_of(self, label):
        """The POOL breaker for `label`, created on first sight
        (executors can be injected post-init — tests stub the mesh lane
        that way). With a journal attached, a new breaker first replays
        this label's journaled record — a restarted replica remembers
        which executors were flapping — and journals its own transitions
        from then on."""
        h = self._healths.get(label)
        if h is None:
            h = self._healths[label] = _health.ExecutorHealth(
                label, self.health_policy, clock=self.clock,
                journal=self._health_journal,
            )
            seed = self._health_seed.pop(label, None)
            if seed is not None:
                h.restore(seed)
        return h

    def attach_health_journal(self, store, keyspace="health"):
        """Make executor-health history durable: every breaker
        transition writes the breaker's last-writer-wins
        `snapshot_record()` under its label in the `keyspace` keyspace of
        `store` (a state.StateStore), and records already present replay
        into breakers as they are (or were) created — so a replica that
        restarts mid-flap re-quarantines the bad device and keeps its
        ESCALATED cooldown instead of re-learning the flap from scratch.

        Bounded by construction: ONE record per executor label
        (overwritten in place, never appended) with a HISTORY_CAP'd
        transition tail inside. Writes skip fsync: health history is
        best-effort durable; losing the last transition to a crash costs
        one re-learned flap, and an fsync on the hot settle path would tax
        every breaker trip."""

        def _journal(label, record):
            store.put(keyspace, label, record, fsync=False)

        self._health_journal = _journal
        for label in store.keys(keyspace):
            rec = store.get(keyspace, label)
            h = self._healths.get(label)
            if h is not None:
                h.restore(rec)
            else:
                self._health_seed[label] = rec
        for h in self._healths.values():
            h.journal = _journal

    def _admits(self, ex):
        """May the placer route NEW work to `ex`? HEALTHY/SUSPECT always;
        PROBATION only while its half-open probe slot is free (one
        unsettled probe batch at a time); QUARANTINED never."""
        h = self._health_of(ex.label)
        if not h.admissible():
            return False
        if h.state == _health.PROBATION and ex.batches_out() > 0:
            return False
        return True

    def _capacity_fraction(self):
        """Fraction of the pool the placer may still route to — the
        brownout policy's degradation signal. 1.0 with no pool (the pool
        isn't this engine's bottleneck then; own-worker programs
        override their capacity signal)."""
        exs = self._all_executors()
        if not exs:
            return 1.0
        ok = sum(1 for ex in exs if self._health_of(ex.label).admissible())
        return ok / len(exs)

    def _refresh_health_gauges(self):
        exs = self._all_executors()
        if exs:
            metrics.set_gauge(
                "serve_healthy_executors",
                sum(
                    1
                    for ex in exs
                    if self._health_of(ex.label).admissible()
                ),
            )
        for rt in self._order:
            rt.program.refresh_health_gauges()

    def _note_success(self, executor):
        change = self._health_of(executor.label).on_success()
        if change:
            self._refresh_health_gauges()
            self._kick_all()

    def _note_failure(self, executor, exc):
        """A batch failed past retry+fallback ON this executor: feed the
        circuit breaker; if that opened it (soft quarantine — the worker
        itself is alive), move the executor's queued backlog to
        survivors."""
        change = self._health_of(executor.label).on_failure(
            "batch failed past retry+fallback: %s" % type(exc).__name__
        )
        if change:
            self._refresh_health_gauges()
            self._kick_all()
            if change[1] == _health.QUARANTINED:
                self._redistribute(executor.sweep_inbox(), exc)

    def _executor_failed(self, executor, exc, batches, spans, gen):
        """Executor-loop crash containment (runs ON the dying worker's
        thread): quarantine ONLY this executor and hand its unsettled
        batches to survivors. A stale generation (the watchdog already
        abandoned this worker and redistributed its work) does nothing."""
        if not executor.is_current(gen):
            return
        metrics.count("serve_executor_crashes")
        for span in spans:
            otrace.end_span(span, error=type(exc).__name__)
        self._health_of(executor.label).on_crash(
            "executor loop crash: %s" % type(exc).__name__
        )
        swept = executor.abandon()
        self._watchdog.forget_label(executor.label)
        self._refresh_health_gauges()
        self._redistribute(list(batches) + swept, exc)
        self._kick_all()

    def _redistribute(self, batches, cause):
        """Re-place a failed executor's unsettled batches through the
        normal _route/_place seams. Each request's redispatch count is
        capped (`max_redispatch`): a poisonous batch that kills every
        executor it lands on fails ITS OWN futures after the cap instead
        of serially taking down the pool. With NO survivors — the last
        executor died — the engine poisons and every remaining future
        resolves with the crash exception: none dangle."""
        batches = [b for b in batches if b]
        for i, batch in enumerate(batches):
            survivors = [
                ex
                for ex in self._all_executors()
                if self._health_of(ex.label).admissible() or ex.has_worker()
            ]
            if not survivors:
                self._crash(cause)
                for rest in batches[i:]:
                    fail_all(rest, cause)
                return
            for r in batch:
                r.redispatches += 1
            if max(r.redispatches for r in batch) > self.max_redispatch:
                metrics.count("serve_redispatch_exhausted")
                fail_all(batch, cause)
                continue
            metrics.count("serve_redistributed_batches")
            metrics.count("serve_redistributed_requests", len(batch))
            for r in batch:
                r.span.event("redistributed", hops=r.redispatches)
            self._place(batch).submit_batch(batch)

    def health_tick(self, now=None):
        """One self-healing sweep: expire hung dispatches (abandon the
        stuck worker, quarantine its executor, redistribute the hung
        batch), let own-worker programs claim THEIR expiries and run
        their periodic work (hedges, authority probation), and promote
        quarantined pool executors whose cooldown elapsed into half-open
        PROBATION (respawning abandoned workers). Runs periodically on
        the watchdog thread in production; fake-clock tests call it
        directly after advancing time."""
        if self._crashed is not None:
            return
        now = self.clock() if now is None else now
        expired = self._watchdog.expire(now)
        from ..errors import TransientBackendError

        pool_expired = []
        for entry in expired:
            for rt in self._order:
                if rt.program.owns_expiry(entry):
                    rt.program.handle_expired(entry, now)
                    break
            else:
                pool_expired.append(entry)
        by_label = {}
        for label, seq, requests, span, overdue_s in pool_expired:
            metrics.count("serve_watchdog_timeouts")
            if span is not None:
                span.event(
                    "watchdog_timeout",
                    seq=seq,
                    overdue_s=round(overdue_s, 6),
                )
                span.end(error="WatchdogTimeout")
            by_label.setdefault(label, []).append(requests)
        for label, hung in by_label.items():
            ex = next(
                (x for x in self._all_executors() if x.label == label), None
            )
            if ex is None:
                continue
            cause = TransientBackendError(
                "dispatch on executor %s hung past its watchdog budget"
                % (label,)
            )
            self._health_of(label).on_crash("hung dispatch: watchdog timeout")
            # the worker is STUCK inside the dispatch — abandon it (its
            # eventual return, if any, is discarded by the stale-settle
            # guard) and redistribute both the hung batches and the inbox
            swept = ex.abandon()
            self._watchdog.forget_label(label)
            self._refresh_health_gauges()
            self._redistribute(hung + swept, cause)
        # half-open promotion: cooldown elapsed -> probation probe window
        for ex in self._all_executors():
            if self._health_of(ex.label).try_probation(now):
                ex.start()  # respawn an abandoned worker; no-op otherwise
                self._refresh_health_gauges()
                self._kick_all()
        for rt in self._order:
            rt.program.tick(now)
        if pool_expired:
            self._kick_all()

    def _watchdog_loop(self):
        while not self._wd_stop.wait(self._watchdog_interval_s):
            try:
                self.health_tick()
            except Exception:
                # the healer must never become the failure: count and
                # keep ticking
                metrics.count("%s_health_tick_errors" % self.metric_ns)

    # -- placement -----------------------------------------------------------

    def _route(self, requests):
        """The adaptive placement policy: "sharded" (dp-sharded across the
        mesh) or "single" (whole batch to one device). The program, batch
        size, and lane decide: only mesh-capable programs' batches of at
        least `sharded_min_lanes` with NO interactive requests take the
        mesh — a turnstile request never pays a cross-chip collective on
        its latency path, while bulk backfill batches get every chip."""
        if self._mesh_executor is None:
            return "single"
        if not self._program_of(requests).program.supports_mesh:
            return "single"
        if len(requests) < self.sharded_min_lanes:
            return "single"
        if any(r.lane == "interactive" for r in requests):
            return "single"
        return "sharded"

    def _has_capacity(self):
        """ready() gate for the pool batchers: pop a batch only when some
        ADMISSIBLE executor can take it, otherwise the backlog stays in
        the bounded queue where admission control (and the brownout
        policy) can see and refuse it. Quarantined executors contribute no
        capacity."""
        return any(
            self._admits(ex) and ex.can_accept()
            for ex in self._all_executors()
        )

    def _place(self, requests):
        """Pick the executor for one coalesced batch: the policy's route
        over the ADMISSIBLE pool, with capacity spill (a full mesh lane
        falls back to the least-loaded device and vice versa — adaptive,
        never blocking a popped batch behind one hot executor). Routing a
        batch to a PROBATION executor is that executor's half-open probe
        (counted under "serve_probes")."""
        rt = self._program_of(requests)
        prog = rt.program
        route = self._route(requests)
        metrics.count(
            "serve_placed_sharded" if route == "sharded" else
            "serve_placed_single"
        )
        mesh_ex = self._mesh_executor if prog.supports_mesh else None
        if mesh_ex is not None and not self._admits(mesh_ex):
            mesh_ex = None
        admitted = [ex for ex in self._executors if self._admits(ex)]
        singles = [ex for ex in admitted if ex.can_accept()]
        singles.sort(key=lambda ex: (ex.load(), ex.index))
        if route == "sharded" and mesh_ex is not None:
            chosen = (
                mesh_ex
                if mesh_ex.can_accept()
                else (singles[0] if singles else mesh_ex)
            )
        elif singles:
            chosen = singles[0]
        elif mesh_ex is not None and mesh_ex.can_accept():
            chosen = mesh_ex
        else:
            # no admissible executor has capacity: overflow onto the
            # least-loaded admissible one (capacity is advisory;
            # quarantine is not) — or, with the WHOLE pool quarantined,
            # onto any executor whose worker is still alive: settling
            # behind a sick device beats parking a future behind a probe
            # that may never come. Mesh-incapable programs never
            # overflow onto the mesh lane.
            candidates = (
                self._all_executors()
                if prog.supports_mesh
                else list(self._executors)
            )
            pool = (
                admitted
                or [ex for ex in candidates if ex.has_worker()]
                or self._executors
            )
            chosen = min(pool, key=lambda ex: (ex.load(), ex.index))
        if (route == "sharded") != (chosen.placement == "sharded"):
            metrics.count("serve_placed_spill")
        if self._health_of(chosen.label).state == _health.PROBATION:
            metrics.count("serve_probes")
        metrics.set_gauge(
            "%s_queue_depth" % prog.metric_ns, rt.queue.depth()
        )
        return chosen

    # -- batch work (runs on executor threads) -------------------------------

    def _launch(self, requests, executor=None):
        """Assemble + dispatch one coalesced batch NOW on `executor`'s
        device; return the settle closure state. Mirrors
        stream.verify_stream's launch(): the first dispatch attempt is
        consumed eagerly (pipelining), finalize() re-runs the full
        dispatch+readback cycle under the retry ladder, then the
        program's fallback."""
        rt = self._program_of(requests)
        prog = rt.program
        if executor is None:
            executor = self._executors[0]
        seq = self._next_seq()
        metrics.count("serve_dev%s_dispatches" % executor.label)
        metrics.count("serve_dev%s_requests" % executor.label, len(requests))
        bspan = otrace.start_span(
            "batch",
            root=True,
            seq=seq,
            n=len(requests),
            device=executor.label,
            placement=executor.placement,
            program=prog.name,
            members=[r.future.trace_id for r in requests]
            if otrace.enabled()
            else None,
        )
        for r in requests:
            # the request->batch join: a request's trace knows which
            # batch trace (hence which DEVICE) did its device work
            r.span.set(batch_trace=bspan.trace_id, batch_seq=seq)
        # deadline-track from BEFORE the first dispatch attempt: a sync
        # dispatch that hangs never returns from this very call, and the
        # watchdog is the only thing that can still free its batch
        self._watchdog.begin(
            executor.label, seq, requests, span=bspan, now=self.clock()
        )
        with otrace.use(bspan), metrics.timer(executor.busy_timer):
            with otrace.span("coalesce"):
                payload_a, payload_b = prog.assemble(requests, bspan)
            metrics.observe(
                "%s_batch_wait_s" % prog.metric_ns,
                self.clock() - min(r.t_submit for r in requests),
            )
            shape = (
                prog.name,
                executor.placement,
                prog.shape_key(requests, payload_a, payload_b),
            )
            if shape not in self._shape_keys:
                # a shape this program has not dispatched before — on a
                # jitted backend this is the compile; a flat counter
                # after warmup is the no-cross-program-recompile proof
                self._shape_keys.add(shape)
                metrics.count("%s_jit_shapes" % prog.metric_ns)
            attempts = []
            box = [None]
            permanent = None
            with otrace.span(
                "dispatch",
                backend=prog.backend_label(),
                device=executor.label,
            ):
                try:
                    box[0] = prog.run_dispatch(executor, payload_a, payload_b)
                except prog.retry_policy.retryable as e:
                    note_attempt(attempts, e)
                    otrace.event(
                        "attempt_failed",
                        attempt=len(attempts),
                        error=type(e).__name__,
                    )
                except Exception as e:
                    # permanent dispatch failure (bad inputs, code bug in
                    # a sync backend's compute): unlike the offline
                    # stream — where it aborts the run — the service
                    # contains it to THIS batch's futures; finalize
                    # re-raises without burning retries
                    permanent = e
                    otrace.event("permanent_failure", error=type(e).__name__)

        def cycle():
            fin, box[0] = box[0], None
            if fin is None:
                fin = prog.run_dispatch(executor, payload_a, payload_b)
            return fin()

        fallback = prog.make_fallback(payload_a, payload_b)

        def finalize():
            if permanent is not None:
                raise permanent
            return call_with_retry(
                cycle,
                prog.retry_policy,
                key=seq,
                attempts=attempts,
                fallback=fallback,
            )

        return (
            seq,
            requests,
            payload_a,
            payload_b,
            finalize,
            attempts,
            bspan,
            executor,
        )

    def _settle(
        self,
        seq,
        requests,
        payload_a,
        payload_b,
        finalize,
        attempts,
        bspan,
        executor=None,
    ):
        """Block on the batch result and resolve every request's future."""
        prog = self._program_of(requests).program
        if executor is None:
            executor = self._executors[0]
        with otrace.use(bspan), metrics.timer(executor.busy_timer):
            try:
                with otrace.span("device", device=executor.label):
                    result = finalize()
            except Exception as e:
                self._watchdog.end(
                    executor.label, seq, ok=False, now=self.clock()
                )
                if requests and all(r.future.done() for r in requests):
                    # stale settle: the watchdog timed this batch out and
                    # it was redistributed (and resolved) elsewhere — the
                    # late failure is nobody's news
                    bspan.end(result="stale")
                    return
                # batch-level failure past retry+fallback: each
                # cohabiting future gets the exception — never a silent
                # hang, and never another device's problem
                prog.fail_batch(requests, e)
                bspan.end(error=type(e).__name__)
                self._note_failure(executor, e)
                return
            self._watchdog.end(executor.label, seq, now=self.clock())
            if requests and all(r.future.done() for r in requests):
                # stale settle (watchdog fired, batch redistributed): the
                # verdicts were already delivered by the re-dispatch;
                # drop these — ServeFuture is single-assignment anyway
                bspan.end(result="stale")
                return
            self._note_success(executor)
            prog.demux(
                requests, result, payload_a, payload_b, seq, attempts, bspan
            )

    # -- placers -------------------------------------------------------------

    def _crash(self, e):
        """Placer crash, or the LAST executor died: sweep every queued and
        inbox future — across EVERY program — with the crash exception so
        no caller ever hangs."""
        self._crashed = e
        for rt in self._order:
            rt.queue.close()
        for rt in self._order:
            fail_all(
                rt.queue.drain_pending(),
                e,
                counter="%s_failed_requests" % rt.program.metric_ns,
            )
        for rt in self._order:
            rt.program.on_crash(e)
        for ex in self._all_executors():
            ex.poison(e)

    def _run_program(self, rt):
        try:
            while True:
                batch = rt.batcher.next_batch(
                    block=True, ready=rt.program.capacity_ready
                )
                if batch is None:
                    # closed and fully routed: executors drain their
                    # inboxes; drain()/shutdown() closes and joins them
                    return
                rt.program.place(batch)
        except BaseException as e:
            self._crash(e)
            raise
