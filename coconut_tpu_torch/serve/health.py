"""Self-healing policy for the device pool: per-executor health state
machine, hung-dispatch watchdog, and graded load-shedding (brownout) —
the port's copy of `coconut_tpu/serve/health.py`.

Three independent, individually-injectable policy objects the service
(serve/service.py) composes; none of them touches an executor directly —
they DECIDE, the service ACTS — so every transition is unit-testable with
a fake clock and zero real sleeps.

ExecutorHealth — a circuit breaker per executor::

      HEALTHY --failure--> SUSPECT --failures--> QUARANTINED
         ^                    |                       |
         |<----success--------+              cooldown elapsed
         |                                            v
         +<---- probe_successes probes ---------- PROBATION
                                                      |
                                 probe failure / crash: re-QUARANTINED
                                 with the cooldown ESCALATED (backoff)

    Consecutive batch-level failures (past the retry+fallback ladder)
    open the breaker: `suspect_after` failures mark the executor
    SUSPECT, `quarantine_after` QUARANTINE it. A crash or a watchdog
    timeout quarantines immediately. QUARANTINED executors receive no
    placement; once `cooldown_s` elapses the breaker goes HALF-OPEN
    (PROBATION): the placer routes it ONE live probe batch at a time, and
    `probe_successes` consecutive good probes close the breaker back to
    HEALTHY (a failed probe re-quarantines with the cooldown multiplied
    by `cooldown_backoff`, so a persistently bad device backs off toward
    `max_cooldown_s` instead of flapping). Every transition lands as a
    "health" span (obs/) and in the metrics counters/gauges documented in
    metrics.py.

Watchdog — deadline-checks in-flight dispatches. The retry ladder only
fires when a dispatch RETURNS; a wedged device never returns, so the
watchdog tracks every dispatch from launch and
`expire()`s the ones that outlive their budget: ``k × EMA`` of that
executor's observed dispatch-to-settle time, clamped to
[min_timeout_s, max_timeout_s], with `initial_timeout_s` covering the
first dispatch (which may pay a kernel build). Expired entries are POPPED
(a hang fires exactly once); the service abandons the stuck executor and
redistributes the hung batch. The clock is injectable: tests drive
expiry by advancing a fake clock, never by sleeping.

BrownoutPolicy — graded load-shedding. Admission control (queue.py) is a
hard bound that doesn't know half the pool is quarantined. The brownout
policy does: when surviving capacity drops below `capacity_threshold` or
queue depth crosses `depth_threshold × max_depth`, bulk-lane submissions
are shed with the typed, retriable `ServiceBrownoutError` (carrying a
pressure-scaled retry-after hint) while interactive traffic stays live
up to the hard admission bound — the bulk backfill retries later; the
user at the turnstile does not.
"""

import threading
import time

from .. import metrics
from ..obs import trace as otrace

#: health states, in escalation order (also the gauge values in
#: "serve_dev<label>_health")
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"

#: states the placer may route NEW work to (probation additionally limits
#: itself to one half-open probe at a time — enforced by the service,
#: which can see the executor's unsettled-batch count)
ADMISSIBLE_STATES = frozenset({HEALTHY, SUSPECT, PROBATION})


class HealthPolicy:
    """Knobs for the per-executor circuit breaker / probation ladder.

    suspect_after / quarantine_after: consecutive batch-failure counts
    that open the breaker (SUSPECT is the warning shot, QUARANTINED stops
    placement). probe_after_s: initial cooldown before a quarantined
    executor gets a half-open probe window. probe_successes: consecutive
    good probe batches that close the breaker. cooldown_backoff /
    max_cooldown_s: a failed probe (or a crash during probation)
    multiplies the next cooldown, bounded — persistent failures back off
    instead of flapping."""

    def __init__(
        self,
        suspect_after=1,
        quarantine_after=3,
        probe_after_s=5.0,
        probe_successes=2,
        cooldown_backoff=2.0,
        max_cooldown_s=300.0,
    ):
        if suspect_after < 1 or quarantine_after < suspect_after:
            raise ValueError(
                "need 1 <= suspect_after <= quarantine_after (got %r, %r)"
                % (suspect_after, quarantine_after)
            )
        if probe_successes < 1:
            raise ValueError(
                "probe_successes must be >= 1 (got %r)" % (probe_successes,)
            )
        self.suspect_after = suspect_after
        self.quarantine_after = quarantine_after
        self.probe_after_s = probe_after_s
        self.probe_successes = probe_successes
        self.cooldown_backoff = cooldown_backoff
        self.max_cooldown_s = max_cooldown_s


class ExecutorHealth:
    """One executor's breaker state. Thread-safe: settles report from
    executor threads while the watchdog/placer read concurrently."""

    #: bounded per-breaker transition history (journaled + replayed)
    HISTORY_CAP = 16

    def __init__(
        self,
        label,
        policy=None,
        clock=time.monotonic,
        metric_ns="serve",
        gauge_prefix="serve_dev",
        journal=None,
    ):
        """metric_ns / gauge_prefix: the counter namespace and health-gauge
        prefix this breaker reports under ("serve" / "serve_dev" for the
        verify pool). The state machine is surface-agnostic; only the
        telemetry labels differ.

        `journal`: optional callable(label, record) invoked after every
        state transition (UNDER the breaker lock — it must not call back
        into the breaker); the engine wires it to a StateStore "health"
        keyspace so a restarted replica remembers which executors were
        flapping (ExecutionEngine.attach_health_journal)."""
        self.label = label
        self.policy = policy if policy is not None else HealthPolicy()
        self.clock = clock
        self.metric_ns = metric_ns
        self.gauge = "%s%s_health" % (gauge_prefix, label)
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.probe_ok = 0
        self.quarantines = 0  # lifetime open count (for operators)
        self.quarantined_at = None
        self.cooldown_s = self.policy.probe_after_s
        self.last_reason = None
        self.journal = journal
        #: last HISTORY_CAP transitions as (from, to, reason) — the
        #: flap record an operator (or a restart) reads back
        self.history = []
        self._lock = threading.Lock()

    def _transition(self, new, reason):
        old, self.state = self.state, new
        self.last_reason = reason
        self.history.append((old, new, reason))
        del self.history[: -self.HISTORY_CAP]
        metrics.set_gauge(self.gauge, new)
        if self.journal is not None:
            # callers hold self._lock, so hand the journal a prebuilt
            # record instead of letting it call back into the breaker
            try:
                self.journal(self.label, self._record_locked())
            except Exception:
                metrics.count("health_journal_errors")
        if otrace.enabled():
            # instant span: one record per transition, greppable by
            # executor label in the export
            otrace.start_span(
                "health",
                root=True,
                executor=self.label,
                frm=old,
                to=new,
                reason=reason,
            ).end()
        return old, new

    # -- breaker inputs (called by the service) ------------------------------

    def on_success(self):
        """A batch settled cleanly. Returns (old, new) on a state change,
        else None."""
        with self._lock:
            self.consecutive_failures = 0
            if self.state == PROBATION:
                self.probe_ok += 1
                if self.probe_ok >= self.policy.probe_successes:
                    # breaker closes; de-escalate the cooldown so the NEXT
                    # incident starts from the base again
                    self.cooldown_s = self.policy.probe_after_s
                    metrics.count("%s_recovered" % self.metric_ns)
                    return self._transition(
                        HEALTHY, "probe ladder closed the breaker"
                    )
                return None
            if self.state == SUSPECT:
                return self._transition(HEALTHY, "dispatch succeeded")
            return None

    def on_failure(self, reason="batch failure"):
        """A batch failed past retry+fallback (NOT a data rejection — a
        forged credential is the credential's problem, not the device's).
        Returns (old, new) on a state change, else None."""
        with self._lock:
            if self.state == QUARANTINED:
                return None
            if self.state == PROBATION:
                metrics.count("%s_probe_failures" % self.metric_ns)
                return self._quarantine_locked(
                    "probe failed: %s" % reason, escalate=True
                )
            self.consecutive_failures += 1
            if self.consecutive_failures >= self.policy.quarantine_after:
                return self._quarantine_locked(reason, escalate=False)
            if (
                self.state == HEALTHY
                and self.consecutive_failures >= self.policy.suspect_after
            ):
                return self._transition(SUSPECT, reason)
            return None

    def on_crash(self, reason="executor crash"):
        """The executor loop crashed or a dispatch hung (watchdog): the
        breaker opens immediately, whatever the failure count was."""
        with self._lock:
            if self.state == QUARANTINED:
                return None
            if self.state == PROBATION:
                metrics.count("%s_probe_failures" % self.metric_ns)
            return self._quarantine_locked(
                reason, escalate=self.state == PROBATION
            )

    def _quarantine_locked(self, reason, escalate):
        if escalate:
            self.cooldown_s = min(
                self.cooldown_s * self.policy.cooldown_backoff,
                self.policy.max_cooldown_s,
            )
        self.quarantines += 1
        self.quarantined_at = self.clock()
        self.probe_ok = 0
        self.consecutive_failures = 0
        metrics.count("%s_quarantined" % self.metric_ns)
        return self._transition(QUARANTINED, reason)

    # -- half-open promotion (called by the watchdog tick) -------------------

    def try_probation(self, now=None):
        """QUARANTINED -> PROBATION once the cooldown has elapsed; returns
        True iff the promotion happened (the caller revives the executor
        and kicks the placer)."""
        with self._lock:
            if self.state != QUARANTINED:
                return False
            now = self.clock() if now is None else now
            if now - self.quarantined_at < self.cooldown_s:
                return False
            self.probe_ok = 0
            self._transition(
                PROBATION, "cooldown elapsed: half-open probe window"
            )
            return True

    def admissible(self):
        """May the placer route NEW work here at all? (PROBATION is
        additionally limited to one outstanding probe — the service
        enforces that, since it owns the batch count.)"""
        return self.state in ADMISSIBLE_STATES

    # -- durability: journal record + replay -------------------------

    def _record_locked(self):
        return {
            "state": self.state,
            "quarantines": self.quarantines,
            "cooldown_s": self.cooldown_s,
            "consecutive_failures": self.consecutive_failures,
            "reason": self.last_reason,
            "history": [list(h) for h in self.history],
        }

    def snapshot_record(self):
        """The journaled, last-writer-wins record for this breaker: one
        dict per executor label, bounded by HISTORY_CAP — compaction is
        structural (overwrite-in-place), not epoch-based."""
        with self._lock:
            return self._record_locked()

    def restore(self, record, now=None):
        """Adopt a journaled record on replica restart. The flap memory
        (lifetime quarantine count, ESCALATED cooldown, history) carries
        over verbatim; live placement state is re-derived conservatively:
        a breaker that died QUARANTINED or PROBATION re-enters
        QUARANTINED with the cooldown clock restarted at `now` (the
        device gets no placement until it re-earns it through the probe
        ladder), while HEALTHY/SUSPECT restart HEALTHY — but with the
        remembered cooldown, so the NEXT incident still backs off from
        where the flapping left off."""
        with self._lock:
            self.quarantines = int(record.get("quarantines", 0))
            self.cooldown_s = min(
                float(record.get("cooldown_s", self.policy.probe_after_s)),
                self.policy.max_cooldown_s,
            )
            self.consecutive_failures = int(
                record.get("consecutive_failures", 0)
            )
            self.history = [
                tuple(h) for h in record.get("history", ())
            ][-self.HISTORY_CAP:]
            prior = record.get("state", HEALTHY)
            self.probe_ok = 0
            if prior in (QUARANTINED, PROBATION):
                self.quarantined_at = (
                    self.clock() if now is None else now
                )
                self._transition(
                    QUARANTINED,
                    "restored from journal (was %s: %s)"
                    % (prior, record.get("reason")),
                )
            else:
                # no transition — HEALTHY is the constructor state and
                # journaling a no-op restore would churn the store
                metrics.set_gauge(self.gauge, self.state)


class Watchdog:
    """Deadline tracker for in-flight device dispatches.

    `begin()` at launch, `end()` at settle (success updates the
    per-executor EMA of dispatch-to-settle time), `expire(now)` pops and
    returns everything past its deadline. Budget per dispatch:
    ``clamp(k * ema, min_timeout_s, max_timeout_s)``, or
    `initial_timeout_s` while no EMA exists yet (the first dispatch may
    pay the kernel build and cold tables; don't shoot it). All state is behind one lock —
    executor threads begin/end while the watchdog thread expires."""

    def __init__(
        self,
        clock=time.monotonic,
        k=6.0,
        min_timeout_s=1.0,
        initial_timeout_s=600.0,
        max_timeout_s=600.0,
        alpha=0.25,
    ):
        if k <= 0 or alpha <= 0 or alpha > 1:
            raise ValueError("need k > 0 and 0 < alpha <= 1")
        self.clock = clock
        self.k = k
        self.min_timeout_s = min_timeout_s
        self.initial_timeout_s = initial_timeout_s
        self.max_timeout_s = max_timeout_s
        self.alpha = alpha
        self._lock = threading.Lock()
        self._inflight = {}  # (label, seq) -> (deadline, started, reqs, span)
        self._ema = {}  # label -> EMA of successful dispatch durations

    def _budget_locked(self, label):
        ema = self._ema.get(label)
        if ema is None:
            return self.initial_timeout_s
        return min(self.max_timeout_s, max(self.min_timeout_s, self.k * ema))

    def budget(self, label):
        """Current deadline budget for `label`'s next dispatch."""
        with self._lock:
            return self._budget_locked(label)

    def ema(self, label):
        with self._lock:
            return self._ema.get(label)

    def begin(self, label, seq, requests, span=None, now=None):
        now = self.clock() if now is None else now
        with self._lock:
            self._inflight[(label, seq)] = (
                now + self._budget_locked(label),
                now,
                requests,
                span,
            )

    def end(self, label, seq, ok=True, now=None):
        """Dispatch settled. Returns its duration when it both completed
        successfully AND was still tracked (an expired entry was already
        popped — a late settle after a timeout never pollutes the EMA)."""
        now = self.clock() if now is None else now
        with self._lock:
            entry = self._inflight.pop((label, seq), None)
            if entry is None or not ok:
                return None
            dur = max(0.0, now - entry[1])
            prev = self._ema.get(label)
            self._ema[label] = (
                dur if prev is None else self.alpha * dur + (1 - self.alpha) * prev
            )
            return dur

    def forget_label(self, label):
        """Drop every tracked dispatch of `label` (its executor crashed:
        the crash path already owns those batches)."""
        with self._lock:
            gone = [key for key in self._inflight if key[0] == label]
            for key in gone:
                del self._inflight[key]
            return len(gone)

    def expire(self, now=None):
        """Pop and return every overdue dispatch as
        ``(label, seq, requests, span, overdue_s)`` — popping makes each
        hang fire exactly once."""
        now = self.clock() if now is None else now
        out = []
        with self._lock:
            due = [k for k, v in self._inflight.items() if now >= v[0]]
            for key in due:
                deadline, _started, requests, span = self._inflight.pop(key)
                out.append((key[0], key[1], requests, span, now - deadline))
        return out

    def inflight(self):
        with self._lock:
            return len(self._inflight)


class BrownoutPolicy:
    """Graded load-shedding decision: shed the bulk lane first when
    capacity degrades or the queue backs up; interactive traffic rides
    through to the hard admission bound.

    capacity_threshold: brownout when the admissible fraction of the pool
    drops BELOW this. depth_threshold: brownout when queue depth reaches
    this fraction of max_depth. retry_after_s: base of the retry hint the
    typed ServiceBrownoutError carries, scaled up with pressure."""

    def __init__(
        self, capacity_threshold=0.5, depth_threshold=0.75, retry_after_s=0.5
    ):
        if not 0.0 <= capacity_threshold <= 1.0:
            raise ValueError("capacity_threshold must be in [0, 1]")
        if not 0.0 < depth_threshold <= 1.0:
            raise ValueError("depth_threshold must be in (0, 1]")
        self.capacity_threshold = capacity_threshold
        self.depth_threshold = depth_threshold
        self.retry_after_s = retry_after_s

    def check(self, lane, depth, max_depth, capacity_fraction):
        """(active, retry_after_s_or_None): `active` is whether brownout
        conditions hold at all (the "serve_brownout" gauge); the second
        element is non-None iff THIS submission should be shed."""
        overloaded = bool(max_depth) and depth >= self.depth_threshold * max_depth
        degraded = capacity_fraction < self.capacity_threshold
        active = overloaded or degraded
        if not active or lane != "bulk":
            # interactive stays live through brownout; its only shed is
            # the hard admission bound (ServiceOverloadedError)
            return active, None
        pressure = max(
            1.0 - capacity_fraction,
            (depth / max_depth) if max_depth else 0.0,
        )
        return True, round(self.retry_after_s * (1.0 + pressure), 3)
