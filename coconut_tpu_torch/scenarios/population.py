"""Population-scale open-loop traffic driver — the port's copy of
`coconut_tpu/scenarios/population.py`.

Simulates millions of users as lightweight STATE RECORDS, not threads:
a `User` is a ~100-byte slotted object materialized lazily on first
arrival (an untouched uid costs nothing, so `n_users=5_000_000` is a
config value, not an allocation), carrying exactly the state the
scenarios need — tenant, per-user rng seed, minted credential, signed
campaigns, unspent coin, think-time horizon.

The driver is OPEN-LOOP (the coordinated-omission-safe discipline
serve/loadgen.py documents): arrivals come from a seeded
inhomogeneous Poisson stream (arrivals.py) regardless of how slow the
system responds. Each arrival picks a user (per-user Zipf-skewed
tenant already assigned), a scenario by mix weight, and starts a
WorkflowRun — whose every step advances via future callbacks on
engine/transport threads, so the driver thread only does three
things: pace arrivals, wake parked retries, expire deadlines, and
sample the per-second gauges for the report.

Back-pressure: `max_in_flight` bounds concurrent workflows — an
arrival beyond the window is counted `scenario_deferred` and DROPPED
(open-loop semantics: a user who finds the site down walks away; the
driver can never OOM on queued futures). Users already mid-workflow
or still in think-time skip the arrival (`scenario_thinking`).
"""

import heapq
import random
import threading
import time

from .. import metrics
from .arrivals import arrival_times, zipf_cdf, zipf_pick
from .workflow import CANCELLED, WorkflowRun

#: think-time bounds (uniform draw) between one user's workflows
DEFAULT_THINK_S = (0.5, 4.0)


class User:
    """One simulated user: all scenario-visible state, a few hundred
    bytes, no thread."""

    __slots__ = (
        "uid", "tenant", "seed", "msgs", "esk", "epk", "credential",
        "signed", "coin", "spent_show", "think_until", "busy",
        "shows_done",
    )

    def __init__(self, uid, tenant, seed):
        self.uid = uid
        self.tenant = tenant
        self.seed = seed
        self.msgs = None          # attribute Frs (lazily drawn)
        self.esk = None           # per-user ElGamal keypair
        self.epk = None
        self.credential = None    # minted Coconut credential
        self.signed = set()       # petition campaigns signed
        self.coin = None          # unspent e-cash credential
        self.spent_show = None    # last spent transcript (replay bait)
        self.think_until = 0.0
        self.busy = False
        self.shows_done = 0


class Population:
    """Lazily-materialized user universe with Zipf-skewed tenant
    assignment: `user(uid)` derives tenant and seed deterministically
    from (seed, uid), so the same uid is the same user in every run —
    and only touched uids ever exist in memory."""

    def __init__(self, n_users, n_tenants=8, zipf_s=1.2, seed=0):
        if n_users <= 0:
            raise ValueError("need at least one user")
        self.n_users = int(n_users)
        self.n_tenants = int(n_tenants)
        self.zipf_s = float(zipf_s)
        self.seed = int(seed)
        self._cdf = zipf_cdf(self.n_tenants, self.zipf_s)
        self._users = {}

    def tenant_of(self, uid):
        rng = random.Random((self.seed << 34) ^ (uid * 2654435761))
        return zipf_pick(rng, self._cdf)

    def user(self, uid):
        u = self._users.get(uid)
        if u is None:
            u = User(uid, self.tenant_of(uid), (self.seed << 20) ^ uid)
            self._users[uid] = u
        return u

    def materialized(self):
        return len(self._users)


class PopulationDriver:
    """Feeds scenario workflows into an engine/gateway client from a
    seeded arrival schedule, through a bounded in-flight window.

    `scenarios` is a list of (weight, scenario) pairs; each scenario
    object implements `workflow(user, rng)` -> Workflow (petition.py /
    ecash.py / access.py). `report` is a ScenarioReport (report.py);
    the driver records every terminal run and samples the per-second
    gauge timeline into it."""

    def __init__(self, population, scenarios, schedule, duration_s,
                 max_in_flight=256, seed=0, clock=time.monotonic,
                 sleep=time.sleep, report=None, engine=None,
                 elastic=None, drain_timeout_s=30.0):
        self.population = population
        self.scenarios = [(float(w), s) for w, s in scenarios]
        if not self.scenarios:
            raise ValueError("need at least one scenario")
        self.schedule = schedule
        self.duration_s = float(duration_s)
        self.max_in_flight = int(max_in_flight)
        self.rng = random.Random(seed)
        self.clock = clock
        self.sleep = sleep
        self.report = report
        #: optional: sampled for the elastic timeline + driven ticks
        self.engine = engine
        self.elastic = elastic
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._in_flight = 0
        self._runs = set()
        self._parked = []  # heap of (ready_at, tiebreak, run)
        self._park_seq = 0
        self.arrivals = 0
        self.deferred = 0
        self.thinking = 0

    # -- workflow bookkeeping (runs on engine/transport threads too) --------

    def _on_park(self, run, ready_at):
        with self._lock:
            self._park_seq += 1
            heapq.heappush(self._parked, (ready_at, self._park_seq, run))

    def _on_terminal(self, run):
        with self._lock:
            self._in_flight -= 1
            self._runs.discard(run)
        if self.report is not None:
            self.report.record(run)

    def _pick_scenario(self):
        total = sum(w for w, _ in self.scenarios)
        r = self.rng.random() * total
        for w, s in self.scenarios:
            r -= w
            if r <= 0:
                return s
        return self.scenarios[-1][1]

    def _start_one(self, now):
        uid = self.rng.randrange(self.population.n_users)
        user = self.population.user(uid)
        if user.busy or user.think_until > now:
            self.thinking += 1
            metrics.count("scenario_thinking")
            return
        with self._lock:
            if self._in_flight >= self.max_in_flight:
                self.deferred += 1
                metrics.count("scenario_deferred")
                return
            self._in_flight += 1
        scenario = self._pick_scenario()
        user.busy = True
        wf_rng = random.Random(user.seed ^ (user.shows_done << 8)
                               ^ self.arrivals)
        wf = scenario.workflow(user, wf_rng)
        lo, hi = getattr(scenario, "think_s", DEFAULT_THINK_S)
        user.think_until = now + lo + wf_rng.random() * (hi - lo)

        def _done(run, _user=user):
            _user.busy = False
            self._on_terminal(run)

        run = WorkflowRun(
            wf, clock=self.clock, seed=user.seed ^ 0x5EED,
            on_terminal=_done, on_park=self._on_park,
        )
        with self._lock:
            self._runs.add(run)
        run.start()

    # -- the pump ------------------------------------------------------------

    def _wake_parked(self, now):
        ready = []
        with self._lock:
            while self._parked and self._parked[0][0] <= now:
                ready.append(heapq.heappop(self._parked)[2])
        for run in ready:
            run.resubmit()

    def _expire_deadlines(self, now):
        with self._lock:
            runs = list(self._runs)
        for run in runs:
            run.expire_if_past_deadline(now)

    def _sample(self, t0, now):
        # elastic decisions ride the 1 Hz sample cadence — the policy's
        # consecutive-sample hysteresis expects evenly-spaced readings,
        # not one per 20 ms pump iteration
        if self.elastic is not None:
            try:
                self.elastic.tick(now)
            except Exception:
                metrics.count("scenario_elastic_tick_errors")
        if self.report is None:
            return
        with self._lock:
            in_flight = self._in_flight
        active = None
        if self.engine is not None:
            try:
                active = self.engine.active_pool_size()
            except Exception:
                active = None
        self.report.sample(now - t0, in_flight, active_executors=active)

    def run(self):
        """Drive the full schedule, then drain. Returns the report's
        built dict (or a minimal summary without a report)."""
        t0 = self.clock()
        if self.report is not None:
            self.report.t0 = t0
        next_sample = 0.0
        for off in arrival_times(self.schedule, self.duration_s, self.rng):
            target = t0 + off
            while True:
                now = self.clock()
                self._wake_parked(now)
                self._expire_deadlines(now)
                if now - t0 >= next_sample:
                    self._sample(t0, now)
                    next_sample = (now - t0) // 1.0 + 1.0
                if now >= target:
                    break
                self.sleep(min(0.02, target - now))
            self.arrivals += 1
            self._start_one(self.clock())
        # drain: stop admitting, pump until every run is terminal
        drain_until = self.clock() + self.drain_timeout_s
        while True:
            now = self.clock()
            self._wake_parked(now)
            self._expire_deadlines(now)
            if now - t0 >= next_sample:
                self._sample(t0, now)
                next_sample = (now - t0) // 1.0 + 1.0
            with self._lock:
                live = len(self._runs)
            if live == 0 or now >= drain_until:
                break
            self.sleep(0.02)
        with self._lock:
            leftovers = list(self._runs)
        for run in leftovers:
            run.cancel(CANCELLED)
        elapsed = self.clock() - t0
        summary = {
            "arrivals": self.arrivals,
            "deferred": self.deferred,
            "thinking": self.thinking,
            "users_materialized": self.population.materialized(),
            "elapsed_s": round(elapsed, 3),
        }
        if self.report is not None:
            return self.report.build(t0, elapsed, driver=summary)
        return summary
