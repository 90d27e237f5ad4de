"""Health gossip: the router's per-replica health directory, fed by
periodic beacons.

Each replica self-reports a wire.Beacon (engine health-ladder summary,
queue depth, brownout flag) when polled on its beacon endpoint. The
router's GossipLoop polls every replica each interval; the
HealthDirectory folds the results into a routing view with the SAME
demotion shape the engine gives executors:

  WARMING   registered but not yet proven ready: either no beacon has
            landed yet (a freshly registered replica starts here, which closes
            the optimistic-UP hole where a new registration could
            receive traffic before its first beacon) or the replica's
            beacon self-reports "warming" (lifecycle warmup: manifest
            replay / compilation-cache priming still running)
            -> never receives NEW sessions, not even as a spill target
  UP        beacons arriving, replica reports admissible capacity
  DEGRADED  beacons arriving, but the replica reports itself
            quarantine-level (zero admissible executors) or browned out
            -> demoted for NEW sessions, eligible only as a last-resort
            spill target
  DRAINING  the replica announced a graceful shutdown (beacon state
            "draining", or the data path received a retryable
            closed-replica refusal — note_draining): in-flight work is
            settling there but NEW sessions must go elsewhere
  DOWN      `miss_threshold` consecutive poll failures (or an explicit
            transport failure reported by the router's data path)
            -> not routed to at all; an in-flight failure there is
            retried on survivors

A DOWN or WARMING replica joins/rejoins the moment a fresh admissible
beacon lands — restart-and-readmit needs no operator action, exactly
like the probation ladder re-admits executors. A DRAINING replica that
completes its restart comes back the same way: its successor process
beacons "warming" then "healthy".

Counters: "gateway_beacons", "gateway_beacon_misses",
"gateway_demoted", "gateway_readmitted", "gateway_warmed" (first
admissible beacon promoted a WARMING replica), "gateway_drain_observed"
(a beacon or data-path refusal moved a replica into DRAINING); gauge
"gateway_up_replicas". Clock and polling are injectable: fake-clock
tests call `step()` directly and never sleep.
"""

import threading
import time

from .. import metrics

WARMING = "warming"
UP = "up"
DEGRADED = "degraded"
DRAINING = "draining"
DOWN = "down"


class _ReplicaView:
    __slots__ = ("state", "beacon", "misses", "t_beacon")

    def __init__(self):
        # pessimistic until the first admissible beacon lands: a freshly
        # registered replica may still be compiling (lifecycle WARMING)
        # and must not receive traffic on registration alone
        self.state = WARMING
        self.beacon = None
        self.misses = 0
        self.t_beacon = None


class HealthDirectory:
    """The router's view of every replica's health. Thread-safe: the
    gossip loop writes while router data-path threads read and report
    transport failures."""

    def __init__(self, replica_ids=(), miss_threshold=3):
        if miss_threshold < 1:
            raise ValueError(
                "miss_threshold must be >= 1 (got %r)" % (miss_threshold,)
            )
        self.miss_threshold = miss_threshold
        self._lock = threading.Lock()
        self._views = {}
        for rid in replica_ids:
            self._views[rid] = _ReplicaView()
        self._publish_locked()

    def _view(self, rid):
        v = self._views.get(rid)
        if v is None:
            v = self._views[rid] = _ReplicaView()
        return v

    def _publish_locked(self):
        metrics.set_gauge(
            "gateway_up_replicas",
            sum(1 for v in self._views.values() if v.state == UP),
        )

    def observe(self, beacon, now=None):
        """Fold one received beacon in; a DOWN/DEGRADED/WARMING replica
        whose fresh beacon reports admissible capacity is (re)admitted.
        Lifecycle self-reports map straight through: a beacon stating
        "warming" or "draining" pins the view to that state regardless of
        the capacity fields it carries."""
        with self._lock:
            v = self._view(beacon.replica_id)
            was = v.state
            v.beacon = beacon
            v.misses = 0
            v.t_beacon = now
            if beacon.state == "warming":
                v.state = WARMING
            elif beacon.state == "draining":
                v.state = DRAINING
            else:
                degraded = (not beacon.admissible()) or beacon.brownout
                v.state = DEGRADED if degraded else UP
            if was == WARMING and v.state in (UP, DEGRADED):
                metrics.count("gateway_warmed")
            elif was not in (UP, WARMING) and v.state == UP:
                metrics.count("gateway_readmitted")
            if was == UP and v.state != UP:
                metrics.count("gateway_demoted")
            if was != DRAINING and v.state == DRAINING:
                metrics.count("gateway_drain_observed")
            metrics.count("gateway_beacons")
            self._publish_locked()

    def miss(self, rid):
        """One failed beacon poll; `miss_threshold` consecutive misses
        demote the replica to DOWN."""
        with self._lock:
            v = self._view(rid)
            v.misses += 1
            metrics.count("gateway_beacon_misses")
            if v.misses >= self.miss_threshold and v.state != DOWN:
                v.state = DOWN
                metrics.count("gateway_demoted")
            self._publish_locked()

    def note_failure(self, rid):
        """The router's DATA PATH hit a transport failure on `rid`:
        demote immediately — waiting out miss_threshold beacon intervals
        would keep routing sessions into a dead socket."""
        with self._lock:
            v = self._view(rid)
            v.misses = max(v.misses, self.miss_threshold)
            if v.state != DOWN:
                v.state = DOWN
                metrics.count("gateway_demoted")
            self._publish_locked()

    def note_draining(self, rid):
        """The router's DATA PATH received a retryable closed-replica
        refusal from `rid`: it is mid-graceful-shutdown. Softer than
        note_failure — the replica still answers beacon polls (which will
        confirm or supersede this), but NEW sessions must stop landing on
        it NOW, not an interval from now."""
        with self._lock:
            v = self._view(rid)
            if v.state not in (DOWN, DRAINING):
                v.state = DRAINING
                metrics.count("gateway_drain_observed")
            self._publish_locked()

    def state(self, rid):
        with self._lock:
            return self._view(rid).state

    def beacon(self, rid):
        with self._lock:
            return self._views[rid].beacon if rid in self._views else None

    def epochs(self, rid):
        """Live (epoch_id, state) pairs `rid` last advertised (wire v2
        beacons; () when no beacon has landed or the replica runs no key
        lifecycle) — the router's view of which mint epochs still verify
        there."""
        with self._lock:
            v = self._views.get(rid)
            if v is None or v.beacon is None:
                return ()
            return tuple(getattr(v.beacon, "epochs", ()) or ())

    def state_marks(self, rid):
        """Per-keyspace state high-water marks `rid` last advertised
        ((keyspace, origin, seq) triples; wire v3 beacons; () when no
        beacon has landed or the replica runs no StateStore) — the
        StateReplicator's gap-detection input (state/replicate.py)."""
        with self._lock:
            v = self._views.get(rid)
            if v is None or v.beacon is None:
                return ()
            return tuple(getattr(v.beacon, "state_marks", ()) or ())

    def queue_depth(self, rid):
        """Last-beacon queue depth (the least-loaded spill key); unknown
        replicas sort last."""
        with self._lock:
            v = self._views.get(rid)
            if v is None or v.beacon is None:
                return float("inf")
            return v.beacon.queue_depth

    def states(self):
        with self._lock:
            return {rid: v.state for rid, v in self._views.items()}

    def routable(self, rid):
        return self.state(rid) == UP

    def usable(self, rid):
        """UP or DEGRADED — the spill pool (DEGRADED beats DOWN: a
        browned-out replica still answers, a dead one does not). WARMING
        and DRAINING are excluded on purpose: placing a new session on a
        still-compiling or mid-shutdown replica trades a short spill for
        a guaranteed slow or refused request."""
        return self.state(rid) in (UP, DEGRADED)


class GossipLoop:
    """Poll every replica's beacon endpoint each interval and feed the
    directory. `pollers` maps replica_id -> zero-arg callable returning a
    wire.Beacon (raising on transport failure = a miss). Fake-clock tests
    call step() directly; start() runs the real thread."""

    def __init__(
        self,
        directory,
        pollers,
        interval_s=0.25,
        clock=time.monotonic,
    ):
        self.directory = directory
        self.pollers = dict(pollers)
        self.interval_s = interval_s
        self.clock = clock
        self._stop = threading.Event()
        self._thread = None

    def step(self, now=None):
        """One poll sweep across every replica."""
        now = self.clock() if now is None else now
        for rid, poll in self.pollers.items():
            try:
                beacon = poll()
            except Exception:
                self.directory.miss(rid)
                continue
            self.directory.observe(beacon, now=now)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="gateway-gossip", daemon=True
            )
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.step()

    def stop(self, timeout=None):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            alive = self._thread.is_alive()
            self._thread = None
            return not alive
        return True
