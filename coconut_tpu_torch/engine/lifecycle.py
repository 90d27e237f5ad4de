"""Replica lifecycle: warm restarts, readiness gating, graceful drain,
and elastic pool sizing — the port's copy of
`coconut_tpu/engine/lifecycle.py`, with the same states, metric names and
manifest format.

  SHAPE MANIFEST   ShapeManifest persists the engine's per-program
                   (program, placement, shape_key) set — the shapes live
                   traffic exercised — to a small JSON artifact at drain
                   time.
  WARM BOOT        LifecycleController.boot() readies the compiled
                   kernel library (configure_compilation_cache: the
                   fp_mul build and load, the port's counterpart of the
                   reference's persistent compilation cache), replays
                   the manifest through engine.warm_shapes() (best-effort
                   priming via Program.warm) and only THEN promotes
                   WARMING -> UP. Readiness is gated on the replay: a
                   replica never advertises itself before it.
  LIFECYCLE STATES WARMING -> UP -> DRAINING -> CLOSED, reported through
                   Replica.beacon() so the fleet's gossip directory
                   (net/gossip.py) keeps new sessions off a warming or
                   draining replica while in-flight work settles.
  GRACEFUL DRAIN   begin_drain() flips DRAINING, settles every accepted
                   future via the engine's drain (ONE deadline shared
                   across every join — the same contract
                   ExecutionEngine.drain documents), saves the manifest
                   for the successor process, then reports CLOSED.
  ELASTIC SIZING   ElasticController samples queue depth and per-device
                   busy-seconds each tick and, through ElasticPolicy's
                   consecutive-sample hysteresis, parks idle executors
                   when the pool is cold and unparks them (the executor
                   respawn path) when pressure returns. The busy signal
                   is the executors' "serve_dev<d>_busy_s" host timers
                   (launch to settle), as in the reference.

Manifest artifact format (schema 1, byte for byte the reference's)::

    {"engine": "<engine name>", "schema": 1,
     "shapes": [{"placement": "single", "program": "verify",
                 "shape": [8]}, ...]}

`shape` is the program's shape_key with tuples rendered as JSON lists;
loading converts them back to tuples. A corrupt or unreadable manifest
is never fatal: boot proceeds cold (counted under
"lifecycle_manifest_corrupt") and the next drain rewrites it.

Metrics: gauges "lifecycle_state" (0 warming / 1 up / 2 draining /
3 closed), "lifecycle_warmup_s", "lifecycle_manifest_shapes",
"elastic_active_executors", "elastic_depth", "elastic_busy_fraction";
counters "lifecycle_warmed_shapes", "lifecycle_warm_skipped",
"lifecycle_warm_errors", "lifecycle_manifest_corrupt",
"lifecycle_manifest_save_errors", "lifecycle_manifest_unserializable",
"lifecycle_cache_config_errors", "elastic_grown", "elastic_shrunk",
"elastic_parked", "elastic_unparked", "elastic_emergency_unparked".
"""

import json
import threading
import time

from .. import metrics

WARMING = "warming"
UP = "up"
DRAINING = "draining"
CLOSED = "closed"

#: gauge encoding for "lifecycle_state"
_STATE_GAUGE = {WARMING: 0, UP: 1, DRAINING: 2, CLOSED: 3}


def _remaining(deadline):
    """Seconds left until `deadline` on the REAL clock; None = no bound."""
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


def configure_compilation_cache(cache_dir=None):
    """Best-effort: ready what a restarted replica would otherwise pay for
    on its first batch — the counterpart of the reference's persistent
    compilation cache. The port has no jit; its one compiled artifact is
    the fp_mul library (gpu/cuda_fp.py), built with nvcc into `cache_dir`
    (default: the repository's git-ignored build/) unless a library of
    the same source and flags is already there, then loaded. Returns True
    once the library is loaded, False when there is no card or no nvcc
    (counted under "lifecycle_cache_config_errors", as the reference
    counts a refused cache) — warm boot proceeds either way. This is
    readiness, not a fallback: nothing moves to the CPU, and a CUDA
    engine still raises where it cannot launch the kernel."""
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        from ..gpu import cuda_fp

        if cache_dir is not None:
            from pathlib import Path

            cuda_fp.BUILD_DIR = Path(cache_dir)
        cuda_fp._lib()
        return True
    except Exception:
        metrics.count("lifecycle_cache_config_errors")
        return False


def _canon_shape(shape):
    """JSON round-trip canonicalization: lists -> tuples, recursively,
    so a loaded manifest entry hashes equal to the live shape_key."""
    if isinstance(shape, list) or isinstance(shape, tuple):
        return tuple(_canon_shape(s) for s in shape)
    return shape


class ShapeManifest:
    """The persisted shape set: what a successor process must prime
    before advertising readiness. Plain data — (program, placement,
    shape_key) triples — with atomic save and corruption-tolerant load."""

    SCHEMA = 1

    def __init__(self, shapes=(), engine_name=""):
        self.engine_name = engine_name
        self.shapes = []
        seen = set()
        for entry in shapes:
            try:
                program, placement, shape = entry
            except (TypeError, ValueError):
                continue
            triple = (str(program), str(placement), _canon_shape(shape))
            if triple not in seen:
                seen.add(triple)
                self.shapes.append(triple)
        self.shapes.sort(key=repr)

    def __len__(self):
        return len(self.shapes)

    @classmethod
    def from_engine(cls, engine):
        """Snapshot the engine's dispatched/pre-warmed shape set."""
        return cls(
            shapes=engine.shape_keys(),
            engine_name=getattr(engine, "name", ""),
        )

    def as_dict(self):
        return {
            "schema": self.SCHEMA,
            "engine": self.engine_name,
            "shapes": [
                {"program": p, "placement": pl, "shape": list(sh)
                 if isinstance(sh, tuple) else sh}
                for p, pl, sh in self.shapes
            ],
        }

    def save(self, path):
        """Crash-atomic write (state/atomic.py: tmp + fsync +
        os.replace + dir fsync): a crash mid-save leaves the previous
        manifest intact, never a truncated one, and the bytes are fsync'd
        before the rename so the manifest survives a power cut too. Shapes
        that JSON cannot express are dropped with a counter — a partial
        manifest still warms everything it names."""
        entries = []
        for p, pl, sh in self.shapes:
            entry = {
                "program": p,
                "placement": pl,
                "shape": list(sh) if isinstance(sh, tuple) else sh,
            }
            try:
                json.dumps(entry)
            except (TypeError, ValueError):
                metrics.count("lifecycle_manifest_unserializable")
                continue
            entries.append(entry)
        doc = {
            "schema": self.SCHEMA,
            "engine": self.engine_name,
            "shapes": entries,
        }
        from ..state.atomic import replace_json

        return replace_json(str(path), doc, sort_keys=True)

    @classmethod
    def load(cls, path):
        """Load a manifest; a missing, unparseable, or wrong-schema file
        degrades to an EMPTY manifest (cold boot) with
        "lifecycle_manifest_corrupt" counted — warmup is an optimization
        and must never block a boot."""
        try:
            with open(str(path)) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return cls()
        except (OSError, ValueError):
            metrics.count("lifecycle_manifest_corrupt")
            return cls()
        if not isinstance(doc, dict) or doc.get("schema") != cls.SCHEMA:
            metrics.count("lifecycle_manifest_corrupt")
            return cls()
        shapes = []
        for entry in doc.get("shapes", ()):
            if not isinstance(entry, dict):
                metrics.count("lifecycle_manifest_corrupt")
                return cls()
            shapes.append(
                (
                    entry.get("program", ""),
                    entry.get("placement", "single"),
                    _canon_shape(entry.get("shape", ())),
                )
            )
        return cls(shapes=shapes, engine_name=doc.get("engine", ""))


class LifecycleController:
    """One replica process's lifecycle state machine around an
    ExecutionEngine:

        WARMING --boot()--> UP --begin_drain()--> DRAINING --> CLOSED

    Readiness (`ready()`) is True only in UP, and boot() promotes to UP
    strictly AFTER the manifest replay completes — Replica.beacon()
    reports "warming" until then, so the router's gossip directory never
    routes a new session at a replica that would pay a cold first batch.
    begin_drain() shares ONE deadline between the engine drain and
    everything after it (manifest save), mirroring the engine's own
    one-deadline join contract."""

    def __init__(
        self,
        engine,
        manifest_path=None,
        compilation_cache_dir=None,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.manifest_path = manifest_path
        self.compilation_cache_dir = compilation_cache_dir
        self.clock = clock
        self._lock = threading.Lock()
        self._state = WARMING
        self.warmed = 0
        self.skipped = 0
        metrics.set_gauge("lifecycle_state", _STATE_GAUGE[WARMING])

    @property
    def state(self):
        with self._lock:
            return self._state

    def _set_state(self, state):
        with self._lock:
            self._state = state
        metrics.set_gauge("lifecycle_state", _STATE_GAUGE[state])

    def ready(self):
        """May the replica advertise itself for NEW sessions?"""
        return self.state == UP

    def boot(self):
        """Warm boot: ready the compiled kernel library
        (configure_compilation_cache), load
        the shape manifest, replay it through engine.warm_shapes(), THEN
        promote WARMING -> UP. Returns (warmed, skipped). Idempotent
        while UP; a draining/closed controller refuses (returns None) —
        a process does not un-drain."""
        if self.state in (DRAINING, CLOSED):
            return None
        t0 = self.clock()
        configure_compilation_cache(self.compilation_cache_dir)
        manifest = (
            ShapeManifest.load(self.manifest_path)
            if self.manifest_path is not None
            else ShapeManifest()
        )
        metrics.set_gauge("lifecycle_manifest_shapes", len(manifest))
        warmed, skipped = self.engine.warm_shapes(manifest.shapes)
        self.warmed, self.skipped = warmed, skipped
        metrics.count("lifecycle_warmed_shapes", warmed)
        metrics.count("lifecycle_warm_skipped", skipped)
        metrics.set_gauge("lifecycle_warmup_s", self.clock() - t0)
        # readiness flips ONLY here: after the replay finished
        self._set_state(UP)
        return warmed, skipped

    def save_manifest(self):
        """Persist the engine's current shape set for the successor
        process; no-op without a manifest path."""
        if self.manifest_path is None:
            return None
        return ShapeManifest.from_engine(self.engine).save(
            self.manifest_path
        )

    def begin_drain(self, timeout=None):
        """Graceful shutdown: flip DRAINING (the beacon starts reporting
        it immediately; admission refusals become retryable handoffs),
        settle every accepted future via the engine's drain, save the
        shape manifest for the successor, then report CLOSED. `timeout`
        is ONE deadline shared across the engine's joins AND the
        manifest save — not a fresh allowance per stage. Returns True
        iff the engine drained within the deadline. Idempotent: a
        second call returns immediately."""
        with self._lock:
            if self._state in (DRAINING, CLOSED):
                return self._state == CLOSED
            self._state = DRAINING
        metrics.set_gauge("lifecycle_state", _STATE_GAUGE[DRAINING])
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        drain = getattr(self.engine, "drain", None)
        if callable(drain):
            ok = bool(drain(timeout=_remaining(deadline)))
        try:
            self.save_manifest()
        except Exception:
            # losing the manifest costs the successor a cold boot, not
            # correctness — never fail a drain over it
            metrics.count("lifecycle_manifest_save_errors")
        self._set_state(CLOSED)
        return ok


class ElasticPolicy:
    """Grow/shrink decisions with consecutive-sample hysteresis: a
    single hot (or cold) sample NEVER resizes the pool — `grow_after`
    (`shrink_after`) consecutive samples must agree, and any
    disagreeing sample resets the streak. After acting the streak
    restarts from zero, so consecutive resizes are spaced at least one
    full hysteresis window apart (no flapping).

    Signals per sample: `depth` (queued requests across every program)
    and `busy` (pool busy-fraction since the last sample, 0..1).
    GROW when depth >= grow_depth_per_active * active executors OR
    busy >= grow_busy_fraction; SHRINK when depth <= shrink_depth AND
    busy <= shrink_busy_fraction. Anything else is neutral."""

    def __init__(
        self,
        min_executors=1,
        max_executors=None,
        grow_depth_per_active=4.0,
        grow_busy_fraction=0.75,
        shrink_depth=0,
        shrink_busy_fraction=0.25,
        grow_after=2,
        shrink_after=3,
    ):
        if min_executors < 1:
            raise ValueError(
                "min_executors must be >= 1 (got %r)" % (min_executors,)
            )
        if grow_after < 1 or shrink_after < 1:
            raise ValueError("grow_after/shrink_after must be >= 1")
        self.min_executors = min_executors
        self.max_executors = max_executors
        self.grow_depth_per_active = grow_depth_per_active
        self.grow_busy_fraction = grow_busy_fraction
        self.shrink_depth = shrink_depth
        self.shrink_busy_fraction = shrink_busy_fraction
        self.grow_after = grow_after
        self.shrink_after = shrink_after
        self._grow_streak = 0
        self._shrink_streak = 0

    def observe(self, depth, busy, active):
        """Fold one sample in; returns "grow", "shrink", or None."""
        grow_signal = (
            depth >= self.grow_depth_per_active * max(1, active)
            or busy >= self.grow_busy_fraction
        )
        shrink_signal = (
            depth <= self.shrink_depth
            and busy <= self.shrink_busy_fraction
        )
        if grow_signal:
            self._grow_streak += 1
            self._shrink_streak = 0
        elif shrink_signal:
            self._shrink_streak += 1
            self._grow_streak = 0
        else:
            self._grow_streak = 0
            self._shrink_streak = 0
        if grow_signal and self._grow_streak >= self.grow_after:
            if self.max_executors is not None and active >= self.max_executors:
                return None
            self._grow_streak = 0
            return "grow"
        if shrink_signal and self._shrink_streak >= self.shrink_after:
            if active <= self.min_executors:
                return None
            self._shrink_streak = 0
            return "shrink"
        return None


class ElasticController:
    """Drives ElasticPolicy from live engine signals: queue depth
    (engine.total_depth()) and the pool's busy-fraction, derived from
    the per-device busy-seconds timers (`serve_dev<label>_busy_s`) as a
    delta over the sampling interval divided by active-executor
    wall-time. Call tick(now) periodically — production wires it into
    the engine watchdog cadence; fake-clock tests call it directly.

    Acting means parking (engine.park_executor — idle executors only,
    invisible to the health ladder) or unparking
    (engine.unpark_executor — the executor respawn path). Counted under
    "elastic_grown"/"elastic_shrunk"."""

    def __init__(self, engine, policy=None, clock=time.monotonic):
        self.engine = engine
        self.policy = policy if policy is not None else ElasticPolicy()
        self.clock = clock
        self._last_t = None
        self._last_busy = None

    def _pool_busy_seconds(self):
        totals = metrics.timers_with_prefix("serve_dev")
        busy = 0.0
        for ex in getattr(self.engine, "_executors", ()):
            busy += totals.get(getattr(ex, "busy_timer", ""), 0.0)
        return busy

    def sample(self, now=None):
        """One (depth, busy_fraction, active) reading; busy_fraction is
        None on the very first call (no interval to difference over)."""
        now = self.clock() if now is None else now
        depth = self.engine.total_depth()
        active = self.engine.active_pool_size()
        busy_total = self._pool_busy_seconds()
        busy = None
        if self._last_t is not None and now > self._last_t:
            span = (now - self._last_t) * max(1, active)
            busy = max(0.0, min(1.0, (busy_total - self._last_busy) / span))
        self._last_t = now
        self._last_busy = busy_total
        return depth, busy, active

    def tick(self, now=None):
        """Sample, decide, act. Returns "grow", "shrink", or None (also
        None on the warm-up sample and when the engine had nothing to
        park/unpark)."""
        depth, busy, active = self.sample(now)
        metrics.set_gauge("elastic_depth", depth)
        if busy is None:
            return None
        metrics.set_gauge("elastic_busy_fraction", busy)
        decision = self.policy.observe(depth, busy, active)
        if decision == "grow":
            if self.engine.unpark_executor() is not None:
                metrics.count("elastic_grown")
                return "grow"
            return None
        if decision == "shrink":
            if self.engine.park_executor() is not None:
                metrics.count("elastic_shrunk")
                return "shrink"
            return None
        return None
