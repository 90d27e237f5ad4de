"""The port's replica lifecycle (`coconut_tpu_torch.engine.lifecycle` and
the engine's park and warm seams), against the JAX package's, on the CPU.

- Manifests: the same shape set saved by both packages gives the same
  bytes, each package loads the other's file, and missing, garbage,
  wrong-schema, malformed and unreadable files give the same counters.
- LifecycleController: boot and drain on the same stub engine (and on a
  real engine over a stub backend) give the same state sequence, gauges
  and counters; the successor boots from its predecessor's manifest.
- ElasticPolicy / ElasticController: one fixed trace of (depth, busy,
  active) readings gives the same decisions; the busy fraction comes
  from the executors' "serve_dev<d>_busy_s" timers.
- The engine's park seam on a real ExecutionEngine (a CredentialService
  over a stub backend, two executors): park, unpark, the race back-out,
  the emergency unpark after a hung dispatch, the parked-inbox sweep,
  and parking invisible to health — the same records in both packages.
- Beacons: Replica(lifecycle=...) reports warming -> healthy ->
  draining -> down through boot and drain.

Tolerance: exact — bytes, states, gauges, counters and decisions.
Everything runs on stubs and fake clocks.
"""

import importlib
import threading
from types import SimpleNamespace

import pytest

pytestmark = pytest.mark.lifecycle


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        errors=imp("errors"),
        faults=imp("faults"),
        engine=imp("engine"),
        lc=imp("engine.lifecycle"),
        serve=imp("serve"),
        health=imp("serve.health"),
        queue=imp("serve.queue"),
        rpc=imp("net.rpc"),
        wire=imp("net.wire"),
        params=imp("params"),
        signature=imp("signature"),
    )


REF, PORT = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")
BOTH = (REF, PORT)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _same(script, *args):
    """Run `script(pkg, *args)` in both packages (metrics reset first) and
    return the port's record after asserting it equals the reference's."""
    out = []
    for pkg in BOTH:
        pkg.metrics.reset()
        try:
            out.append(script(pkg, *args))
        finally:
            pkg.metrics.reset()
    assert out[1] == out[0]
    return out[1]


def _counters(pkg, *prefixes):
    return {
        k: v
        for k, v in sorted(pkg.metrics.snapshot()["counters"].items())
        if k.startswith(prefixes)
    }


def _lifecycle_counters(pkg):
    """The lifecycle_* counters but "lifecycle_cache_config_errors": the
    reference configures JAX's compile cache on the CPU, the port finds
    no card to ready its kernel library on (see
    test_configure_compilation_cache_without_a_card)."""
    out = _counters(pkg, "lifecycle_")
    out.pop("lifecycle_cache_config_errors", None)
    return out


def _gauges(pkg, *names):
    return {n: pkg.metrics.get_gauge(n) for n in names}


SHAPES = [
    ("verify", "single", (8,)),
    ["verify", "single", [8]],  # the same shape, JSON spelling
    ("prepare", "sharded", (16, 3)),
    ("mint", "single", (4, (2, 1))),
    ("bad-entry",),  # malformed: dropped
]


# --- manifests ---------------------------------------------------------------


def test_manifest_bytes_identical_and_cross_loadable(tmp_path):
    paths = {}
    for pkg in BOTH:
        m = pkg.lc.ShapeManifest(shapes=SHAPES, engine_name="eng-a")
        assert len(m) == 3
        paths[pkg.name] = tmp_path / ("%s.json" % pkg.name)
        m.save(paths[pkg.name])
    ref_bytes = paths[REF.name].read_bytes()
    assert paths[PORT.name].read_bytes() == ref_bytes
    assert b'"schema": 1' in ref_bytes
    for reader in BOTH:
        for writer in BOTH:
            got = reader.lc.ShapeManifest.load(paths[writer.name])
            assert got.engine_name == "eng-a"
            assert got.shapes == [
                ("mint", "single", (4, (2, 1))),
                ("prepare", "sharded", (16, 3)),
                ("verify", "single", (8,)),
            ]


def _manifest_faults(pkg, root):
    root = root / pkg.name
    root.mkdir()
    out = [len(pkg.lc.ShapeManifest.load(root / "absent.json"))]
    files = {
        "garbage": b"\x00not json at all",
        "schema": b'{"schema": 99, "shapes": []}',
        "list": b"[1, 2]",
        "entry": b'{"schema": 1, "shapes": [7]}',
        "ok": b'{"schema": 1, "engine": "e", "shapes": [{"program": "verify"}]}',
    }
    for name, data in files.items():
        (root / name).write_bytes(data)
        m = pkg.lc.ShapeManifest.load(root / name)
        out.append((name, m.engine_name, m.shapes,
                    pkg.metrics.get_count("lifecycle_manifest_corrupt")))
    # unreadable: a directory where the file should be
    (root / "dir.json").mkdir()
    out.append(len(pkg.lc.ShapeManifest.load(root / "dir.json")))
    # an entry JSON cannot express is dropped with a counter
    pkg.lc.ShapeManifest(
        shapes=[("verify", "single", (object(),)), ("verify", "single", (2,))]
    ).save(root / "partial.json")
    out.append((root / "partial.json").read_text())
    out.append(_lifecycle_counters(pkg))
    return out


def test_manifest_faults_give_the_same_counters(tmp_path):
    out = _same(_manifest_faults, tmp_path)
    assert out[-1] == {"lifecycle_manifest_corrupt": 5,
                       "lifecycle_manifest_unserializable": 1}


# --- LifecycleController on a stub engine ----------------------------------------


class StubLifecycleEngine:
    """What LifecycleController and Replica touch; futures settle inline."""

    def __init__(self, pkg, shapes=(), name="stub"):
        self.pkg = pkg
        self.name = name
        self._shapes = set(shapes)
        self.warm_calls = []
        self.drain_timeouts = []
        self.on_drain = None

    def depth(self):
        return 0

    def shape_keys(self):
        return set(self._shapes)

    def warm_shapes(self, shapes):
        self.warm_calls.append(sorted(shapes, key=repr))
        for s in shapes:
            self._shapes.add(tuple(s))
        return len(shapes), 0

    def drain(self, timeout=None):
        self.drain_timeouts.append(timeout)
        if self.on_drain is not None:
            self.on_drain()
        return True

    def submit_verify(self, sig, messages, lane="interactive", max_wait_ms=None):
        self._shapes.add(("verify", "single", (len(messages),)))
        fut = self.pkg.queue.ServeFuture()
        fut.set_result(True)
        return fut


def _boot_and_drain(pkg, root):
    path = root / ("%s.json" % pkg.name)
    pkg.lc.ShapeManifest(
        shapes=[("verify", "single", (4,)), ("mint", "single", (2,))], engine_name="pred"
    ).save(path)
    clock = FakeClock()
    states = []

    class Gating(StubLifecycleEngine):
        def warm_shapes(self, shapes):
            states.append(lc.state)  # still WARMING mid-replay
            clock.advance(1.5)
            return super().warm_shapes(shapes)

    eng = Gating(pkg)
    lc = pkg.lc.LifecycleController(eng, manifest_path=path, clock=clock)
    states.append((lc.state, lc.ready(), pkg.metrics.get_gauge("lifecycle_state")))
    out = {"boot": lc.boot(), "again": lc.boot()}
    states.append((lc.state, lc.ready()))
    out["gauges_up"] = _gauges(pkg, "lifecycle_state", "lifecycle_manifest_shapes",
                               "lifecycle_warmup_s")
    eng.submit_verify(None, [1, 2, 3]).result(1.0)
    eng.on_drain = lambda: states.append((lc.state, pkg.metrics.get_gauge("lifecycle_state")))
    out["drain"] = lc.begin_drain(timeout=5.0)
    out["drain_again"] = lc.begin_drain(timeout=5.0)
    states.append((lc.state, pkg.metrics.get_gauge("lifecycle_state")))
    out["boot_after_drain"] = lc.boot()
    t = eng.drain_timeouts
    out["one_drain_in_budget"] = len(t) == 1 and 0.0 < t[0] <= 5.0
    out["warm_calls"] = eng.warm_calls
    out["states"] = states
    out["manifest"] = path.read_text()
    # the successor boots from the predecessor's manifest
    succ = StubLifecycleEngine(pkg, name="succ")
    lc2 = pkg.lc.LifecycleController(succ, manifest_path=path)
    out["successor"] = (lc2.boot(), succ.warm_calls, lc2.ready())
    out["counters"] = _lifecycle_counters(pkg)
    return out


def test_boot_and_drain_on_a_stub_engine(tmp_path):
    out = _same(_boot_and_drain, tmp_path)
    assert out["boot"] == (2, 0) and out["boot_after_drain"] is None
    # the second boot replays again while UP, as the reference's does
    assert out["states"] == [("warming", False, 0), "warming", "up", ("up", True),
                             ("draining", 2), ("closed", 3)]
    assert out["gauges_up"] == {"lifecycle_state": 1, "lifecycle_manifest_shapes": 2,
                                "lifecycle_warmup_s": 1.5}
    assert out["one_drain_in_budget"]
    assert out["successor"][0] == (3, 0) and out["successor"][2]


def _save_failure(pkg, root):
    class Unsaveable(StubLifecycleEngine):
        def shape_keys(self):
            raise RuntimeError("snapshot exploded")

    lc = pkg.lc.LifecycleController(Unsaveable(pkg), manifest_path=root / pkg.name)
    lc.boot()
    cold = pkg.lc.LifecycleController(StubLifecycleEngine(pkg))
    return (lc.begin_drain(timeout=1.0), lc.state, cold.boot(), cold.begin_drain(),
            _lifecycle_counters(pkg))


def test_manifest_save_failure_never_fails_a_drain(tmp_path):
    out = _same(_save_failure, tmp_path)
    assert out[:4] == (True, "closed", (0, 0), True)
    assert out[4]["lifecycle_manifest_save_errors"] == 1


def test_configure_compilation_cache_without_a_card(tmp_path):
    """Here (no card) the port's readiness step returns False and counts,
    computes nothing on the CPU, and boot proceeds to UP."""
    from coconut_tpu_torch.gpu import cuda_fp

    PORT.metrics.reset()
    plain, launches = cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES
    build_dir = cuda_fp.BUILD_DIR
    try:
        assert PORT.lc.configure_compilation_cache() is False
        assert PORT.lc.configure_compilation_cache(tmp_path / "cache") is False
        assert cuda_fp.BUILD_DIR == build_dir and cuda_fp._LIB is None
        lc = PORT.lc.LifecycleController(StubLifecycleEngine(PORT),
                                         compilation_cache_dir=tmp_path / "cache")
        assert lc.boot() == (0, 0) and lc.ready()
        assert PORT.metrics.get_count("lifecycle_cache_config_errors") == 3
        assert (cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES) == (plain, launches)
        assert not (tmp_path / "cache").exists()
    finally:
        cuda_fp.BUILD_DIR = build_dir
        PORT.metrics.reset()


# --- elastic policy and controller ---------------------------------------------------

#: (depth, busy, active) readings: hot, cold, mixed and capped streaks
TRACE = (
    [(100, 1.0, 2), (1, 0.5, 2), (100, 1.0, 2), (100, 1.0, 2), (100, 1.0, 3),
     (100, 1.0, 4), (100, 1.0, 4), (0, 0.0, 4), (0, 0.0, 4), (0, 0.0, 4),
     (0, 0.3, 3), (0, 0.1, 3), (0, 0.1, 3), (0, 0.0, 3), (7, 0.2, 2), (8, 0.0, 2),
     (3, 0.8, 2), (0, 0.76, 2)]
    + [(0, 0.0, 1)] * 5
    + [(4, 0.0, 1), (4, 0.0, 1), (3, 0.74, 1), (0, 0.75, 1), (0, 0.9, 1)]
)


def _policy_trace(pkg):
    out = []
    for kw in ({"max_executors": 4, "grow_after": 2, "shrink_after": 3},
               {"min_executors": 2, "grow_after": 1, "shrink_after": 1,
                "grow_depth_per_active": 2.0, "shrink_depth": 1},
               {}):
        p = pkg.lc.ElasticPolicy(**kw)
        out.append([p.observe(depth=d, busy=b, active=a) for d, b, a in TRACE])
    for bad in ({"min_executors": 0}, {"grow_after": 0}, {"shrink_after": 0}):
        try:
            pkg.lc.ElasticPolicy(**bad)
            out.append("accepted")
        except ValueError as e:
            out.append(str(e))
    return out


def test_elastic_policy_trace_gives_the_same_decisions():
    out = _same(_policy_trace)
    assert out[0][:4] == [None, None, None, "grow"]
    assert "shrink" in out[0] and "grow" in out[1] and "shrink" in out[1]


class ElasticStubEngine:
    def __init__(self):
        self.active = 3
        self.depth_value = 0
        self._executors = tuple(
            SimpleNamespace(busy_timer="serve_dev%d_busy_s" % i) for i in range(3))
        self.parked = []
        self.unparked = []

    def total_depth(self):
        return self.depth_value

    def active_pool_size(self):
        return self.active

    def park_executor(self, label=None):
        self.active -= 1
        self.parked.append("dev%d" % self.active)
        return self.parked[-1]

    def unpark_executor(self, label=None):
        if not self.parked:
            return None
        self.active += 1
        self.unparked.append(self.parked.pop())
        return self.unparked[-1]


def _controller(pkg):
    clock = FakeClock()
    eng = ElasticStubEngine()
    ctl = pkg.lc.ElasticController(
        eng, policy=pkg.lc.ElasticPolicy(min_executors=1, grow_after=2, shrink_after=3),
        clock=clock)
    out = [ctl.tick()]
    readings = []
    for step in range(14):
        clock.advance(1.0)
        eng.depth_value = 50 if 4 <= step < 9 else 0
        if step == 10:  # busy time accrues on the device timers
            with pkg.metrics._lock:
                for i in range(3):
                    pkg.metrics._timers["serve_dev%d_busy_s" % i] += 0.9
        out.append(ctl.tick())
        readings.append((pkg.metrics.get_gauge("elastic_depth"),
                         pkg.metrics.get_gauge("elastic_busy_fraction")))
    return (out, readings, eng.parked, eng.unparked,
            _counters(pkg, "elastic_"), ctl.sample(clock() + 1.0))


def test_elastic_controller_over_a_stub_engine():
    out, readings, parked, unparked, counters, last = _same(_controller)
    assert out.count("shrink") >= 1 and out.count("grow") == 1
    assert unparked == ["dev2"] and counters["elastic_grown"] == 1
    assert max(b for _, b in readings) == pytest.approx(0.9)
    assert last[1] == 0.0


# --- the engine's park seam on a real ExecutionEngine --------------------------------


def _cred(ok=True):
    return SimpleNamespace(sigma_1=1, sigma_2=1, ok=ok)


class StubPerCred:
    """batch_verify on host stubs; blocks while `gate` is clear once
    `hold` is set, and records which thread ran each batch."""

    def __init__(self):
        self.batch_sizes = []
        self.hold = False
        self.gate = threading.Event()
        self.entered = threading.Event()

    def batch_verify(self, sigs, msgs, vk, params):
        if self.hold:
            self.entered.set()
            assert self.gate.wait(20.0)
        self.batch_sizes.append(len(sigs))
        return [bool(getattr(s, "ok", False)) for s in sigs]


def _service(pkg, backend, clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("watchdog_interval_s", None)
    kw.setdefault("devices", 2)
    kw.setdefault("watchdog", pkg.health.Watchdog(
        clock=clock, k=2.0, min_timeout_s=1.0, initial_timeout_s=1.0))
    kw.setdefault("health_policy", pkg.health.HealthPolicy(probe_after_s=5.0, probe_successes=1))
    return pkg.serve.CredentialService(backend, None, None, clock=clock, **kw)


def _results(futs):
    return [f.result(20.0) for f in futs]


def _dispatches(pkg):
    return {k: v for k, v in pkg.metrics.counters_with_prefix("serve_dev").items()
            if k.endswith("_dispatches")}


def _health_view(pkg, svc):
    return {
        "capacity": svc._capacity_fraction(),
        "healthy": pkg.metrics.get_gauge("serve_healthy_executors"),
        "states": [svc._health_of(ex.label).state for ex in svc._executors],
        "quarantined": pkg.metrics.get_count("serve_quarantined"),
        "brownout": pkg.metrics.get_gauge("serve_brownout"),
    }


def _park_and_unpark(pkg):
    be = StubPerCred()
    clock = FakeClock()
    svc = _service(pkg, be, clock).start()
    out = {"active": [svc.active_pool_size()]}
    try:
        out["first"] = _results([svc.submit(_cred(), [i]) for i in range(4)])
        out["parked"] = svc.park_executor()
        out["parked_set"] = sorted(svc.parked_executors())
        out["active"].append(svc.active_pool_size())
        out["gauge"] = pkg.metrics.get_gauge("elastic_active_executors")
        out["health"] = _health_view(pkg, svc)
        parked = next(ex for ex in svc._executors if ex.label == out["parked"])
        out["parked_has_worker"] = parked.has_worker()
        before = _dispatches(pkg)
        out["while_parked"] = _results([svc.submit(_cred(i % 3 > 0), [i]) for i in range(12)])
        after = _dispatches(pkg)
        out["parked_dispatches"] = (after.get("serve_dev1_dispatches", 0)
                                    - before.get("serve_dev1_dispatches", 0))
        out["never_the_last"] = svc.park_executor()
        out["unknown_label"] = svc.unpark_executor("9")
        out["unparked"] = svc.unpark_executor()
        out["nothing_parked"] = svc.unpark_executor()
        out["active"].append(svc.active_pool_size())
        out["revived_has_worker"] = parked.has_worker()
        # a busy executor never parks: hold executor 0 inside a dispatch
        be.hold = True
        fut = svc.submit(_cred(), [99])
        clock.advance(1.0)  # past the partial batch's deadline
        svc.kick()
        assert be.entered.wait(20.0)
        busy = next(ex.label for ex in svc._executors if ex.batches_out() > 0)
        out["park_busy_by_label"] = svc.park_executor(busy)
        out["park_picks_the_idle"] = svc.park_executor() != busy
        be.gate.set()
        out["held"] = fut.result(20.0)
        out["health_after"] = _health_view(pkg, svc)
    finally:
        be.gate.set()
        assert svc.drain(timeout=20.0)
    out["counters"] = _counters(pkg, "elastic_")
    return out


def test_park_and_unpark_on_a_real_engine():
    out = _same(_park_and_unpark)
    assert out["parked"] == "1" and out["parked_set"] == ["1"]
    assert out["active"] == [2, 1, 2] and out["gauge"] == 1
    assert out["health"]["capacity"] == 1.0 and out["health"]["healthy"] == 1
    assert out["health"]["quarantined"] == 0 and not out["parked_has_worker"]
    assert out["parked_dispatches"] == 0
    assert out["never_the_last"] is None and out["unparked"] == "1"
    assert out["revived_has_worker"] and out["park_busy_by_label"] is None
    assert out["park_picks_the_idle"]
    assert out["counters"] == {"elastic_parked": 2, "elastic_unparked": 1}


def _race_back_out(pkg):
    """A placer lands a batch between park_executor's idle check and its
    park: the park backs out and the executor keeps its worker."""
    svc = _service(pkg, StubPerCred(), FakeClock()).start()
    try:
        ex = svc._executors[1]
        reads = iter([0, 1])
        ex.batches_out = lambda: next(reads, 0)
        out = [svc.park_executor(), sorted(svc.parked_executors()), ex.has_worker(),
               svc.active_pool_size()]
        del ex.batches_out
        out.append(_results([svc.submit(_cred(), [i]) for i in range(4)]))
        out.append(svc.park_executor())
    finally:
        assert svc.drain(timeout=20.0)
    return out + [_counters(pkg, "elastic_")]


def test_a_park_racing_a_placer_backs_out():
    out = _same(_race_back_out)
    assert out[:4] == [None, [], True, 2]
    assert out[5] == "1" and out[6] == {"elastic_parked": 1}


def _emergency_unpark(pkg):
    """Executor 0 hangs while executor 1 is parked: the watchdog abandons
    0, no active executor survives, so the parked spare is unparked and
    takes the hung batch."""
    clock = FakeClock()
    be = pkg.faults.FaultyBackend(StubPerCred(), hang_on={0})
    svc = _service(pkg, be, clock, max_batch=2)
    svc.start()
    try:
        parked = svc.park_executor()
        futs = [svc.submit(_cred(), [i]) for i in range(2)]
        assert be.hang_entered.wait(10.0)
        clock.advance(2.0)  # past the 1 s initial budget
        svc.health_tick()
        out = {
            "parked": parked,
            "verdicts": _results(futs),
            "parked_after": sorted(svc.parked_executors()),
            "active": svc.active_pool_size(),
            "counters": _counters(pkg, "elastic_", "serve_watchdog", "serve_redistributed"),
        }
    finally:
        be.hang_release.set()
    assert svc.drain(timeout=20.0)
    return out


def test_emergency_unpark_when_no_active_executor_survives():
    out = _same(_emergency_unpark)
    assert out["parked"] == "1" and out["verdicts"] == [True, True]
    assert out["parked_after"] == [] and out["active"] == 2
    assert out["counters"]["elastic_emergency_unparked"] == 1
    assert out["counters"]["serve_watchdog_timeouts"] == 1


def _stray_request(pkg, svc):
    """One verify request as the placer hands it to an executor."""
    otrace = importlib.import_module("%s.obs.trace" % pkg.name)
    req = pkg.queue.Request(_cred(), [3], "interactive", 2.0, svc.clock())
    req.program = "verify"
    req.span = otrace.start_span("request", root=True)
    return req


def _parked_inbox_sweep(pkg):
    """A batch that reached a parked executor's inbox (placed just before
    the park) is swept by health_tick onto an active executor."""
    svc = _service(pkg, StubPerCred(), FakeClock()).start()
    try:
        label = svc.park_executor()
        ex = next(e for e in svc._executors if e.label == label)
        req = _stray_request(pkg, svc)
        ex.submit_batch([req])
        landed = ex.load()
        svc.health_tick()
        out = [label, landed, req.future.result(20.0), ex.load(), ex.has_worker(),
               sorted(svc.parked_executors()),
               _counters(pkg, "elastic_", "serve_redistributed")]
    finally:
        assert svc.drain(timeout=20.0)
    return out


def test_parked_inbox_is_swept_onto_an_active_executor():
    out = _same(_parked_inbox_sweep)
    assert out[:6] == ["1", 1, True, 0, False, ["1"]]
    assert out[6]["serve_redistributed_batches"] == 1


def _join_during_abandon(pkg, kind):
    """An executor (or a signing authority) is abandoned while a drain
    waits on its worker: the join is given a thread whose wait runs
    abandon(), as a watchdog expiry or a park on another thread would."""
    svc = SimpleNamespace(_kick_all=lambda: None)
    if kind == "executor":
        worker = importlib.import_module("%s.engine.executor" % pkg.name).Executor(svc, 0)
    else:
        authority = importlib.import_module("%s.issue.authority" % pkg.name)
        signer = SimpleNamespace(id=1, sigkey=None, verkey=None)
        worker = authority.SigningAuthority(svc, signer, backend=SimpleNamespace())
    worker.start()
    thread = worker._thread
    inner_join = thread.join

    def join(timeout=None):
        worker.abandon()  # the worker's generation moves on: it exits
        inner_join(timeout)

    thread.join = join
    try:
        got = ("ok", worker.join(5.0))
    except AttributeError:
        got = ("AttributeError",)
    return got, thread.is_alive()


@pytest.mark.parametrize("kind", ["executor", "authority"])
def test_join_survives_a_concurrent_abandon_unlike_the_reference(kind):
    """A fault the scenario day found on the card: a drain joining an
    authority the watchdog abandoned meanwhile. The reference reads the
    worker's thread again after the wait and raises AttributeError; the
    port reads it once and reports the abandoned worker done."""
    assert _join_during_abandon(REF, kind) == (("AttributeError",), False)
    assert _join_during_abandon(PORT, kind) == (("ok", True), False)


# --- lifecycle on a real engine, and the replica's beacon ---------------------------


def _engine_restart(pkg, root):
    path = root / ("%s.json" % pkg.name)
    clock = FakeClock()
    svc = _service(pkg, StubPerCred(), clock, devices=1)
    lc = pkg.lc.LifecycleController(svc, manifest_path=path)
    out = {"boot": lc.boot()}
    svc.start()
    _results([svc.submit(_cred(), [i, i]) for i in range(4)])
    futs = [svc.submit(_cred(), [i]) for i in range(2)]
    clock.advance(1.0)  # past the partial batch's deadline
    svc.kick()
    _results(futs)
    out["drain"] = lc.begin_drain(timeout=20.0)
    out["manifest"] = path.read_text()
    succ = _service(pkg, StubPerCred(), FakeClock(), devices=1)
    lc2 = pkg.lc.LifecycleController(succ, manifest_path=path)
    out["successor"] = (lc2.boot(), lc2.state, sorted(succ.shape_keys()))
    out["counters"] = dict(_lifecycle_counters(pkg), **_counters(pkg, "serve_jit_shapes"))
    out["gauges"] = _gauges(pkg, "lifecycle_state", "lifecycle_manifest_shapes")
    return out


def test_lifecycle_on_a_real_engine_restarts_from_its_manifest(tmp_path):
    out = _same(_engine_restart, tmp_path)
    n = out["manifest"].count('"program"')
    assert n >= 1 and out["successor"][0] == (0, n)
    # Program.warm primes nothing in either package: every shape skipped
    assert out["counters"]["lifecycle_warm_skipped"] == n
    assert out["counters"].get("lifecycle_warmed_shapes", 0) == 0
    assert out["successor"][2] == []


def _beacons(pkg):
    params = pkg.params.Params.new(2, b"test-torch-lifecycle")
    codec = pkg.wire.WireCodec(params)
    sig = pkg.signature.Signature(params.g, params.g)
    seen = []
    eng = StubLifecycleEngine(pkg)
    lc = pkg.lc.LifecycleController(eng)
    rep = pkg.rpc.Replica(eng, codec, replica_id="rw", lifecycle=lc)
    client = pkg.rpc.GatewayClient(pkg.rpc.LoopbackTransport(rep), codec, api_key="k")
    seen.append(rep.beacon().state)
    lc.boot()
    seen.append(rep.beacon().state)
    seen.append(client.submit_verify(sig, [1]).result(5.0))

    def mid_drain():
        seen.append(rep.beacon().state)
        try:
            client.submit_verify(sig, [1]).result(5.0)
            seen.append("admitted")
        except pkg.errors.ServiceClosedError:
            seen.append("refused-retryable")

    eng.on_drain = mid_drain
    seen.append(rep.begin_drain(timeout=5.0))
    seen.append((rep.beacon().state, lc.state))
    return seen


def test_replica_beacon_follows_the_lifecycle():
    out = _same(_beacons)
    assert out == ["warming", "healthy", True, "draining", "refused-retryable", True,
                   ("down", "closed")]
