"""The port's application scenarios (`coconut_tpu_torch.scenarios`),
against the JAX package's, on the CPU.

- Workflow units on a fake clock and fake futures (the kind
  tests/test_scenarios.py defines): retries, the retry budget, expected
  typed terminals, unattributed errors, deadlines at submit and while
  waiting, drain cancels, parked retries and the terminal hooks — the
  same outcomes, labels, codes, retries and clock in both packages.
- Traffic model: `arrival_times`, `DiurnalCurve`, `FlashCrowd`,
  `RateSchedule`, `zipf_cdf` / `zipf_pick` and `Population` give the same
  streams for one seed (and the reference suite's pinned digest);
  `ensure_material` gives the same msgs, esk and epk bytes.
- `PopulationDriver` over a fake client (futures that settle inline, a
  spent set that refuses a repeated spend tag, scripted overloads and
  hung steps) on a fake clock with an ElasticController in the loop:
  the same report — outcomes, rejection labels, error codes,
  availability timeline, SLO split, elastic counters — and started ==
  the terminal sum.
- `ScenarioReport` builds the same dict from the same run records.
- End to end: petition sign, second campaign and re-sign; the e-cash
  double spend (fresh re-show and exact replay) and an honest spend;
  an access session of re-randomised shows — through a loopback
  replica on the port's ProtocolEngine over its host spec backend with a
  StateStore, against the reference's on its python backend: the same
  outcomes, labels, codes and step counts.
- A show-verify batch the watchdog redistributed, whose two settles
  overlap: the reference refuses the honest spend as a double spend, the
  port keeps it; both refuse its replay.

Tolerance: exact — outcomes, labels, counters, streams and bytes.
"""

import hashlib
import importlib
import random
from types import SimpleNamespace

import pytest
import torch

pytestmark = pytest.mark.scenarios

MSGS = 3
HIDDEN = 1
REVEALED = [1, 2]
THRESHOLD, TOTAL = 2, 2  # 2-of-2 keeps each mint to two blind signatures on the CPU


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        errors=imp("errors"),
        sc=imp("scenarios"),
        base=imp("scenarios.base"),
        lc=imp("engine.lifecycle"),
        params=imp("params"),
        signature=imp("signature"),
    )


REF, PORT = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")
BOTH = (REF, PORT)


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


def _scenario_counters(pkg):
    return {k: v for k, v in sorted(pkg.metrics.snapshot()["counters"].items())
            if k.startswith(("scenario_", "elastic_"))}


# --- workflow units (fake clock, fake futures) -----------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


class FakeFuture:
    """Resolve or fail now or later; callbacks fire inline when already
    settled (the ServeFuture contract the runtime leans on)."""

    def __init__(self):
        self._value = None
        self._exc = None
        self._settled = False
        self._cbs = []

    def resolve(self, value=None):
        self._value, self._settled = value, True
        for cb in self._cbs:
            cb(self)

    def fail(self, exc):
        self._exc, self._settled = exc, True
        for cb in self._cbs:
            cb(self)

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return self._value

    def add_done_callback(self, fn):
        if self._settled:
            fn(self)
        else:
            self._cbs.append(fn)


def _one_step(pkg, submit, max_retries=4, expect=None):
    class OneStep(pkg.sc.Workflow):
        name = "unit"
        deadline_s = 10.0

        def __init__(self):
            self.result = None

        def script(self):
            self.result = yield pkg.sc.Step("s", submit, max_retries=max_retries)

        def classify(self, step, exc):
            if expect is not None and isinstance(exc, expect):
                return "double_spend"
            return None

    return OneStep()


def _failing(exc_fn, first=None):
    calls = []

    def submit():
        fut = FakeFuture()
        calls.append(fut)
        if first is not None and len(calls) > first:
            fut.resolve("ok")
        else:
            fut.fail(exc_fn())
        return fut

    return submit, calls


def _record(run, clock, calls=None):
    return (run.outcome, run.outcome_label, run.error_code, run.retries, run.steps_done,
            round(clock.t, 12), None if calls is None else len(calls),
            getattr(run.wf, "result", None))


def _units(pkg):
    E = pkg.errors
    overload = lambda hint=0.1: E.ServiceOverloadedError(1, 1, retry_after_s=hint)
    out = {}

    def run_unit(wf):
        clock = FakeClock()
        run = pkg.sc.WorkflowRun(wf, clock=clock, sleep=clock.sleep, seed=1)
        run.start()
        return run, clock

    submit, calls = _failing(overload, first=2)
    run, clock = run_unit(_one_step(pkg, submit))
    out["retried"] = _record(run, clock, calls)
    submit, calls = _failing(lambda: overload(0.01))
    run, clock = run_unit(_one_step(pkg, submit, max_retries=3))
    out["exhausted"] = _record(run, clock, calls)
    submit, calls = _failing(lambda: E.TransientBackendError("device hiccup"), first=1)
    run, clock = run_unit(_one_step(pkg, submit))
    out["transient"] = _record(run, clock, calls)
    submit, calls = _failing(lambda: E.DoubleSpendError("ab" * 32, 0))
    run, clock = run_unit(_one_step(pkg, submit, expect=E.DoubleSpendError))
    out["rejected"] = _record(run, clock, calls)
    run, clock = run_unit(_one_step(pkg, submit))
    out["unexpected_double_spend"] = _record(run, clock)
    submit, calls = _failing(lambda: E.GeneralError("script bug"))
    run, clock = run_unit(_one_step(pkg, submit))
    out["failed"] = _record(run, clock, calls)

    def raising():
        raise E.ServiceClosedError("draining")

    run, clock = run_unit(_one_step(pkg, raising, max_retries=2))
    out["submit_raises"] = _record(run, clock)
    submit, calls = _failing(lambda: overload(100.0))
    run, clock = run_unit(_one_step(pkg, submit))
    out["deadline_on_retry"] = _record(run, clock, calls)

    pending = FakeFuture()
    run, clock = run_unit(_one_step(pkg, lambda: pending))
    waiting = run.outcome
    clock.t = 11.0
    run.expire_if_past_deadline(clock.t)
    pending.resolve("late")
    out["deadline_while_waiting"] = (waiting, _record(run, clock))

    pending = FakeFuture()
    run, clock = run_unit(_one_step(pkg, lambda: pending))
    run.cancel()
    pending.fail(E.GeneralError("late failure"))
    out["cancelled"] = (_record(run, clock), run._gen is None and run._step is None)

    parked = []
    submit, calls = _failing(lambda: overload(0.2), first=1)
    clock = FakeClock()
    run = pkg.sc.WorkflowRun(_one_step(pkg, submit), clock=clock, sleep=clock.sleep, seed=1,
                             on_park=lambda r, at: parked.append((r, at)))
    run.start()
    before = run.outcome
    clock.t = parked[0][1]
    parked[0][0].resubmit()
    out["parked"] = (before, len(parked), round(parked[0][1], 12), _record(run, clock, calls))

    seen = []
    run = pkg.sc.WorkflowRun(_one_step(pkg, lambda: FakeFuture()), clock=FakeClock(),
                             on_terminal=lambda r: seen.append(r.outcome))
    run.start()
    run.cancel()
    run.cancel()

    def bad_hook(r):
        raise RuntimeError("hook")

    run2 = pkg.sc.WorkflowRun(_one_step(pkg, lambda: FakeFuture()), clock=FakeClock(),
                              on_terminal=bad_hook)
    run2.start()
    run2.cancel()
    out["hooks"] = (seen, run2.outcome)

    class Broken(pkg.sc.Workflow):
        def script(self):
            yield pkg.sc.Step("s", lambda: FakeFuture())
            raise AssertionError("unreachable")

        def on_terminal(self, run):
            raise RuntimeError("hook")

    def fail_check():
        raise pkg.sc.WorkflowCheckError("verdict False")
        yield  # a generator

    class Checked(pkg.sc.Workflow):
        script = staticmethod(fail_check)

    clock = FakeClock()
    out["check"] = _record(pkg.sc.run_workflow(Checked(), clock=clock, sleep=clock.sleep), clock)
    out["counters"] = _scenario_counters(pkg)
    out["constants"] = (pkg.sc.TERMINAL_OUTCOMES, pkg.sc.COMPLETED, pkg.sc.CANCELLED)
    return out


def test_workflow_units_match_the_reference():
    out = _same(_units)
    assert out["retried"][:4] == ("completed", None, None, 2) and out["retried"][6] == 3
    assert out["exhausted"][:4] == ("retry_exhausted", None, "overloaded", 3)
    assert out["rejected"][:4] == ("rejected", "double_spend", "double_spend", 0)
    assert out["unexpected_double_spend"][0] == "failed"
    assert out["failed"][:3] == ("failed", None, "general")
    assert out["deadline_on_retry"][0] == "deadline" and out["deadline_on_retry"][5] < 10.0
    assert out["deadline_while_waiting"] == (None, ("deadline", None, None, 0, 0, 11.0, None, None))
    assert out["cancelled"][0][0] == "cancelled" and out["cancelled"][1]
    assert out["parked"][0] is None and out["parked"][3][0] == "completed"
    assert out["hooks"] == (["cancelled"], "cancelled")
    assert out["check"][:3] == ("failed", None, "WorkflowCheckError")
    c = out["counters"]
    assert c["scenario_started"] == sum(c.get("scenario_%s" % o, 0)
                                        for o in out["constants"][0])


# --- traffic model ----------------------------------------------------------------


def _sched(pkg):
    return pkg.sc.RateSchedule(
        pkg.sc.DiurnalCurve(2.0, 10.0, 60.0),
        [pkg.sc.FlashCrowd(30.0, 10.0, 3.0, ramp_s=5.0)],
    )


def _streams(pkg):
    out = {}
    for seed in (7, 0x19, 12345):
        out[seed] = list(pkg.sc.arrival_times(_sched(pkg), 60.0, random.Random(seed)))
    curve = pkg.sc.DiurnalCurve(0.5, 2.0, 40.0, phase_s=3.0)
    crowd = pkg.sc.FlashCrowd(20.0, 4.8, 2.0, ramp_s=2.0)
    sched = pkg.sc.RateSchedule(curve, [crowd])
    grid = [i * 0.37 for i in range(120)]
    out["rates"] = ([curve.rate(t) for t in grid], [crowd.factor(t) for t in grid],
                    [sched.rate(t) for t in grid], sched.max_rate(), crowd.window())
    out["empty"] = list(pkg.sc.arrival_times(
        pkg.sc.RateSchedule(pkg.sc.DiurnalCurve(0.0, 0.0, 10.0)), 10.0, random.Random(1)))
    bad = []
    for fn in (lambda: pkg.sc.DiurnalCurve(2.0, 1.0, 10.0), lambda: pkg.sc.DiurnalCurve(0, 1, 0),
               lambda: pkg.sc.FlashCrowd(0, 1, 0.5), lambda: pkg.sc.zipf_cdf(0, 1.2),
               lambda: pkg.sc.Population(0)):
        try:
            fn()
            bad.append(None)
        except ValueError as e:
            bad.append(str(e))
    out["errors"] = bad
    for n, s in ((8, 1.2), (1, 1.0), (64, 0.7)):
        cdf = pkg.sc.zipf_cdf(n, s)
        rng = random.Random(n)
        out[("zipf", n)] = (cdf, [pkg.sc.zipf_pick(rng, cdf) for _ in range(200)])
    pop = pkg.sc.Population(65536, n_tenants=8, seed=0x19)
    out["population"] = ([pop.tenant_of(u) for u in range(0, 65536, 331)],
                         pop.materialized())
    users = [pop.user(u) for u in (0, 1, 17, 65535, 17)]
    out["users"] = ([(u.uid, u.tenant, u.seed) for u in users], pop.materialized(),
                    users[2] is users[4])
    return out


def test_arrival_streams_and_population_match_the_reference():
    out = _same(_streams)
    a = out[7]
    digest = hashlib.sha256(",".join("%.12f" % t for t in a).encode()).hexdigest()
    assert len(a) == 659
    assert digest == "7b8264c22c1acbf0114014ce7b84d07e4f350acda58b61f466a8a0bf830d7a75"
    assert out["empty"] == [] and None not in out["errors"]
    assert out["users"][1] == 4 and out["users"][2]


def _material(pkg):
    params = pkg.params.Params.new(MSGS, b"test-torch-scenarios")
    pop = pkg.sc.Population(1 << 20, seed=0x19)
    out = []
    for uid in (0, 5, 99999):
        u = pop.user(uid)
        pkg.base.ensure_material(u, params)
        msgs, epk = list(u.msgs), u.epk
        pkg.base.ensure_material(u, params)  # a no-op once drawn
        assert u.msgs == msgs and u.epk == epk
        out.append((u.msgs, u.esk, params.ctx.sig_to_bytes(u.epk)))
    sig = pkg.signature.Signature(params.g, params.ctx.sig.mul(params.g, 5))
    out.append(pkg.base.cred_bytes(sig, params))
    out.append(pkg.base.ScenarioBase(None, params).tag_for(sig, "ecash"))
    return out


def test_user_material_matches_the_reference():
    out = _same(_material)
    assert len(out[0][0]) == MSGS and len(out[0][2]) == 96


# --- the population driver over a fake client ----------------------------------------


class FakeClient:
    """The submit_* surface over futures that settle inline. A mint returns
    a fresh credential whose points derive from the user's first
    attribute and the mint count; a
    scoped show-verify keeps a spent set of (domain, tag) and refuses a
    repeat with the package's DoubleSpendError; every `overload_every`-th
    submission is refused with ServiceOverloadedError, and every
    `hang_every`-th show-prove never settles (its run meets its
    deadline)."""

    def __init__(self, pkg, params, overload_every=7, hang_every=23):
        self.pkg, self.params = pkg, params
        self.overload_every, self.hang_every = overload_every, hang_every
        self.calls = 0
        self.proves = 0
        self.mints = 0
        self.spent = set()

    def _future(self, settle):
        """A settled future: every `overload_every`-th call is refused
        before `settle` runs (an admission refusal commits nothing);
        otherwise `settle()` gives the value or raises the typed error."""
        fut = FakeFuture()
        self.calls += 1
        if self.overload_every and self.calls % self.overload_every == 0:
            fut.fail(self.pkg.errors.ServiceOverloadedError(3, 3, retry_after_s=0.05))
            return fut
        try:
            fut.resolve(settle())
        except self.pkg.errors.CoconutError as e:
            fut.fail(e)
        return fut

    def submit_prepare(self, msgs, epk, lane="bulk"):
        return self._future(lambda: ("request", msgs[0] % 1000))

    def submit_mint(self, sig_req, msgs, esk):
        # each mint a fresh credential, as blind signing's randomness makes it
        self.mints += 1
        k = (msgs[0] + 1009 * self.mints) % (1 << 24) + 2
        mul = self.params.ctx.sig.mul
        return self._future(lambda: self.pkg.signature.Signature(
            mul(self.params.g, k), mul(self.params.g, k + 1)))

    def submit_show_prove(self, cred, msgs):
        self.proves += 1
        if self.hang_every and self.proves % self.hang_every == 0:
            return FakeFuture()
        n = self.proves
        return self._future(lambda: (("proof", n), n, {}))

    def submit_show_verify(self, proof, revealed, challenge, epoch=None, domain=None, tag=None):
        def settle():
            if tag is not None:
                key = (domain, tag)
                if key in self.spent:
                    raise self.pkg.errors.DoubleSpendError(
                        hashlib.sha256(repr(key).encode()).hexdigest(), 0, domain)
                self.spent.add(key)
            return True

        return self._future(settle)


class FakeElasticEngine:
    """total_depth / active_pool_size / park / unpark over a counter."""

    def __init__(self, client):
        self.client = client
        self.active = 2
        self._executors = ()

    def total_depth(self):
        return self.client.calls % 9

    def active_pool_size(self):
        return self.active

    def park_executor(self, label=None):
        if self.active <= 1:
            return None
        self.active -= 1
        return str(self.active)

    def unpark_executor(self, label=None):
        if self.active >= 2:
            return None
        self.active += 1
        return str(self.active - 1)


def _driver(pkg):
    clock = FakeClock()
    params = pkg.params.Params.new(MSGS, b"test-torch-scenarios")
    client = FakeClient(pkg, params)
    engine = FakeElasticEngine(client)
    elastic = pkg.lc.ElasticController(
        engine, pkg.lc.ElasticPolicy(min_executors=1, grow_after=2, shrink_after=3,
                                     grow_depth_per_active=3.0),
        clock=clock)
    duration = 40.0
    curve = pkg.sc.DiurnalCurve(0.5, 2.0, duration)
    crowd = pkg.sc.FlashCrowd(duration * 0.5, duration * 0.12, 2.0, ramp_s=duration * 0.05)
    report = pkg.sc.ScenarioReport(slo_s=10.0, flash_window=crowd.window())
    mix = [
        (2.0, pkg.sc.PetitionScenario(client, params, campaigns=2, resign_p=0.5)),
        (2.0, pkg.sc.EcashScenario(client, params, double_spend_p=0.5)),
        (1.0, pkg.sc.AccessScenario(client, params, session_range=(2, 3))),
    ]
    for _, s in mix:
        s.think_s = (0.1, 0.5)  # a small population comes back within the day
    driver = pkg.sc.PopulationDriver(
        pkg.sc.Population(48, n_tenants=8, seed=0x19), mix, pkg.sc.RateSchedule(curve, [crowd]),
        duration, max_in_flight=3, seed=0x19, clock=clock, sleep=clock.sleep, report=report,
        engine=engine, elastic=elastic, drain_timeout_s=60.0)
    out = driver.run()
    return {"report": out, "counters": _scenario_counters(pkg),
            "client": (client.calls, client.proves, len(client.spent)), "clock": clock.t}


def test_population_driver_on_a_fake_client_matches_the_reference():
    out = _same(_driver)
    rep, c = out["report"], out["counters"]
    totals = rep["totals"]
    assert totals["completed"] > 0 and totals["failed"] == 0 and totals["cancelled"] == 0
    assert totals["deadline"] > 0 and totals["retries"] > 0
    assert totals["rejected_expected"] > 0
    assert {label for r in rep["rejections"].values() for label in r} == {"double_spend"}
    assert c["scenario_started"] == sum(c.get("scenario_%s" % o, 0)
                                        for o in REF.sc.TERMINAL_OUTCOMES)
    assert c.get("scenario_deferred", 0) > 0 and c.get("scenario_thinking", 0) > 0
    assert rep["elastic"]["grown"] + rep["elastic"]["shrunk"] > 0
    assert rep["driver"]["arrivals"] > 0


def _report(pkg):
    rep = pkg.sc.ScenarioReport(slo_s=2.0, flash_window=(5.0, 8.0))
    rep.t0 = 100.0

    def fake_run(outcome, name="petition", label=None, code=None, t_end=101.0, dur=0.5,
                 retries=1):
        return SimpleNamespace(
            wf=SimpleNamespace(name=name), outcome=outcome, outcome_label=label,
            error_code=code, retries=retries, t_start=t_end - dur, t_end=t_end)

    rep.record(fake_run("completed"))
    rep.record(fake_run("completed", t_end=106.5, dur=3.0))
    rep.record(fake_run("completed", name="access", t_end=101.0, dur=2.5))
    rep.record(fake_run("rejected", label="double_spend"))
    rep.record(fake_run("rejected", name="ecash", label=None))
    rep.record(fake_run("failed", code="general"))
    rep.record(fake_run("deadline", name="ecash", code="overloaded", t_end=109.2))
    rep.record(fake_run("retry_exhausted", name="ecash", code="overloaded", t_end=104.0))
    rep.record(fake_run("cancelled", name="access", t_end=109.9))
    pkg.metrics.set_gauge("elastic_active_executors", 1)
    pkg.metrics.set_gauge("showv_brownout", 1)
    rep.sample(0.0, in_flight=3, active_executors=2)
    rep.sample(1.0, in_flight=1)
    pkg.metrics.set_gauge("showv_brownout", 0)
    rep.sample(2.0, in_flight=0)
    pkg.metrics.count("elastic_grown")
    return rep.build(100.0, 10.0, driver={"arrivals": 9})


def test_report_builds_the_same_dict():
    out = _same(_report)
    assert out["totals"]["completed"] == 3 and out["totals"]["cancelled"] == 1
    assert out["rejections"] == {"ecash": {"rejected": 1}, "petition": {"double_spend": 1}}
    assert out["brownout_seconds"] == 2 and out["elastic"]["grown"] == 1


# --- end to end on real engines ----------------------------------------------------------


def _e2e(pkg, root):
    """A ProtocolEngine with a StateStore behind a loopback replica; the
    reference suite's four end-to-end scripts, one engine for all."""
    eng_mod = importlib.import_module("%s.engine" % pkg.name)
    keygen = importlib.import_module("%s.keygen" % pkg.name)
    rpc = importlib.import_module("%s.net.rpc" % pkg.name)
    wire = importlib.import_module("%s.net.wire" % pkg.name)
    store_mod = importlib.import_module("%s.state" % pkg.name)
    if pkg is PORT:
        from coconut_tpu_torch.backend import SpecBackend

        backend = SpecBackend()
        backend.device = torch.device("cpu")  # the nullifier guard's device
    else:
        backend = "python"
    params = pkg.params.Params.new(MSGS, b"test-scenarios")
    _, _, signers = keygen.trusted_party_SSS_keygen(THRESHOLD, TOTAL, params)
    store = store_mod.StateStore(str(root / pkg.name), replica_id="rA")
    engine = eng_mod.ProtocolEngine(
        signers, params, THRESHOLD, count_hidden=HIDDEN, revealed_msg_indices=REVEALED,
        backend=backend, devices=1, max_batch=4, max_wait_ms=5.0, state_store=store,
        # one executor: a false expiry on a loaded CPU would abandon the
        # only worker and crash the engine (the redistributed settle is
        # tested on its own below)
        watchdog_interval_s=None,
    ).start()
    codec = wire.WireCodec(params)
    replica = rpc.Replica(engine, codec, replica_id="rA")
    client = rpc.GatewayClient(rpc.LoopbackTransport(replica), codec)
    out = {}

    def rec(run):
        return (run.outcome, run.outcome_label, run.error_code, run.retries, run.steps_done)

    def run(sc, user, seed):
        return rec(pkg.sc.run_workflow(sc.workflow(user, random.Random(seed))))

    try:
        pet = pkg.sc.PetitionScenario(client, params, campaigns=2, resign_p=0.0)
        user = pkg.sc.Population(8, seed=11).user(0)
        out["petition"] = [run(pet, user, 1), sorted(user.signed), run(pet, user, 2),
                           sorted(user.signed), run(pet, user, 3), sorted(user.signed),
                           user.shows_done]
        ecash = pkg.sc.EcashScenario(client, params, double_spend_p=1.0)
        user = pkg.sc.Population(8, seed=12).user(1)
        out["double_spend"] = [run(ecash, user, 5), user.coin is None,
                               user.spent_show is not None, run(ecash, user, 6)]
        honest = pkg.sc.EcashScenario(client, params, double_spend_p=0.0)
        user = pkg.sc.Population(8, seed=13).user(2)
        out["honest"] = [run(honest, user, 8), user.coin is None, user.shows_done]
        pkg.metrics.reset()
        access = pkg.sc.AccessScenario(client, params, session_range=(3, 3))
        user = pkg.sc.Population(8, seed=14).user(3)
        out["access"] = [run(access, user, 9), user.shows_done]
        out["counters"] = _scenario_counters(pkg)
    finally:
        replica.close()
        assert engine.drain(timeout=60.0)
        store.close()
    return out


def test_scenarios_end_to_end_match_the_reference(tmp_path):
    out = _same(_e2e, tmp_path)
    done = ("completed", None, None, 0)
    assert out["petition"][0][:4] == done and out["petition"][2][:4] == done
    assert out["petition"][4][:3] == ("rejected", "double_spend", "double_spend")
    assert out["petition"][5] == [0, 1]
    assert [r[:3] for r in (out["double_spend"][0], out["double_spend"][3])] == [
        ("rejected", "double_spend", "double_spend")] * 2
    assert out["double_spend"][1:3] == [True, True]
    assert out["honest"] == [("completed", None, None, 0, 4), True, 1]
    assert out["access"] == [("completed", None, None, 0, 8), 3]
    assert out["counters"] == {"scenario_completed": 1, "scenario_started": 1}


# --- a show-verify batch the watchdog redistributed ------------------------------------


def _redistributed_spend(pkg, root):
    """One honest e-cash spend whose show-verify batch hangs on executor
    0 until the watchdog expires it and redistributes it to executor 1.
    The hung worker then returns and settles first: it commits the spend's
    nullifier and, before it resolves the future, executor 1 settles the
    same batch. Returns the spend's outcome and a replay's."""
    import threading

    eng_mod = importlib.import_module("%s.engine" % pkg.name)
    keygen = importlib.import_module("%s.keygen" % pkg.name)
    elgamal = importlib.import_module("%s.elgamal" % pkg.name)
    store_mod = importlib.import_module("%s.state" % pkg.name)
    if pkg is PORT:
        from coconut_tpu_torch.backend import SpecBackend

        backend = SpecBackend()
        backend.device = torch.device("cpu")  # the nullifier guard's device
    else:
        backend = "python"
    params = pkg.params.Params.new(MSGS, b"test-redistributed-spend")
    _, _, signers = keygen.trusted_party_SSS_keygen(THRESHOLD, TOTAL, params)
    store = store_mod.StateStore(str(root / pkg.name), replica_id="rA")
    engine = eng_mod.ProtocolEngine(
        signers, params, THRESHOLD, count_hidden=HIDDEN, revealed_msg_indices=REVEALED,
        backend=backend, devices=2, max_batch=4, max_wait_ms=5.0, state_store=store,
        watchdog_interval_s=None,
    ).start()
    hung, resumed, committed, settled_on_1 = (threading.Event() for _ in range(4))
    worker_0 = []
    showv, guard = engine._showv, engine.nullifiers
    run_dispatch, commit, settle = showv.run_dispatch, guard.commit, engine._settle

    def hanging_dispatch(executor, payload_a, payload_b):
        fin = run_dispatch(executor, payload_a, payload_b)
        if executor.label == "0" and not worker_0:
            worker_0.append(threading.current_thread())
            hung.set()
            assert resumed.wait(60.0)
        elif executor.label == "1":
            assert committed.wait(60.0)
        return fin

    def pausing_commit(*args, **kwargs):
        out = commit(*args, **kwargs)
        if worker_0 and threading.current_thread() is worker_0[0]:
            committed.set()
            settled_on_1.wait(10.0)
        return out

    def noting_settle(*args, **kwargs):
        try:
            return settle(*args, **kwargs)
        finally:
            if args[-1].label == "1":  # the settle state ends with its executor
                settled_on_1.set()

    rng = random.Random(0x5EED)
    msgs = [rng.randrange(1, 1 << 250) for _ in range(MSGS)]
    try:
        esk, epk = elgamal.elgamal_keygen(params.ctx.sig, params.g)
        req, _ = engine.submit_prepare(msgs, epk).result(120.0)
        cred = engine.submit_mint(req, msgs, esk).result(120.0)
        proof, chal, rev = engine.submit_show_prove(cred, msgs).result(120.0)
        showv.run_dispatch, guard.commit, engine._settle = (
            hanging_dispatch, pausing_commit, noting_settle)
        fut = engine.submit_show_verify(proof, rev, chal)
        assert hung.wait(60.0)
        engine.health_tick(now=engine.clock() + 10_000.0)
        resumed.set()
        try:
            spend = ("accepted", fut.result(60.0))
        except pkg.errors.DoubleSpendError:
            spend = ("refused", "double_spend")
        showv.run_dispatch, guard.commit, engine._settle = run_dispatch, commit, settle
        try:
            replay = ("accepted", engine.submit_show_verify(proof, rev, chal).result(60.0))
        except pkg.errors.DoubleSpendError:
            replay = ("refused", "double_spend")
        counters = pkg.metrics.snapshot()["counters"]
        return {"spend": spend, "replay": replay,
                "redistributed": counters.get("serve_redistributed_batches", 0),
                "timeouts": counters.get("serve_watchdog_timeouts", 0)}
    finally:
        resumed.set()
        committed.set()
        settled_on_1.set()
        assert engine.drain(timeout=60.0)
        store.close()


def test_redistributed_show_verify_keeps_the_honest_spend_unlike_the_reference(tmp_path):
    """The reference's stale-settle guard asks whether every future of the
    batch is done; executor 1 asks while the hung worker is between its
    nullifier commit and its futures, demuxes the same batch again, finds
    the nullifier spent and refuses the honest spend as a double spend.
    The port's first settle claims the batch, so the second is stale."""
    runs = {}
    for pkg in BOTH:
        pkg.metrics.reset()
        try:
            runs[pkg.name] = _redistributed_spend(pkg, tmp_path)
        finally:
            pkg.metrics.reset()
    ref, port = runs[REF.name], runs[PORT.name]
    assert (ref["redistributed"], ref["timeouts"]) == (port["redistributed"], port["timeouts"]) == (1, 1)
    assert ref["spend"] == ("refused", "double_spend")
    assert port["spend"] == ("accepted", True)
    assert ref["replay"] == port["replay"] == ("refused", "double_spend")
