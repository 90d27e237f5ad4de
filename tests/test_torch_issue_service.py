"""The port's threshold-issuance service (`coconut_tpu_torch.issue`, the
request proof of knowledge, the per-request ElGamal forms of prepare and
unblind, `Signature.verify`, FaultyBackend's sign seams) against the JAX
package's, on the CPU.

- Quorum mechanics: each scripted scenario runs once through
  `coconut_tpu`'s classes and once through `coconut_tpu_torch`'s, on stub
  signers and a stub minter of this file with a fake clock and the
  watchdog thread off (the mechanics of tests/test_issue.py), and the two
  runs must agree on every outcome and on every counter of the package's
  own metrics registry.
- Real crypto: the request proof under the same seeded draws (bytes,
  verdicts on tampered and malformed proofs, decoding), the repaired
  per-request forms at B = 3, and a 3-of-5 service with one crashed
  authority at B = 2: the reference's on `backend="python"`, the port's on
  `TorchBackend(device="cpu")`, minting byte-equal credentials.

Tolerance: exact — bytes, affine coordinates, verdicts and counters.
"""

import importlib
import random
import threading
import time
from types import SimpleNamespace

import pytest

from coconut_tpu_torch import convert, ps
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.ops.fields import R
from torch_show_helpers import seeded_randbelow, two_torch_threads  # noqa: F401 (autouse)

PACKAGES = ("coconut_tpu", "coconut_tpu_torch")


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        errors=imp("errors"),
        faults=imp("faults"),
        issue=imp("issue"),
        quorum=imp("issue.quorum"),
        health=imp("serve.health"),
        trace=imp("obs.trace"),
        sig=imp("signature"),
        pok_vc=imp("pok_vc"),
    )


# --- stub world (the kind tests/test_issue.py defines) ----------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class StubSign:
    """One opaque partial token a request, tagged with the share."""

    def __init__(self):
        self.calls = 0

    def batch_blind_sign(self, sig_requests, sigkey, params):
        self.calls += 1
        return [("partial", sigkey, req) for req in sig_requests]


class GatedSign(StubSign):
    """Blocks inside the sign until released: the scenario sets the order
    in which partials arrive."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()
        self.release = threading.Event()

    def batch_blind_sign(self, sig_requests, sigkey, params):
        self.entered.set()
        assert self.release.wait(60.0), "gate never released"
        return super().batch_blind_sign(sig_requests, sigkey, params)


class FailingSign(StubSign):
    def __init__(self, error):
        super().__init__()
        self.error = error

    def batch_blind_sign(self, sig_requests, sigkey, params):
        raise self.error("injected sign fault")


class CrashingSign(StubSign):
    def __init__(self, crash):
        super().__init__()
        self.crash = crash

    def batch_blind_sign(self, sig_requests, sigkey, params):
        raise self.crash("injected authority crash")


class StubMinter:
    """Crypto-free minter: a 'credential' records its subset; a subset
    holding one of `corrupt_ids` fails the release gate and attribution
    names exactly those ids."""

    def __init__(self, corrupt_ids=()):
        self.corrupt_ids = set(corrupt_ids)
        self.minted_subsets = []

    def unblind(self, blind_rows, sks):
        return blind_rows

    def aggregate(self, subset, sig_rows):
        self.minted_subsets.append(tuple(subset))
        return [SimpleNamespace(subset=tuple(subset), row=list(row)) for row in sig_rows]

    def verify(self, creds, messages_list, subset):
        ok = not any(i in self.corrupt_ids for i in subset)
        return [ok] * len(creds)

    def verify_partial(self, signer_id, sig, messages):
        return signer_id not in self.corrupt_ids


def _signers(n):
    return [
        SimpleNamespace(id=i + 1, sigkey="sk%d" % (i + 1), verkey="vk%d" % (i + 1))
        for i in range(n)
    ]


def _svc(pkg, n=5, t=3, backends=None, minter=None, clk=None, **kw):
    clk = clk if clk is not None else FakeClock()
    backends = backends if backends is not None else [StubSign() for _ in range(n)]
    kw.setdefault("watchdog_interval_s", None)
    kw.setdefault(
        "watchdog",
        pkg.health.Watchdog(clock=clk, k=6.0, min_timeout_s=1.0, initial_timeout_s=5.0),
    )
    kw.setdefault(
        "hedge",
        pkg.issue.HedgePolicy(k=3.0, alpha=1.0, initial_delay_s=100.0, min_delay_s=0.0),
    )
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 2.0)
    svc = pkg.issue.IssuanceService(
        _signers(n), None, t, backends=backends,
        minter=minter if minter is not None else StubMinter(), clock=clk, **kw,
    )
    return svc, clk, backends


def _wait(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + msg
        time.sleep(0.001)


def _submit_batch(svc, n=2):
    return [svc.submit("req%d" % i, ["m%d" % i], "esk%d" % i) for i in range(n)]


def _open_fanout(svc):
    _wait(lambda: svc._tracker.outstanding(), msg="fan-out to open")
    return svc._tracker.outstanding()[0]


def _fanout(pkg, fid=0, n_requests=0):
    reqs = [SimpleNamespace(future=SimpleNamespace(done=lambda: False)) for _ in range(n_requests)]
    return pkg.quorum.Fanout(
        fid, reqs, ["sr"] * n_requests, [["m"]] * n_requests, ["sk"] * n_requests,
        pkg.trace.NOOP, 0.0,
    )


#: counters a free-running stub pool leaves to thread timing: whether a
#: row that lands after the quorum was already popped (discarded),
#: still queued (cancelled) or popped after resolution (skipped)
RACY = ("issue_partials_discarded", "issue_cancelled_signs", "issue_sign_skips")


def _counters(pkg, racy=False):
    out = pkg.metrics.snapshot()["counters"]
    if racy:
        out = {k: v for k, v in out.items() if k not in RACY}
    return out


def _release_in_order(gates, ids, f):
    """Wait until every gate's sign has started, then release `ids` one by
    one, each row landing before the next is released."""
    for g in gates:
        assert g.entered.wait(60.0)
    for sid in ids:
        gates[sid - 1].release.set()
        _wait(lambda: sid in f.partials, msg="row %d" % sid)


def _state(svc, label):
    return svc._health_of(label).state


# --- scenarios: each returns its observations --------------------------------


def hedge_policy(pkg):
    p = pkg.issue.HedgePolicy(k=3.0, alpha=0.5, initial_delay_s=9.0, min_delay_s=0.1,
                              max_delay_s=2.0)
    out = [p.ema("a"), p.budget("a")]
    p.observe("a", 0.2)
    p.observe("a", 0.4)
    out += [p.ema("a"), p.budget("a")]
    p.observe("a", 10.0)
    p.observe("b", 1e-9)
    out += [p.budget("a"), p.budget("b")]
    with pytest.raises(ValueError):
        pkg.issue.HedgePolicy(k=0.0)
    assert out[:2] == [None, 9.0] and out[4:] == [2.0, 0.1]
    return {"policy": out}


def hedge_scheduler(pkg):
    clk = FakeClock()
    sched = pkg.issue.HedgeScheduler(clock=clk)
    f1, f2 = SimpleNamespace(fid=1), SimpleNamespace(fid=2)
    sched.begin(f1, "a", 0.5, now=0.0)
    sched.begin(f1, "b", 2.0, now=0.0)
    sched.begin(f2, "a", 0.5, now=0.0)
    n0 = sched.outstanding()
    clk.advance(1.0)
    due = sorted((f.fid, label, overdue) for f, label, overdue in sched.due())
    again = sched.due()
    cancelled = sched.cancel(1)
    sched.end(2, "a")
    assert due == [(1, "a", 0.5), (2, "a", 0.5)] and again == [] and cancelled == 1
    return {"due": due, "outstanding": (n0, sched.outstanding())}


def tracker_exactly_once(pkg):
    clk = FakeClock()
    tr = pkg.issue.QuorumTracker(3, clock=clk)
    f = _fanout(pkg, n_requests=2)
    tr.open(f)
    clk.advance(0.25)
    got = [tr.record(f, 4, ["p", "p"]), tr.record(f, 1, ["p", "p"]), tr.record(f, 5, ["p", "p"])]
    got.append(tr.record(f, 2, ["p", "p"]))  # a 4th row while minting
    assert got == [None, None, [4, 1, 5], None]  # arrival order, not id order
    hist = pkg.metrics.snapshot()["histograms"]["issue_quorum_wait_s"]["count"]
    return {"got": got, "order": f.order, "quorum_at": f.quorum_at, "hist": hist,
            "counters": _counters(pkg)}


def tracker_duplicate_and_stale(pkg):
    tr = pkg.issue.QuorumTracker(2, clock=FakeClock())
    f = _fanout(pkg, n_requests=3)
    tr.open(f)
    got = [tr.record(f, 1, ["a", "b", "c"]), tr.record(f, 1, ["a", "b", "c"])]
    d1 = pkg.metrics.get_count("issue_partials_discarded")
    tr.close_fanout(f)
    got.append(tr.record(f, 2, ["a", "b", "c"]))
    assert (d1, pkg.metrics.get_count("issue_partials_discarded")) == (3, 6)
    return {"got": got, "open": len(tr.outstanding()), "counters": _counters(pkg)}


def tracker_drop_and_next(pkg):
    tr = pkg.issue.QuorumTracker(2, clock=FakeClock())
    f = _fanout(pkg, n_requests=1)
    tr.open(f)
    got = [tr.record(f, 1, ["a"]), tr.record(f, 2, ["b"])]
    tr.drop_partials(f, {1})
    got += [tr.next_subset(f), f.minting, tr.record(f, 3, ["c"])]
    assert got == [None, [1, 2], None, False, [2, 3]]
    return {"got": got, "counters": _counters(pkg)}


def first_t_wins(pkg):
    gates = [GatedSign() for _ in range(5)]
    svc, clk, _ = _svc(pkg, backends=gates)
    with svc:
        futs = _submit_batch(svc, 2)
        f = _open_fanout(svc)
        for g in gates:
            assert g.entered.wait(60.0)
        for sid in (2, 4, 5):
            gates[sid - 1].release.set()
            _wait(lambda: sid in f.partials, msg="row %d" % sid)
        subsets = [fut.result(timeout=60.0).subset for fut in futs]
        for sid in (1, 3):
            gates[sid - 1].release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 4)
    assert subsets == [(2, 4, 5)] * 2 and svc.minter.minted_subsets == [(2, 4, 5)]
    return {"subsets": subsets, "minted": svc.minter.minted_subsets, "counters": _counters(pkg)}


def ready_gate(pkg):
    svc, clk, _ = _svc(pkg)
    for auth in svc._authorities:
        svc._health_of(auth.label).on_crash("made unavailable")
    with svc:
        fut = svc.submit("req", ["m"], "esk")
        clk.advance(1.0)
        svc.kick()
        time.sleep(0.05)
        held = (svc.depth(), fut.done())
        clk.advance(10.0)
        svc.health_tick()
        minted = fut.result(timeout=60.0).subset is not None
    assert held == (1, False)
    return {"held": held, "minted": minted, "counters": _counters(pkg, racy=True)}


def hedge_fires_and_cancels(pkg):
    gates = [GatedSign() for _ in range(6)]
    svc, clk, _ = _svc(pkg, n=6, t=3, backends=gates)
    spare = svc._authorities[5]
    spare._inbox.extend([_fanout(pkg, fid=-1), _fanout(pkg, fid=-2), _fanout(pkg, fid=-3)])
    for auth in svc._authorities:
        svc.hedge_policy.observe(auth.label, 0.1)
    with svc:
        assert gates[5].entered.wait(60.0)
        futs = _submit_batch(svc, 2)
        f = _open_fanout(svc)
        _wait(lambda: len(f.targets) == 5, msg="the fan-out's dispatches")
        targets = sorted(f.targets)
        _release_in_order(gates[:5], (1, 2), f)
        clk.advance(0.5)
        svc.health_tick()
        hedged = ("6" in f.targets, spare.queued())
        gates[2].release.set()
        subsets = [fut.result(timeout=60.0).subset for fut in futs]
        _wait(lambda: pkg.metrics.get_count("issue_cancelled_signs") == 1, msg="hedge cancel")
        outstanding = svc._hedges.outstanding()
        for g in gates:
            g.release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 4)
    assert targets == ["1", "2", "3", "4", "5"] and hedged == (True, 3)
    assert pkg.metrics.get_count("issue_hedges") == 1
    assert pkg.metrics.get_count("issue_hedge_no_spare") == 2
    return {"targets": targets, "hedged": hedged, "subsets": subsets,
            "outstanding": outstanding, "counters": _counters(pkg)}


def corrupt_attribution(pkg):
    gates = [GatedSign() for _ in range(5)]
    minter = StubMinter(corrupt_ids={2})
    svc, clk, _ = _svc(
        pkg, backends=gates, minter=minter,
        health_policy=pkg.health.HealthPolicy(suspect_after=1, quarantine_after=1),
    )
    with svc:
        futs = _submit_batch(svc, 2)
        f = _open_fanout(svc)
        _release_in_order(gates, (1, 2, 3), f)
        _wait(lambda: pkg.metrics.get_count("issue_corrupt_partials") == 1, msg="attribution")
        _wait(lambda: _state(svc, "2") == pkg.health.QUARANTINED, msg="quarantine")
        states = {a.label: _state(svc, a.label) for a in svc._authorities}
        held = futs[0].done()
        gates[3].release.set()
        subsets = [fut.result(timeout=60.0).subset for fut in futs]
        gates[4].release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 2)
    assert states["2"] == pkg.health.QUARANTINED and not held
    assert minter.minted_subsets == [(1, 2, 3), (1, 3, 4)]
    return {"states": states, "subsets": subsets, "minted": minter.minted_subsets,
            "counters": _counters(pkg)}


def _survivors_mint(pkg, svc, gates, failed):
    """Authority 1 fails (`failed()` turns true once it has); the gated
    survivors 2-5 are released in the order 3, 2, 5, so the quorum is
    (3, 2, 5), and 4's row lands late. Returns the minted subsets."""
    with svc:
        futs = _submit_batch(svc, 2)
        f = _open_fanout(svc)
        _wait(failed, msg="authority 1's failure")
        for g in gates:
            assert g.entered.wait(60.0)
        for sid in (3, 2, 5):
            gates[sid - 2].release.set()
            _wait(lambda: sid in f.partials, msg="row %d" % sid)
        subsets = [fut.result(timeout=60.0).subset for fut in futs]
        gates[2].release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 2)
    assert subsets == [(3, 2, 5)] * 2
    return subsets


def sign_fault(pkg):
    gates = [GatedSign() for _ in range(4)]
    svc, clk, _ = _svc(pkg, backends=[FailingSign(pkg.errors.TransientBackendError)] + gates)
    subsets = _survivors_mint(pkg, svc, gates, lambda: _state(svc, "1") == pkg.health.SUSPECT)
    state = _state(svc, "1")
    assert state == pkg.health.SUSPECT
    return {"subsets": subsets, "state": state, "counters": _counters(pkg)}


def authority_crash(pkg):
    gates = [GatedSign() for _ in range(4)]
    svc, clk, _ = _svc(pkg, backends=[CrashingSign(pkg.faults.InjectedCrash)] + gates)
    subsets = _survivors_mint(
        pkg, svc, gates, lambda: pkg.metrics.get_count("issue_authority_crashes") == 1
    )
    worker = svc._authorities[0].has_worker()
    assert _state(svc, "1") == pkg.health.QUARANTINED and not worker
    return {"subsets": subsets, "state": _state(svc, "1"), "worker": worker,
            "counters": _counters(pkg)}


def quorum_unreachable(pkg):
    crash = pkg.faults.InjectedCrash
    backends = [CrashingSign(crash) for _ in range(3)] + [StubSign(), StubSign()]
    svc, clk, _ = _svc(pkg, backends=backends)
    with svc:
        futs = _submit_batch(svc, 2)
        excs = [fut.exception(timeout=60.0) for fut in futs]
    assert all(isinstance(e, pkg.errors.QuorumUnreachableError) for e in excs)
    return {
        # `have` and `live` depend on how many free-running rows landed
        # before the last crash
        "errors": [(type(e).__name__, e.code, e.needed, "retry" in str(e)) for e in excs],
        "minted": pkg.metrics.get_count("issue_minted"),
        "unreachable": pkg.metrics.get_count("issue_quorum_unreachable") >= 1,
        "crashes": pkg.metrics.get_count("issue_authority_crashes"),
    }


def watchdog_and_probation(pkg):
    gates = [GatedSign() for _ in range(5)]
    svc, clk, _ = _svc(pkg, backends=gates,
                       health_policy=pkg.health.HealthPolicy(probe_after_s=5.0))
    with svc:
        futs = _submit_batch(svc, 2)
        f = _open_fanout(svc)
        _release_in_order(gates, (2, 3, 4), f)
        [fut.result(timeout=60.0) for fut in futs]
        gates[4].release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 2)
        clk.advance(6.0)
        svc.health_tick()
        expired = (pkg.metrics.get_count("issue_watchdog_timeouts"), _state(svc, "1"),
                   svc._authorities[0].has_worker())
        gates[0].release.set()
        _wait(lambda: pkg.metrics.get_count("issue_partials_discarded") == 4)
        stale = _state(svc, "1")
        clk.advance(10.0)
        svc.health_tick()
        revived = svc._authorities[0].has_worker()
        futs2 = _submit_batch(svc, 2)
        again = [fut.result(timeout=60.0).subset is not None for fut in futs2]
    assert expired == (1, pkg.health.QUARANTINED, False) and revived
    return {"expired": expired, "stale": stale, "revived": revived, "again": again,
            "counters": _counters(pkg, racy=True)}


def drain_unreachable(pkg):
    gates = [GatedSign() for _ in range(3)]
    svc, clk, _ = _svc(pkg, n=3, t=3, backends=gates)
    svc.start()
    futs = _submit_batch(svc, 2)
    f = _open_fanout(svc)
    _release_in_order(gates, (1, 2), f)
    drained = svc.drain(timeout=0.5)
    outcomes = [type(fut.exception(0)).__name__ for fut in futs]
    gates[2].release.set()
    svc._authorities[2].join(5.0)
    assert drained is False and outcomes == ["QuorumUnreachableError"] * 2
    return {"drained": drained, "outcomes": outcomes, "counters": _counters(pkg)}


def shutdown_refuses_backlog(pkg):
    svc, clk, _ = _svc(pkg)
    fut = svc.submit("req", ["m"], "esk")
    svc.shutdown(drain=False, timeout=2.0)
    with pytest.raises(pkg.errors.ServiceClosedError):
        svc.submit("late", ["m"], "esk")
    return {"outcome": type(fut.exception(0)).__name__, "counters": _counters(pkg)}


def faulty_sign_seams(pkg):
    """FaultyBackend's sign schedules on a stub signer: the sign counter
    apart from the verify one, a fault, a crash, a released hang and a
    corrupt first partial (c_tilde_2 + h)."""
    inner = SimpleNamespace(batch_verify=lambda s, m, vk, p: [True] * len(s))
    fb = pkg.faults.FaultyBackend(inner, fail_sign_on={0}, crash_sign_on={1},
                                  hang_sign_on={2}, corrupt_partial_on={3})
    ops = SimpleNamespace(add=lambda a, b: ("add", a, b))
    params = SimpleNamespace(ctx=SimpleNamespace(sig=ops))
    seen = []
    fb.batch_verify([1], [[0]], None, None)
    with pytest.raises(pkg.errors.TransientBackendError):
        fb.batch_blind_sign(["r"], "sk", params)
    with pytest.raises(pkg.faults.InjectedCrash):
        fb.batch_blind_sign(["r"], "sk", params)
    fb.hang_release.set()
    fb.inner = SimpleNamespace(batch_blind_sign=lambda reqs, sk, p: (
        seen.append(len(reqs)) or [pkg.sig.BlindSignature("h%d" % i, ("c1", "c2")) for i in range(len(reqs))]
    ))
    hung = fb.batch_blind_sign(["r"], "sk", params)
    bad = fb.batch_blind_sign(["r", "s"], "sk", params)
    return {
        "counts": (fb.dispatches, fb.sign_dispatches, fb.crashes, fb.hangs,
                   fb.corrupted_partials, seen, fb.hang_entered.is_set()),
        "hung": [(b.h, b.blinded) for b in hung],
        "bad": [(b.h, b.blinded) for b in bad],
    }


SCENARIOS = {
    f.__name__: f
    for f in (
        hedge_policy, hedge_scheduler, tracker_exactly_once, tracker_duplicate_and_stale,
        tracker_drop_and_next, first_t_wins, ready_gate, hedge_fires_and_cancels,
        corrupt_attribution, sign_fault, authority_crash, quorum_unreachable,
        watchdog_and_probation, drain_unreachable, shutdown_refuses_backlog,
        faulty_sign_seams,
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_issue_mechanics_match_the_reference(name):
    got = {}
    for pkg_name in PACKAGES:
        pkg = _pkg(pkg_name)
        pkg.metrics.reset()
        try:
            got[pkg_name] = SCENARIOS[name](pkg)
        finally:
            pkg.metrics.reset()
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]


# --- real crypto: shared state -------------------------------------------------

B = 3
HIDDEN = 2
MSGS = 4  # 2 hidden, 2 known


@pytest.fixture(scope="module")
def world():
    """The JAX package's params (4 attributes), 3-of-5 signers, B ElGamal
    key pairs and message vectors from a seeded draw, beside the port's
    copies."""
    from coconut_tpu import elgamal as jelgamal
    from coconut_tpu import keygen as jkeygen
    from coconut_tpu import params as jparams

    with pytest.MonkeyPatch.context() as mp:
        seeded_randbelow(mp, 0x1550)
        jp = jparams.Params.new(MSGS, b"issue-service-test")
        _, _, jsigners = jkeygen.trusted_party_SSS_keygen(3, 5, jp)
        keys = [jelgamal.elgamal_keygen(jp.ctx.sig, jp.g) for _ in range(B)]
    rng = random.Random(0x1551)
    msgs = [[rng.randrange(R) for _ in range(MSGS)] for _ in range(B)]
    return SimpleNamespace(
        jp=jp, pp=convert.params_from(jp), jsigners=jsigners,
        signers=[convert.signer_from(s) for s in jsigners],
        esks=[sk for sk, _ in keys], epks=[pk for _, pk in keys], msgs=msgs,
    )


@pytest.fixture(scope="module")
def cpu_backend():
    return TorchBackend(device="cpu", comb_window=4)


def _seeded(monkeypatch, seed, fn, *args, **kw):
    seeded_randbelow(monkeypatch, seed)
    return fn(*args, **kw)


def _req_bytes(out, ctx):
    return [(req.to_bytes(ctx), rnd) for req, rnd in out]


def _points(sigs):
    return [(s.sigma_1, s.sigma_2) for s in sigs]


# --- the request proof of knowledge ------------------------------------------


def _prove(pkg, world, params, monkeypatch, seed=0xF5):
    """One request and its proof, drawn from `seed`: (request, proof,
    challenge, PoK)."""
    seeded_randbelow(monkeypatch, seed)
    sig = pkg.sig
    msgs, epk, esk = world.msgs[0], world.epks[0], world.esks[0]
    req, rnd = sig.SignatureRequest.new(msgs, HIDDEN, epk, params)
    pok = sig.SignatureRequestPoK.init(req, epk, params)
    c = sig.fiat_shamir_challenge(pok.to_bytes())
    return req, pok.gen_proof(msgs[:HIDDEN], rnd, esk, c), c, pok


def _mutants(pkg, proof, req):
    """(name, proof, request) of each tampered or malformed case, built
    with `pkg`'s own classes."""
    P, RP, SR = pkg.pok_vc.Proof, pkg.sig.SignatureRequestProof, pkg.sig.SignatureRequest
    sk, comm, cts = proof.proof_elgamal_sk, proof.proof_commitment, proof.proof_ciphertexts
    bump = lambda p, i: P(p.t, [(r + 1) % R if j == i else r for j, r in enumerate(p.responses)])
    swapped = SR(req.known_messages, req.commitment, req.ciphertexts[::-1])
    swapped._h_cache = req._h_cache
    (p1, p2) = cts[0]
    return [
        ("tampered_response", RP(sk, bump(comm, 0), cts), req),
        ("tampered_ciphertext_response", RP(sk, comm, [(bump(p1, 0), p2)] + cts[1:]), req),
        ("swapped_ciphertexts", proof, swapped),
        ("missing_ciphertext_proof", RP(sk, comm, cts[:-1]), req),
        ("extra_commitment_response", RP(sk, P(comm.t, comm.responses + [1]), cts), req),
        ("two_sk_responses", RP(P(sk.t, sk.responses * 2), comm, cts), req),
        ("short_proof_2", RP(sk, comm, [(p1, P(p2.t, p2.responses[:1]))] + cts[1:]), req),
        ("long_proof_1", RP(sk, comm, [(P(p1.t, p1.responses * 2), p2)] + cts[1:]), req),
        ("unlinked_message", RP(sk, comm, [(p1, bump(p2, 1))] + cts[1:]), req),
    ]


def test_request_proof_matches_the_reference(world, monkeypatch):
    """Under the same seeded draws the PoK's transcript, the proof's wire
    bytes and the rebuilt challenge transcript are byte-equal to the
    reference's; both accept; each tampered or malformed case and a wrong
    challenge are False in both; each package accepts the other's proof."""
    jpkg, tpkg = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")
    jreq, jproof, jc, jpok = _prove(jpkg, world, world.jp, monkeypatch)
    req, proof, c, pok = _prove(tpkg, world, world.pp, monkeypatch)
    ctx, jctx = world.pp.ctx, world.jp.ctx
    assert req.to_bytes(ctx) == jreq.to_bytes(jctx)
    assert pok.to_bytes() == jpok.to_bytes()
    assert c == jc
    wire = proof.to_bytes(ctx)
    assert wire == jproof.to_bytes(jctx)
    epk = world.epks[0]
    transcript = proof.to_bytes_for_challenge(req, epk, world.pp)
    assert transcript == jproof.to_bytes_for_challenge(jreq, epk, world.jp) == pok.to_bytes()
    assert proof.verify(req, epk, c, world.pp) is True
    assert jproof.verify(jreq, epk, jc, world.jp) is True
    crossed = jpkg.sig.SignatureRequestProof.from_bytes(wire, jctx)
    assert crossed.verify(jreq, epk, jc, world.jp) is True
    back = tpkg.sig.SignatureRequestProof.from_bytes(jproof.to_bytes(jctx), ctx)
    assert back.verify(req, epk, c, world.pp) is True
    verdicts = {}
    for (name, p, r), (jname, jp_, jr) in zip(_mutants(tpkg, proof, req), _mutants(jpkg, jproof, jreq)):
        verdicts[name] = (p.verify(r, epk, c, world.pp), jp_.verify(jr, epk, jc, world.jp))
    verdicts["wrong_challenge"] = (
        proof.verify(req, epk, (c + 1) % R, world.pp),
        jproof.verify(jreq, epk, (jc + 1) % R, world.jp),
    )
    verdicts["wrong_elgamal_key"] = (
        proof.verify(req, world.epks[1], c, world.pp),
        jproof.verify(jreq, world.epks[1], jc, world.jp),
    )
    assert verdicts == {k: (False, False) for k in verdicts}


def test_request_proof_decoding_matches_the_reference(world, monkeypatch):
    """from_bytes round-trips; a truncated proof, trailing bytes, a
    non-canonical response and a point off the curve raise
    DeserializationError in both packages."""
    jpkg, tpkg = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")
    req, proof, c, _ = _prove(tpkg, world, world.pp, monkeypatch)
    ctx, jctx = world.pp.ctx, world.jp.ctx
    wire = proof.to_bytes(ctx)
    back = tpkg.sig.SignatureRequestProof.from_bytes(wire, ctx)
    assert back.to_bytes(ctx) == wire
    assert back.proof_elgamal_sk.t == proof.proof_elgamal_sk.t
    assert [p.responses for pair in back.proof_ciphertexts for p in pair] == [
        p.responses for pair in proof.proof_ciphertexts for p in pair
    ]
    off_curve = bytearray(wire)
    off_curve[95] ^= 1  # the secret proof's t: y's last byte
    high = bytearray(wire)
    o = 96 + 4  # the secret proof's one response
    high[o : o + 32] = (R + 1).to_bytes(32, "big")
    cases = {
        "truncated": wire[:-1],
        "truncated_count": wire[: 2 * (96 + 4) + 32 * 4 - 1],
        "trailing": wire + b"\x00",
        "empty": b"",
        "off_curve": bytes(off_curve),
        "non_canonical_response": bytes(high),
    }
    outcomes = {}
    for name, b in cases.items():
        row = []
        for pkg, cx in ((tpkg, ctx), (jpkg, jctx)):
            with pytest.raises(pkg.errors.DeserializationError) as ei:
                pkg.sig.SignatureRequestProof.from_bytes(b, cx)
            row.append((ei.value.code, str(ei.value)))
        outcomes[name] = row
    assert all(a == b for a, b in outcomes.values())


# --- the repaired per-request forms ------------------------------------------


def test_per_request_keys_prepare_matches_the_reference(world, cpu_backend, monkeypatch):
    """batch_prepare_blind_sign with a list of B public keys, on the cpu
    TorchBackend and on the host spec, equals the reference's
    (backend="python") byte for byte under the same draws; each request's
    ciphertexts decrypt under its own key to h^m; a list of the wrong
    length is refused with the reference's message."""
    from coconut_tpu import signature as jsig
    from coconut_tpu_torch import signature as sig

    jp, pp, ctx = world.jp, world.pp, world.pp.ctx
    want = _seeded(monkeypatch, 0xB0, jsig.batch_prepare_blind_sign, world.msgs, HIDDEN,
                   list(world.epks), jp, backend="python")
    got = _seeded(monkeypatch, 0xB0, sig.batch_prepare_blind_sign, world.msgs, HIDDEN,
                  list(world.epks), pp, cpu_backend)
    spec = _seeded(monkeypatch, 0xB0, sig.batch_prepare_blind_sign, world.msgs, HIDDEN,
                   list(world.epks), pp, ps.SPEC)
    assert _req_bytes(got, ctx) == _req_bytes(spec, ctx) == _req_bytes(want, jp.ctx)
    for (req, _), msgs, esk in zip(got, world.msgs, world.esks):
        h = req.get_h(ctx)
        for (c1, c2), m in zip(req.ciphertexts, msgs):
            assert ctx.sig.sub(c2, ctx.sig.mul(c1, esk)) == ctx.sig.mul(h, m)
    with pytest.raises(sig.GeneralError) as ei:
        sig.batch_prepare_blind_sign(world.msgs, HIDDEN, world.epks[:2], pp, ps.SPEC)
    with pytest.raises(jsig.GeneralError) as jei:
        jsig.batch_prepare_blind_sign(world.msgs, HIDDEN, world.epks[:2], jp, backend="python")
    assert str(ei.value) == str(jei.value)


@pytest.fixture(scope="module")
def blind_rows(world):
    """Signer 1's blind signatures of B requests, one ElGamal key each,
    from the reference's spec path."""
    from coconut_tpu import signature as jsig

    with pytest.MonkeyPatch.context() as mp:
        seeded_randbelow(mp, 0xB1)
        jreqs = [jsig.SignatureRequest.new(m, HIDDEN, pk, world.jp)[0]
                 for m, pk in zip(world.msgs, world.epks)]
    jbs = [jsig.BlindSignature.new(r, world.jsigners[0].sigkey, world.jp) for r in jreqs]
    return jreqs, jbs


def test_per_signature_unblind_matches_the_reference(world, blind_rows, cpu_backend):
    """batch_unblind with one secret a blind signature (a list or a tuple),
    on the cpu TorchBackend, equals the reference's; each partial verifies
    under its signer's verkey; a list of the wrong length is refused with
    the reference's message."""
    from coconut_tpu import signature as jsig
    from coconut_tpu_torch import signature as sig

    jreqs, jbs = blind_rows
    ctx = world.pp.ctx
    bs = [convert.blind_signature_from(b) for b in jbs]
    want = jsig.batch_unblind(jbs, list(world.esks), world.jp.ctx, backend="python")
    got = sig.batch_unblind(bs, list(world.esks), ctx, cpu_backend)
    assert _points(got) == _points(want)
    assert _points(sig.batch_unblind(bs, tuple(world.esks), ctx, ps.SPEC)) == _points(want)
    assert _points(got) == _points([b.unblind(sk, ctx) for b, sk in zip(bs, world.esks)])
    vk = world.signers[0].verkey
    assert all(s.verify(m, vk, world.pp) for s, m in zip(got, world.msgs))
    with pytest.raises(sig.GeneralError) as ei:
        sig.batch_unblind(bs, world.esks[:2], ctx, ps.SPEC)
    with pytest.raises(jsig.GeneralError) as jei:
        jsig.batch_unblind(jbs, world.esks[:2], world.jp.ctx, backend="python")
    assert str(ei.value) == str(jei.value)


def test_signature_verify_matches_the_reference(world, blind_rows):
    """Signature.verify on the host spec: True on signer 1's partials
    under its own verkey, False under another signer's, on a bumped
    message and on a doubled sigma_2 — as the reference's."""
    from coconut_tpu import signature as jsig
    from coconut_tpu_torch import signature as sig

    _, jbs = blind_rows
    ctx = world.pp.ctx
    jparts = [b.unblind(sk, world.jp.ctx) for b, sk in zip(jbs, world.esks)]
    parts = [convert.signature_from(p) for p in jparts]
    m0 = world.msgs[0]
    bumped = [(m0[0] + 1) % R] + m0[1:]
    cases = [
        (0, m0, 1), (1, world.msgs[1], 1), (0, m0, 2), (0, bumped, 1),
    ]
    got = [parts[i].verify(m, world.signers[s - 1].verkey, world.pp) for i, m, s in cases]
    want = [jparts[i].verify(m, world.jsigners[s - 1].verkey, world.jp) for i, m, s in cases]
    doubled = sig.Signature(parts[0].sigma_1, ctx.sig.mul(parts[0].sigma_2, 2))
    jdoubled = jsig.Signature(jparts[0].sigma_1, world.jp.ctx.sig.mul(jparts[0].sigma_2, 2))
    got.append(doubled.verify(m0, world.signers[0].verkey, world.pp))
    want.append(jdoubled.verify(m0, world.jsigners[0].verkey, world.jp))
    assert got == want == [True, True, False, False, False]


# --- the service end to end ------------------------------------------------------


class _OneAtATime:
    """An authority backend whose signs take turns on one lock: on the CPU
    four threads of small torch ops run far slower together than in turn,
    and the test is about bytes, not overlap."""

    def __init__(self, inner, lock):
        self.inner = inner
        self.lock = lock

    def batch_blind_sign(self, sig_requests, sigkey, params):
        from coconut_tpu_torch.signature import batch_blind_sign

        with self.lock:
            return batch_blind_sign(sig_requests, sigkey, params, backend=self.inner)


def _mint(pkg, signers, params, backend, backends, orders):
    """One 3-of-5 service over `orders`, authority 2 crashing on its first
    sign; returns (credentials, counters, authority 2's state)."""
    pkg.metrics.reset()
    svc = pkg.issue.IssuanceService(
        signers, params, 3, backend=backend, backends=backends, max_batch=len(orders),
        max_wait_ms=5.0, health_policy=pkg.health.HealthPolicy(probe_after_s=600.0),
    )
    futs = [svc.submit(req, msgs, sk) for req, msgs, sk in orders]
    svc.start()
    try:
        creds = [f.result(timeout=120.0) for f in futs]
    finally:
        assert svc.drain(timeout=60.0)
    counters = {k: pkg.metrics.get_count(k) for k in (
        "issue_minted", "issue_authority_crashes", "issue_failed_requests",
        "issue_corrupt_partials", "issue_quorum_unreachable")}
    state = svc._health_of("2").state
    pkg.metrics.reset()
    return creds, counters, state


def test_service_mints_byte_equal_credentials(world, blind_rows, cpu_backend):
    """Five authorities, 3-of-5, B = 2, authority 2 crashing: the
    reference's service on backend="python" and the port's on the cpu
    TorchBackend mint byte-equal credentials (subset independence: any
    three partials interpolate to the same signature), each verifying
    under the aggregated verkey; the same counters."""
    from coconut_tpu import faults as jfaults
    from coconut_tpu.backend import get_backend
    from coconut_tpu_torch import faults

    jreqs, _ = blind_rows
    n = 2
    jorders = [(jreqs[i], world.msgs[i], world.esks[i]) for i in range(n)]
    orders = [(convert.request_from(r), m, sk) for r, m, sk in jorders]
    py = get_backend("python")
    jcreds, jcounts, jstate = _mint(
        _pkg("coconut_tpu"), world.jsigners, world.jp, "python",
        [py, jfaults.FaultyBackend(py, crash_sign_on=(0,)), py, py, py], jorders,
    )
    lock = threading.Lock()
    be = cpu_backend
    auth = [_OneAtATime(be, lock) for _ in range(5)]
    auth[1] = faults.FaultyBackend(auth[1], crash_sign_on=(0,))
    creds, counts, state = _mint(
        _pkg("coconut_tpu_torch"), world.signers, world.pp, be, auth, orders,
    )
    ctx = world.pp.ctx
    assert [c.to_bytes(ctx) for c in creds] == [c.to_bytes(world.jp.ctx) for c in jcreds]
    assert counts == jcounts == {
        "issue_minted": n, "issue_authority_crashes": 1, "issue_failed_requests": 0,
        "issue_corrupt_partials": 0, "issue_quorum_unreachable": 0,
    }
    assert state == jstate == "quarantined"
    from coconut_tpu_torch import signature as sig

    vk = sig.Verkey.aggregate(3, [(s.id, s.verkey) for s in world.signers[2:]], ctx)
    assert all(c.verify(m, vk, world.pp) for c, (_, m, _) in zip(creds, orders))


def test_entry_points_need_a_card_and_keylife_is_refused(world):
    """backend=None is a TorchBackend on cuda: the service, the minter and
    a backend-less authority raise here, never carry on on the CPU. The
    key lifecycle is no longer refused: keychain= takes an EpochRegistry,
    and install_keyset gives each authority its share of a KeySet and the
    service the set's threshold."""
    import torch

    from coconut_tpu_torch.issue import CryptoMinter, IssuanceService, SigningAuthority

    vks = {s.id: s.verkey for s in world.signers}
    if torch.cuda.is_available():
        svc = IssuanceService(world.signers, world.pp, 3)
        assert svc.minter.backend.device.type == "cuda"
        assert all(a.backend is svc.minter.backend for a in svc._authorities)
        assert CryptoMinter(3, vks, world.pp).backend.device.type == "cuda"
        assert SigningAuthority(None, world.signers[0]).backend.device.type == "cuda"
    else:
        for make in (
            lambda: IssuanceService(world.signers, world.pp, 3),
            lambda: CryptoMinter(3, vks, world.pp),
            lambda: SigningAuthority(None, world.signers[0]),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    from coconut_tpu_torch.keylife import EpochRegistry, KeySet

    reg = EpochRegistry()
    svc = IssuanceService(world.signers, world.pp, 3, backend="spec", keychain=reg)
    assert svc.keychain is reg
    ks = KeySet(1, 0, 2, world.signers, vk=None)
    svc.install_keyset(ks)
    assert svc.threshold == 2
    assert all(a._share_for(ks) is s.sigkey for a, s in zip(svc._authorities, world.signers))
