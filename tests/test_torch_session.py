"""The port's ProtocolEngine (`coconut_tpu_torch.engine.ProtocolEngine`, the
phase programs, the multi-program pool, `run_session_loadgen`) and the
batch entry points' backend names, against the JAX package's, on the CPU.

- Backend names: the seven batch entry points at B = 1 with
  `backend="python"` give the reference's bits and points; "torch" is a
  TorchBackend on `cuda` (raises here), an unknown name the reference's
  ValueError.
- Five programs on one pool: the same scripted sessions (prepare -> mint ->
  verify / show_prove -> show_verify, four users a hop, one forged show,
  then one injected executor crash) run through both packages'
  ProtocolEngine on stub backends and stub protocol functions with a fake
  clock; outcomes, per-program counters, the containment of the crash and
  the "%ns_jit_shapes" counters (flat after the warm-up round) must agree.
- The epoch rollover drill, in the port only, on `backend="python"` (the
  host spec): DKG with a corrupt dealer, sessions, a refresh and a reshare
  with mints in flight, wrong-epoch and retired-epoch refusals; then the
  same drill joined with its RPC and gossip half, as the reference runs
  it: every request through a GatewayClient over a loopback Replica, the
  epochs read from beacons, the refusals typed through the envelope.
- run_session_loadgen on the stub engine: sessions complete, no failed
  show, the reference's report keys.

Tolerance: exact — verdicts, points and counters.
"""

import importlib
import random
import secrets
from types import SimpleNamespace

import pytest

from torch_show_helpers import two_torch_threads  # noqa: F401 (autouse)

PACKAGES = ("coconut_tpu", "coconut_tpu_torch")


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        engine=imp("engine"),
        faults=imp("faults"),
        health=imp("serve.health"),
        loadgen=imp("serve.loadgen"),
        signature=imp("signature"),
        pok_sig=imp("pok_sig"),
        ps=imp("ps"),
        params=imp("params"),
        keygen=imp("keygen"),
        elgamal=imp("elgamal"),
        backend=imp("backend"),
    )


# --- repair: backend names ------------------------------------------------------


def _issuance_state(pkg):
    """Params, 2-of-3 dealer keys and one ElGamal key pair, seeded."""
    saved = secrets.randbelow
    secrets.randbelow = random.Random(0xBAC).randrange
    try:
        params = pkg.params.Params.new(3, b"test-torch-session-names")
        _, _, signers = pkg.keygen.trusted_party_SSS_keygen(2, 3, params)
        esk, epk = pkg.elgamal.elgamal_keygen(params.ctx.sig, params.g)
    finally:
        secrets.randbelow = saved
    return params, signers, esk, epk


def _seeded(fn, seed):
    saved = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    try:
        return fn()
    finally:
        secrets.randbelow = saved


def _names_round(pkg, backend):
    """The seven batch entry points at B = 1 under one backend name."""
    sig = pkg.signature
    params, signers, esk, epk = _issuance_state(pkg)
    ctx = params.ctx
    msgs = [[11, 22, 33]]
    ((req, _),) = _seeded(
        lambda: sig.batch_prepare_blind_sign(msgs, 1, epk, params, backend=backend), 1
    )
    blinded = [sig.batch_blind_sign([req], s.sigkey, params, backend=backend)[0] for s in signers[:2]]
    unblinded = sig.batch_unblind(blinded, esk, ctx, backend=backend)
    (cred,) = sig.batch_aggregate(2, [list(zip((1, 2), unblinded))], ctx, backend=backend)
    vk = sig.Verkey.aggregate(2, [(s.id, s.verkey) for s in signers[:2]], ctx=ctx)
    forged = sig.Signature(cred.sigma_1, ctx.sig.mul(cred.sigma_2, 2))
    bits = pkg.ps.batch_verify([cred, forged], msgs * 2, vk, params, backend=backend)
    proofs, chals, revealed = _seeded(
        lambda: pkg.pok_sig.batch_show([cred], vk, params, msgs, {0}, backend=backend), 2
    )
    show_bits = pkg.ps.batch_show_verify(proofs, vk, params, revealed, chals, backend=backend)
    p = proofs[0]
    return {
        "request": req.to_bytes(ctx),
        "blinded": [b.to_bytes(ctx) for b in blinded],
        "unblinded": [(u.sigma_1, u.sigma_2) for u in unblinded],
        "credential": (cred.sigma_1, cred.sigma_2),
        "verify_bits": [bool(b) for b in bits],
        "proof": (p.sigma_prime_1, p.sigma_prime_2, p.J, p.proof_vc.t, p.proof_vc.responses, chals),
        "show_bits": [bool(b) for b in show_bits],
    }


def test_batch_entry_points_resolve_backend_names():
    """Each of ps.batch_verify, ps.batch_show_verify, pok_sig.batch_show and
    the four issuance batch functions takes `backend="python"` (and
    "spec") and gives the reference's "python" outputs at B = 1."""
    ref = _names_round(_pkg("coconut_tpu"), "python")
    port = _pkg("coconut_tpu_torch")
    assert _names_round(port, "python") == ref
    assert _names_round(port, "spec") == ref
    assert ref["verify_bits"] == [True, False] and ref["show_bits"] == [True]


def test_backend_names_torch_and_unknown():
    """"torch" resolves to a TorchBackend on `cuda` in every entry point
    (RuntimeError here, where there is no card; never AttributeError on a
    string), and an unknown name raises the reference's ValueError."""
    import torch

    port, ref = _pkg("coconut_tpu_torch"), _pkg("coconut_tpu")
    sig = port.signature
    params, signers, esk, epk = _issuance_state(port)
    ctx = params.ctx
    msgs = [[11, 22, 33]]
    ((req, _),) = sig.batch_prepare_blind_sign(msgs, 1, epk, params, backend="spec")
    blinded = [sig.batch_blind_sign([req], s.sigkey, params, backend="spec")[0] for s in signers[:2]]
    partials = list(zip((1, 2), sig.batch_unblind(blinded, esk, ctx, backend="spec")))
    (cred,) = sig.batch_aggregate(2, [partials], ctx, backend="spec")
    vk = sig.Verkey.aggregate(2, [(s.id, s.verkey) for s in signers[:2]], ctx=ctx)
    proofs, chals, revealed = port.pok_sig.batch_show([cred], vk, params, msgs, {0}, backend="spec")
    calls = [
        lambda b: sig.batch_prepare_blind_sign(msgs, 1, epk, params, backend=b),
        lambda b: sig.batch_blind_sign([req], signers[0].sigkey, params, backend=b),
        lambda b: sig.batch_unblind(blinded, esk, ctx, backend=b),
        lambda b: sig.batch_aggregate(2, [partials], ctx, backend=b),
        lambda b: port.ps.batch_verify([cred], msgs, vk, params, backend=b),
        lambda b: port.ps.batch_show_verify(proofs, vk, params, revealed, chals, backend=b),
        lambda b: port.pok_sig.batch_show([cred], vk, params, msgs, {0}, backend=b),
    ]
    if not torch.cuda.is_available():
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call("torch")
    for call in calls:
        with pytest.raises(ValueError) as ei:
            call("nope")
        with pytest.raises(ValueError) as ej:
            ref.backend.get_backend("nope")
        assert str(ei.value) == str(ej.value)


# --- five programs on one pool, on stubs ------------------------------------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class StubBackend:
    """Verify bits from a flag on each credential; partial-signature tokens
    for the authorities."""

    def batch_verify(self, sigs, msgs, vk, params):
        return [s.sigma_1 is not None and bool(getattr(s, "ok", False)) for s in sigs]

    def batch_blind_sign(self, sig_requests, sigkey, params):
        return [("partial", sigkey, req) for req in sig_requests]


class StubMinter:
    def unblind(self, blind_rows, sks):
        return blind_rows

    def aggregate(self, subset, sig_rows):
        return [SimpleNamespace(sigma_1=1, sigma_2=1, ok=True) for _ in sig_rows]

    def verify(self, creds, messages_list, subset):
        return [True] * len(creds)

    def verify_partial(self, signer_id, sig, messages):
        return True


def _stub_prepare(messages_list, count_hidden, pks, params, backend=None):
    return [(("request", tuple(m), pk), [0] * (1 + count_hidden)) for m, pk in zip(messages_list, pks)]


def _stub_show(sigs, vk, params, messages_list, revealed, backend=None):
    proofs = [SimpleNamespace(ok=bool(getattr(s, "ok", False)), revealed_msg_indices=set(revealed))
              for s in sigs]
    return proofs, [7] * len(sigs), [{i: m[i] for i in revealed} for m in messages_list]


def _stub_show_verify(proofs, vk, params, revealed_list, challenges=None, backend=None,
                      mode="exact", epoch=None):
    return [p.ok for p in proofs]


def _stub_world(pkg, monkeypatch, clock, **kw):
    """A ProtocolEngine over stubs: the protocol functions the phase
    programs import are replaced before the pool is seeded."""
    monkeypatch.setattr(pkg.signature, "batch_prepare_blind_sign", _stub_prepare)
    monkeypatch.setattr(pkg.pok_sig, "batch_show", _stub_show)
    monkeypatch.setattr(pkg.ps, "batch_show_verify", _stub_show_verify)
    signers = [SimpleNamespace(id=i, sigkey="sk%d" % i, verkey="vk%d" % i) for i in (1, 2, 3)]
    kw.setdefault("watchdog_interval_s", None)
    kw.setdefault("watchdog", pkg.health.Watchdog(clock=clock, k=2.0, min_timeout_s=1.0,
                                                  initial_timeout_s=1.0))
    kw.setdefault("health_policy", pkg.health.HealthPolicy(probe_after_s=5.0, probe_successes=1))
    return pkg.engine.ProtocolEngine(
        signers, None, 2, count_hidden=1, revealed_msg_indices=[1], vk="VK",
        minter=StubMinter(), max_batch=4, max_wait_ms=2.0, clock=clock, **kw
    )


#: counters that depend on the scenario only (which authorities' partials
#: arrive first, and which executor takes a batch, are the threads')
_COMPARED = (
    "prep_done", "prep_batches", "prep_batched_requests", "prep_admitted",
    "prove_done", "prove_batches", "prove_batched_requests", "prove_admitted",
    "showv_valid", "showv_invalid", "showv_batches", "showv_admitted",
    "serve_valid", "serve_invalid", "serve_batches", "serve_admitted",
    "serve_pad_lanes", "prep_pad_lanes", "prove_pad_lanes", "showv_pad_lanes",
    "issue_minted", "issue_batches", "issue_batched_requests",
    "serve_executor_crashes", "serve_redistributed_batches",
)
_NS = ("serve", "prep", "prove", "showv")


def _session_scenario(pkg, monkeypatch):
    clock = FakeClock()
    faulty = pkg.faults.FaultyBackend(StubBackend())
    eng = _stub_world(pkg, monkeypatch, clock, backend=faulty, devices=2).start()
    users = [([u, u + 1, u + 2], "pk%d" % u, "sk%d" % u) for u in range(4)]
    out = {}
    try:
        def round_trip(tag, crash):
            prepared = [f.result(30.0) for f in [eng.submit_prepare(m, pk) for m, pk, _ in users]]
            creds = [f.result(30.0) for f in [
                eng.submit_mint(req, m, sk) for (req, _), (m, _, sk) in zip(prepared, users)
            ]]
            if crash:
                # one executor-loop crash on the next verify dispatch
                faulty.crash_on = frozenset({faulty.dispatches})
            vfuts = [eng.submit_verify(c, m) for c, (m, _, _) in zip(creds, users)]
            pfuts = [eng.submit_show_prove(c, m) for c, (m, _, _) in zip(creds, users)]
            verdicts = [f.result(30.0) for f in vfuts]
            proofs = [f.result(30.0) for f in pfuts]
            forged = SimpleNamespace(ok=False, revealed_msg_indices={1})
            shows = [f.result(30.0) for f in [
                eng.submit_show_verify(forged if i == 2 else p, rev, c)
                for i, (p, c, rev) in enumerate(proofs)
            ]]
            out[tag] = {
                "prepared": [r[0] for r in prepared],
                "minted": len(creds),
                "verdicts": verdicts,
                "revealed": [p[2] for p in proofs],
                "shows": shows,
                "jit": {ns: pkg.metrics.get_count("%s_jit_shapes" % ns) for ns in _NS},
            }

        round_trip("warm", crash=False)
        round_trip("crash", crash=True)
        # a partial verify batch flushes at drain
        tail = [eng.submit_verify(SimpleNamespace(sigma_1=1, sigma_2=1, ok=b), [0]) for b in (True, False)]
    finally:
        assert eng.drain(timeout=30.0)
    out["tail"] = [f.result(0) for f in tail]
    out["crashes"] = faulty.crashes
    out["counters"] = {k: pkg.metrics.get_count(k) for k in _COMPARED}
    out["programs"] = sorted(eng._runtimes)
    out["seeded"] = [sorted(ex._prog_dispatch) for ex in eng._executors]
    return out


def test_protocol_engine_five_programs_match_the_reference(monkeypatch):
    got = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        pkg.metrics.reset()
        try:
            got[name] = _session_scenario(pkg, monkeypatch)
        finally:
            pkg.metrics.reset()
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    assert port["programs"] == ["mint", "prepare", "show_prove", "show_verify", "verify"]
    assert port["seeded"] == [["prepare", "show_prove", "show_verify"]] * 2
    for tag in ("warm", "crash"):
        assert port[tag]["verdicts"] == [True] * 4
        assert port[tag]["shows"] == [True, True, False, True]
    # the crash was contained and its batch redistributed; no program's
    # shape count moved after the warm-up round
    assert port["crashes"] == 1
    assert port["counters"]["serve_executor_crashes"] == 1
    assert port["counters"]["serve_redistributed_batches"] >= 1
    assert port["crash"]["jit"] == port["warm"]["jit"]
    assert port["tail"] == [True, False]


def test_session_engine_refusals(tmp_path):
    """`state_store=` and `nullifiers=` are accepted now that the port has
    `state/`: the engine builds its guard on the backend's device (cpu
    here) and hands it to show-verify; an unknown show-verify mode still
    refuses."""
    import torch

    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.engine.phases import ShowVerifyProgram
    from coconut_tpu_torch.state import NullifierGuard, StateStore

    signers = [SimpleNamespace(id=i, sigkey=None, verkey=None) for i in (1, 2)]
    be = StubBackend()
    be.device = torch.device("cpu")
    store = StateStore(str(tmp_path / "s"))
    eng = ProtocolEngine(signers, None, 2, 1, [0], vk="VK", backend=be, state_store=store,
                         dead_letter_path=str(tmp_path / "dead.jsonl"))
    assert eng._showv.nullifiers is eng.nullifiers and eng.nullifiers.device.type == "cpu"
    assert eng._showv.dead_letters.store is store
    guard = NullifierGuard(store, use_device=False)
    assert ShowVerifyProgram("VK", None, backend=be, nullifiers=guard).nullifiers is guard
    with pytest.raises(ValueError, match="unknown show-verify mode"):
        ShowVerifyProgram("VK", None, backend=StubBackend(), mode="bogus")
    store.close()


def test_session_loadgen_on_the_stub_engine(monkeypatch):
    """One second of closed-loop sessions on each package's stub engine:
    sessions complete, no show fails, and the report's keys (and each
    program's) are the reference's."""
    reports = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        pkg.metrics.reset()
        eng = _stub_world(pkg, monkeypatch, __import__("time").monotonic, backend=StubBackend())
        eng.start()
        pool = [([u, u + 1, u + 2], "pk%d" % u, "sk%d" % u) for u in range(8)]
        try:
            reports[name] = pkg.loadgen.run_session_loadgen(
                eng, pool, duration_s=1.0 if name == "coconut_tpu_torch" else 0.3,
                concurrency=4, rng=random.Random(5), result_timeout=30.0,
            )
        finally:
            assert eng.drain(timeout=30.0)
            pkg.metrics.reset()
    ref, port = reports["coconut_tpu"], reports["coconut_tpu_torch"]
    assert sorted(port) == sorted(ref)
    assert sorted(port["per_program"]) == sorted(ref["per_program"])
    assert sorted(port["per_program"]["mint"]) == sorted(ref["per_program"]["mint"])
    assert port["sessions_completed"] > 0
    assert port["failed_shows"] == 0 and port["errors"] == 0
    assert port["arrival"] == "closed" and port["transport"] == "direct"
    assert all(p["completed"] >= port["sessions_completed"] for p in port["per_program"].values())


# --- the epoch rollover drill, in the port -----------------------------------------


def _tamper_one(dealer, recipient, dim=0):
    def tamper(d, r, dm, share):
        if (d, r, dm) == (dealer, recipient, dim):
            return (share[0] + 1, share[1])
        return None

    return tamper


def test_epoch_rollover_drill():
    """The reference's rollover drill without its RPC and gossip parts, on
    the host spec: a 5-authority engine bootstraps by DKG (the corrupt
    dealer named and excluded), serves full sessions, takes one proactive
    refresh and one t/n reshare with mints in flight, and every
    pre-rollover credential verifies post-rollover under its mint epoch.
    No dangling future, no leaked pin; a wrong epoch verifies False; an
    unknown or retired epoch refuses typed."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.elgamal import elgamal_keygen
    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.errors import EpochRetiredError, EpochUnknownError
    from coconut_tpu_torch.keylife import ACTIVE, RETIRING, KeyLifecycleManager
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.sss import rand_fr

    msgs_n = 2
    metrics.reset()
    params = Params.new(msgs_n, b"test-keylife")
    mgr = KeyLifecycleManager(params, label=b"keylife-drill", window=3)

    # 1) DKG with a corrupt dealer: named exactly, excluded, round lands
    ks1 = mgr.bootstrap(3, 5, tamper=_tamper_one(2, 4))
    assert mgr.last_round.complaints == {2: (4,)}
    assert ks1.excluded == (2,)
    eng = ProtocolEngine(
        [ks1.signer(i) for i in range(1, 6)], params, 3, count_hidden=1,
        revealed_msg_indices=[1], vk=ks1.vk, backend="python", devices=1,
        max_batch=4, max_wait_ms=5.0, keychain=mgr.registry,
        # no background health tick: under a loaded test run a host spec
        # batch can outlast k times the pool's EMA of fast prepare batches
        watchdog_interval_s=None,
    ).start()
    mgr.attach(eng)
    assert mgr.registry.live_epochs() == [(1, ACTIVE)]
    settled = []

    def mint_one():
        msgs = [rand_fr() for _ in range(msgs_n)]
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        sig_req, _ = eng.submit_prepare(msgs, epk).result(120.0)
        cred = eng.submit_mint(sig_req, msgs, esk).result(120.0)
        settled.append(cred)
        return cred, msgs

    def full_show(cred, msgs):
        proof, chal, rev = eng.submit_show_prove(cred, msgs).result(120.0)
        # the explicit challenge and the stranger-verifier re-hash
        assert eng.submit_show_verify(proof, rev, chal, epoch=cred.epoch).result(120.0) is True
        assert eng.submit_show_verify(proof, rev, None, epoch=cred.epoch).result(120.0) is True

    try:
        pre = [mint_one() for _ in range(3)]
        assert all(c.epoch == 1 for c, _ in pre)
        full_show(*pre[0])

        # 2) proactive refresh with mints in flight
        inflight_msgs = [rand_fr() for _ in range(msgs_n)]
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        sig_req, _ = eng.submit_prepare(inflight_msgs, epk).result(120.0)
        inflight = [eng.submit_mint(sig_req, inflight_msgs, esk) for _ in range(4)]
        before = {s.id: (s.sigkey.x, tuple(s.sigkey.y)) for s in ks1.signers}
        ks1r = mgr.refresh()
        assert ks1r.vk.to_bytes(params.ctx) == ks1.vk.to_bytes(params.ctx)
        after = {s.id: (s.sigkey.x, tuple(s.sigkey.y)) for s in ks1r.signers}
        assert all(before[i] != after[i] for i in before)
        for f in inflight:
            cred = f.result(120.0)
            assert cred.epoch == 1
            assert eng.submit_verify(cred, inflight_msgs).result(120.0) is True
        mid = [mint_one() for _ in range(2)]
        assert all(c.epoch == 1 for c, _ in mid)

        # 3) t/n reshare (3-of-5 -> 2-of-5) with mints in flight
        inflight = [eng.submit_mint(sig_req, inflight_msgs, esk) for _ in range(4)]
        ks2 = mgr.reshare(threshold=2, total=5)
        assert ks2.epoch == 2
        assert ks2.vk.to_bytes(params.ctx) != ks1.vk.to_bytes(params.ctx)
        for f in inflight:
            cred = f.result(120.0)
            assert cred.epoch in (1, 2)
            assert eng.submit_verify(cred, inflight_msgs).result(120.0) is True
        assert mgr.registry.live_epochs() == [(1, RETIRING), (2, ACTIVE)]

        # 4) every pre-rollover credential verifies under its mint epoch
        for cred, msgs in pre + mid:
            assert eng.submit_verify(cred, msgs).result(120.0) is True
        full_show(*mid[0])
        post = [mint_one() for _ in range(2)]
        assert all(c.epoch == 2 for c, _ in post)
        full_show(*post[0])

        # 5) a wrong epoch verifies False
        cred, msgs = pre[0]
        cred.epoch = 2
        assert eng.submit_verify(cred, msgs).result(120.0) is False

        # 6) an unknown epoch refuses typed at submit
        cred.epoch = 42
        with pytest.raises(EpochUnknownError):
            eng.submit_verify(cred, msgs)
        cred.epoch = 1

        # 7) two more reshares retire epoch 1
        ks3 = mgr.reshare()
        ks4 = mgr.reshare()
        assert (ks3.epoch, ks4.epoch) == (3, 4)
        assert mgr.registry.live_epochs() == [(2, RETIRING), (3, RETIRING), (4, ACTIVE)]
        with pytest.raises(EpochRetiredError) as ei:
            eng.submit_verify(cred, msgs)
        assert "live epochs: [2, 3, 4]" in str(ei.value)
        with pytest.raises(EpochRetiredError):
            eng.submit_show_verify(None, {}, epoch=1)
        assert eng.submit_verify(post[0][0], post[0][1]).result(120.0) is True
    finally:
        assert eng.drain(timeout=60.0)

    assert len(settled) == 7
    for e in (1, 2, 3, 4):
        assert mgr.registry.pin_count(e) == 0
    assert metrics.get_count("keylife_refreshes") == 1
    assert metrics.get_count("keylife_reshares") == 3
    assert metrics.get_count("keylife_retirements") == 1
    assert metrics.get_count("issue_failed_requests") == 0
    metrics.reset()


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_epoch_rollover_drill_over_rpc_and_gossip():
    """The reference's rollover drill whole (tests/test_keylife.py
    test_epoch_rollover_chaos_drill), over the port's wire: every request
    goes through GatewayClient(LoopbackTransport(net.rpc.Replica)), and a
    GossipLoop stepped by hand reads the replica's epochs from its beacons.
    Fewer credentials a step than the reference's, so it stays inside 20 s
    alone on the host spec. A wrong epoch verifies False; an unknown epoch
    and, after window pressure retires epoch 1, a retired one refuse typed
    through the wire's error envelope, the live epochs named. Every wait
    has its own timeout; nothing sleeps."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.elgamal import elgamal_keygen
    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.errors import EpochRetiredError, EpochUnknownError
    from coconut_tpu_torch.keylife import ACTIVE, RETIRING, KeyLifecycleManager
    from coconut_tpu_torch.net import gossip, rpc, wire
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.sss import rand_fr

    msgs_n = 2
    metrics.reset()
    params = Params.new(msgs_n, b"test-keylife")
    mgr = KeyLifecycleManager(params, label=b"keylife-drill-rpc", window=3)

    # 1) DKG with a corrupt dealer: named exactly, excluded, round lands
    ks1 = mgr.bootstrap(3, 5, tamper=_tamper_one(2, 4))
    assert mgr.last_round.complaints == {2: (4,)}
    assert ks1.excluded == (2,)
    eng = ProtocolEngine(
        [ks1.signer(i) for i in range(1, 6)], params, 3, count_hidden=1,
        revealed_msg_indices=[1], vk=ks1.vk, backend="python", devices=1,
        max_batch=4, max_wait_ms=5.0, keychain=mgr.registry,
        watchdog_interval_s=None,
    ).start()
    mgr.attach(eng)
    codec = wire.WireCodec(params)
    client = rpc.GatewayClient(rpc.LoopbackTransport(rpc.Replica(eng, codec, replica_id="r0")), codec)
    directory = gossip.HealthDirectory(["r0"])
    loop = gossip.GossipLoop(
        directory, {"r0": lambda: client.poll_beacon(timeout=5.0)}, clock=_FakeClock()
    )
    loop.step()
    assert directory.epochs("r0") == ((1, ACTIVE),)
    settled = []

    def mint_one():
        msgs = [rand_fr() for _ in range(msgs_n)]
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        sig_req, _ = client.submit_prepare(msgs, epk).result(60.0)
        cred = client.submit_mint(sig_req, msgs, esk).result(60.0)
        settled.append(cred)
        return cred, msgs

    def full_show(cred, msgs):
        proof, chal, rev = client.submit_show_prove(cred, msgs).result(60.0)
        # the explicit challenge and the stranger-verifier re-hash
        assert client.submit_show_verify(proof, rev, chal, epoch=cred.epoch).result(60.0) is True
        assert client.submit_show_verify(proof, rev, None, epoch=cred.epoch).result(60.0) is True

    try:
        pre = [mint_one() for _ in range(2)]
        assert all(c.epoch == 1 for c, _ in pre)  # stamped over the wire
        full_show(*pre[0])

        # 2) proactive refresh with mints in flight on the engine
        inflight_msgs = [rand_fr() for _ in range(msgs_n)]
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        sig_req, _ = eng.submit_prepare(inflight_msgs, epk).result(60.0)
        inflight = [eng.submit_mint(sig_req, inflight_msgs, esk) for _ in range(2)]
        before = {s.id: (s.sigkey.x, tuple(s.sigkey.y)) for s in ks1.signers}
        ks1r = mgr.refresh()
        assert ks1r.vk.to_bytes(params.ctx) == ks1.vk.to_bytes(params.ctx)
        after = {s.id: (s.sigkey.x, tuple(s.sigkey.y)) for s in ks1r.signers}
        assert all(before[i] != after[i] for i in before)
        for f in inflight:
            cred = f.result(60.0)
            assert cred.epoch == 1
            assert client.submit_verify(cred, inflight_msgs).result(60.0) is True
        mid = [mint_one()]
        assert mid[0][0].epoch == 1

        # 3) t/n reshare (3-of-5 -> 2-of-5) with mints in flight
        inflight = [eng.submit_mint(sig_req, inflight_msgs, esk) for _ in range(2)]
        ks2 = mgr.reshare(threshold=2, total=5)
        assert ks2.epoch == 2
        assert ks2.vk.to_bytes(params.ctx) != ks1.vk.to_bytes(params.ctx)
        for f in inflight:
            cred = f.result(60.0)
            assert cred.epoch in (1, 2)
            assert client.submit_verify(cred, inflight_msgs).result(60.0) is True
        loop.step()
        assert directory.epochs("r0") == ((1, RETIRING), (2, ACTIVE))

        # 4) every pre-rollover credential verifies under its mint epoch
        for cred, msgs in pre + mid:
            assert client.submit_verify(cred, msgs).result(60.0) is True
        post = [mint_one()]
        assert post[0][0].epoch == 2
        full_show(*post[0])

        # 5) a wrong epoch verifies False, not an error
        cred, msgs = pre[0]
        cred.epoch = 2
        assert client.submit_verify(cred, msgs).result(60.0) is False

        # 6) an unknown epoch refuses typed through the error envelope
        cred.epoch = 42
        with pytest.raises(EpochUnknownError):
            client.submit_verify(cred, msgs).result(60.0)
        cred.epoch = 1

        # 7) window pressure: two more reshares retire epoch 1, whose
        # credentials then refuse typed over the wire
        ks3 = mgr.reshare()
        ks4 = mgr.reshare()
        assert (ks3.epoch, ks4.epoch) == (3, 4)
        loop.step()
        assert directory.epochs("r0") == ((2, RETIRING), (3, RETIRING), (4, ACTIVE))
        with pytest.raises(EpochRetiredError) as ei:
            client.submit_verify(cred, msgs).result(60.0)
        assert "live epochs: [2, 3, 4]" in str(ei.value)
        assert client.submit_verify(*post[0]).result(60.0) is True
    finally:
        assert eng.drain(timeout=60.0)

    assert len(settled) == 4  # every RPC mint settled exactly once
    for e in (1, 2, 3, 4):
        assert mgr.registry.pin_count(e) == 0
    assert metrics.get_count("gateway_errors") == 0
    assert metrics.get_count("keylife_refreshes") == 1
    assert metrics.get_count("keylife_reshares") == 3
    assert metrics.get_count("keylife_retirements") == 1
    metrics.reset()
