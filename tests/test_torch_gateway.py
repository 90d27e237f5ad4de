"""The port's fleet gateway (`coconut_tpu_torch.net`: tenant admission,
health gossip, the session-affine router, Replica and GatewayClient over a
loopback and a real socket, the loadgens' `transport="rpc"` and the state
plane's pull over the wire), against the JAX package's, on the CPU.

- Admission and gossip: the same scripts (token buckets and tenant tables
  on a fake clock, quota persisted in a StateStore, directory transitions,
  the gossip loop) run through both packages; every outcome, refill
  horizon, state and counter must agree.
- Routing on stub engines behind loopback replicas, in both packages:
  the ring's candidates, affinity, least-loaded spill, failover with the
  victim demoted, all-down raising TransientBackendError, 60 requests with
  a replica killed mid-run and zero dangling futures, the rejoin by
  beacon, a throttled tenant isolated, garbage frames answered typed, a
  draining replica handing off while it still serves state pulls.
- Across packages: the port's client drives the reference's Replica (and
  the reference's client the port's) through a loopback and through a
  real socket — the wire is one format.
- End to end: one full session (prepare -> mint, whose release verifies
  the credential -> show_prove -> show_verify, and a forged credential's
  verify) through a loopback replica over
  `TorchBackend(device="cpu")` at 3 messages, every draw from one seed:
  its verdicts and its credential's and proof's bytes equal the
  reference's session on its host spec; both loadgens with
  `transport="rpc"` report `rpc_overhead_s`; a show verified on one
  replica reaches the other through `StateReplicator` and `pull_state`,
  and its replay is refused with DoubleSpendError (nullifier restored)
  after the witness is killed, and again after the survivor reopens from
  its WAL.

Tolerance: exact — verdicts, bytes, states, counters and error fields.
"""

import importlib
import random
import secrets
from types import SimpleNamespace

import pytest
import torch

from coconut_tpu_torch import entry
from torch_show_helpers import as_jax, spec_proof, two_torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.gateway

MSGS = 3
HIDDEN = 1
REVEALED = [1, 2]
SEED = 0x6A7E


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        net=imp("net"),
        wire=imp("net.wire"),
        rpc=imp("net.rpc"),
        gossip=imp("net.gossip"),
        router=imp("net.router"),
        tenant=imp("net.tenant"),
        metrics=imp("metrics"),
        errors=imp("errors"),
        retry=imp("retry"),
        queue=imp("serve.queue"),
        loadgen=imp("serve.loadgen"),
        params=imp("params"),
        signature=imp("signature"),
        keygen=imp("keygen"),
        elgamal=imp("elgamal"),
        engine=imp("engine"),
        store=imp("state.store"),
        replicate=imp("state.replicate"),
        nullifier=imp("state.nullifier"),
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


def _same(script):
    """Run `script(pkg)` in both packages (metrics reset first) and return
    the port's record after asserting it equals the reference's."""
    out = []
    for pkg in BOTH:
        pkg.metrics.reset()
        out.append(script(pkg))
    assert out[1] == out[0]
    return out[1]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the typed refusals under test
        return (type(e).__name__, getattr(e, "code", None), getattr(e, "retry_after_s", None))


# --- admission ------------------------------------------------------------------


def test_token_bucket_refill_horizon():
    def script(pkg):
        clock = FakeClock()
        b = pkg.tenant.TokenBucket(rate_per_s=2.0, burst=2, clock=clock)
        out = [b.take(), b.take(), b.take()]
        for dt in (0.25, 0.25, 100.0, 0.0, 0.0):
            clock.advance(dt)
            out.append(b.take())
        return out

    out = _same(script)
    assert out[:3] == [0.0, 0.0, 0.5] and out[3] == pytest.approx(0.25)
    assert out[-1] > 0.0  # capped at burst


def test_tenant_admission_gates():
    def script(pkg):
        clock = FakeClock()
        table = pkg.tenant.TenantTable(clock=clock)
        table.provision("acme", "key-a", rate_per_s=1.0, burst=2, quota=3)
        table.provision("bob", "key-b")
        out = [_outcome(lambda: table.admit("key-zzz"))]
        out += [_outcome(lambda: table.admit("key-a").tenant_id) for _ in range(2)]
        out.append(_outcome(lambda: table.admit("key-a", program="verify")))
        out.append(_outcome(lambda: table.admit("key-b").tenant_id))
        clock.advance(2.0)
        out.append(_outcome(lambda: table.admit("key-a").used))
        clock.advance(10.0)
        out.append(_outcome(lambda: table.admit("key-a")))
        return out, {k: v for k, v in pkg.metrics.snapshot()["counters"].items()
                     if k.startswith("gateway_")}

    out, counters = _same(script)
    assert [o[0] for o in out] == [
        "TenantAuthError", "ok", "ok", "TenantRateLimitError", "ok", "ok", "TenantQuotaError"]
    assert out[3][2] == pytest.approx(1.0)
    assert counters["gateway_tenant_acme_admitted"] == 3
    assert counters["gateway_tenant_acme_quota_rejected"] == 1


def test_tenant_quota_persists_in_the_store(tmp_path):
    def script(pkg):
        root = str(tmp_path / pkg.name)
        store = pkg.store.StateStore(root, replica_id="r0")
        table = pkg.tenant.TenantTable(store=store)
        table.provision("greedy", "key-g", quota=3)
        table.provision("free", "key-f")
        out = [_outcome(lambda: table.admit("key-g").used) for _ in range(2)]
        out.append(_outcome(lambda: table.admit("key-f").used))
        store.close()
        store = pkg.store.StateStore(root, replica_id="r0")  # a restarted replica
        table = pkg.tenant.TenantTable(store=store)
        table.provision("greedy", "key-g", quota=3)
        out += [_outcome(lambda: table.admit("key-g").used) for _ in range(2)]
        marks = store.marks()
        store.close()
        return out, marks

    out, marks = _same(script)
    assert [o[0] for o in out] == ["ok", "ok", "ok", "ok", "TenantQuotaError"]
    assert out[3] == ("ok", 3)  # the restart did not reset the quota


def test_duplicate_api_key_rejected():
    table = PORT.tenant.TenantTable()
    table.provision("a", "same-key")
    with pytest.raises(ValueError, match="duplicate"):
        table.provision("b", "same-key")


# --- gossip ---------------------------------------------------------------------


def _beacon(pkg, rid, state="healthy", depth=0, brownout=False):
    return pkg.wire.Beacon(rid, state, 1.0, depth, brownout, 1, 1, 0.0)


def test_directory_transitions():
    def script(pkg):
        g = pkg.gossip
        d = g.HealthDirectory(["r0", "r1"], miss_threshold=2)
        seen = [d.states(), pkg.metrics.get_gauge("gateway_up_replicas")]
        for rid, kw in (("r0", {"state": "quarantined"}), ("r0", {"brownout": True}),
                        ("r0", {}), ("r1", None), ("r1", None), ("r1", {"depth": 5}),
                        ("r0", {"state": "draining"}), ("r0", {"state": "warming"}),
                        ("r0", {})):
            if kw is None:
                d.miss(rid)
            else:
                d.observe(_beacon(pkg, rid, **kw))
            seen.append((d.states(), d.routable(rid), d.usable(rid)))
        d.note_draining("r0")
        d.note_failure("r1")
        d.note_draining("r1")  # must not resurrect a DOWN replica
        seen.append(d.states())
        seen.append((d.queue_depth("r1"), d.queue_depth("rX"), d.epochs("rX"),
                     d.state_marks("r0")))
        return seen, pkg.metrics.snapshot()["counters"], pkg.metrics.get_gauge(
            "gateway_up_replicas")

    seen, counters, up = _same(script)
    assert seen[:2] == [{"r0": "warming", "r1": "warming"}, 0]
    assert seen[-2] == {"r0": "draining", "r1": "down"}
    assert counters["gateway_readmitted"] >= 1 and counters["gateway_drain_observed"] >= 1
    with pytest.raises(ValueError):
        PORT.gossip.HealthDirectory(miss_threshold=0)


def test_gossip_loop_step():
    def script(pkg):
        d = pkg.gossip.HealthDirectory(["r0", "r1"], miss_threshold=1)
        beacons = {"r0": _beacon(pkg, "r0")}

        def poll(rid):
            def _p():
                if rid not in beacons:
                    raise ConnectionError("dead")
                return beacons[rid]

            return _p

        loop = pkg.gossip.GossipLoop(d, {r: poll(r) for r in ("r0", "r1")}, clock=FakeClock())
        loop.step()
        seen = [d.states()]
        beacons["r1"] = _beacon(pkg, "r1")
        loop.step()
        seen.append(d.states())
        loop.start()
        seen.append(loop.stop(timeout=5.0))
        return seen

    assert _same(script) == [{"r0": "up", "r1": "down"}, {"r0": "up", "r1": "up"}, True]


# --- routing on stub engines ---------------------------------------------------------


class StubEngine:
    """Inline-resolving verify-only engine with a settable depth and a call
    count; `pkg` supplies the future class."""

    def __init__(self, pkg, verdict=True):
        self.pkg = pkg
        self.verdict = verdict
        self.calls = 0
        self.depth_value = 0

    def depth(self):
        return self.depth_value

    def submit_verify(self, sig, messages, lane="interactive", max_wait_ms=None):
        self.calls += 1
        fut = self.pkg.queue.ServeFuture()
        fut.set_result(self.verdict)
        return fut


@pytest.fixture(scope="module")
def codecs():
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.signature import Signature

    params = Params.new(MSGS, b"test-torch-gateway")
    jparams, _, _ = as_jax(params, SimpleNamespace(X_tilde=None, Y_tilde=[]), [])
    sigs = {PORT.name: Signature(params.g, params.g)}
    sigs[REF.name] = REF.signature.Signature(params.g, params.g)
    return SimpleNamespace(
        codec={PORT.name: PORT.wire.WireCodec(params), REF.name: REF.wire.WireCodec(jparams)},
        sig=sigs, params=params, jparams=jparams,
    )


def _stub_fleet(pkg, codecs, n=3, tenants=None):
    replicas, transports, clients = {}, {}, {}
    codec = codecs.codec[pkg.name]
    for i in range(n):
        rid = "r%d" % i
        rep = pkg.rpc.Replica(StubEngine(pkg), codec, tenants=tenants, replica_id=rid)
        transports[rid] = pkg.rpc.LoopbackTransport(rep)
        replicas[rid] = rep
        clients[rid] = pkg.rpc.GatewayClient(transports[rid], codec, api_key="key-a")
    router = pkg.router.ReplicaRouter(
        clients,
        retry_policy=pkg.retry.RetryPolicy(
            max_attempts=n + 1, base_delay=0.0, jitter=0.0,
            retryable=(pkg.errors.TransientBackendError, pkg.errors.ServiceClosedError),
            sleep=lambda s: None,
        ),
    )
    return router, replicas, transports


def test_session_affinity_and_spread(codecs):
    def script(pkg):
        router, replicas, _ = _stub_fleet(pkg, codecs)
        sig = codecs.sig[pkg.name]
        out = {}
        for session in ("alpha", "beta", "gamma"):
            primary = router.candidates(session)[0]
            placed = []
            for _ in range(5):
                fut = router.submit_verify(sig, [1], session=session)
                placed.append((fut.replica_id == primary, fut.result(5.0)))
            out[session] = (router.candidates(session), placed)
        for i in range(48):
            router.bound("s%d" % i).submit_verify(sig, [1]).result(5.0)
        out["calls"] = {rid: rep.engine.calls for rid, rep in replicas.items()}
        return out

    out = _same(script)
    assert sum(1 for c in out["calls"].values() if c) >= 2
    assert all(placed == [(True, True)] * 5 for _, placed in
               (out[s] for s in ("alpha", "beta", "gamma")))


def test_demoted_primary_spills_least_loaded(codecs):
    def script(pkg):
        router, _, _ = _stub_fleet(pkg, codecs)
        ring = router.candidates("sticky")
        d = router.directory
        d.observe(_beacon(pkg, ring[0], state="quarantined"))
        d.observe(_beacon(pkg, ring[1], depth=7))
        d.observe(_beacon(pkg, ring[2], depth=2))
        chosen = [router.route("sticky")]
        d.observe(_beacon(pkg, ring[0]))
        chosen.append(router.route("sticky"))
        return [ring.index(c) for c in chosen], {
            k: pkg.metrics.get_count(k) for k in ("gateway_spills", "gateway_affinity_hits")}

    assert _same(script) == ([2, 0], {"gateway_spills": 1, "gateway_affinity_hits": 1})


def test_failover_settles_on_survivor(codecs):
    def script(pkg):
        router, _, transports = _stub_fleet(pkg, codecs)
        primary = router.candidates("doomed")[0]
        transports[primary].kill()
        fut = router.submit_verify(codecs.sig[pkg.name], [1], session="doomed")
        return (fut.result(5.0), fut.replica_id != primary, router.directory.state(primary),
                pkg.metrics.get_count("gateway_failovers"))

    assert _same(script) == (True, True, "down", 1)


def test_all_replicas_down_raises_typed(codecs):
    def script(pkg):
        router, _, transports = _stub_fleet(pkg, codecs)
        for t in transports.values():
            t.kill()
        fut = router.submit_verify(codecs.sig[pkg.name], [1], session="x")
        return _outcome(lambda: fut.result(5.0))[:2], fut.exception(5.0).__class__.__name__

    assert _same(script) == (("TransientBackendError", "transient"), "TransientBackendError")


def test_fleet_chaos_zero_dangling_futures(codecs):
    def script(pkg):
        router, replicas, transports = _stub_fleet(pkg, codecs)
        loop = router.gossip_loop(clock=FakeClock())
        sig = codecs.sig[pkg.name]
        victim = router.candidates("sess-0")[0]
        futures = []
        for i in range(60):
            if i == 20:
                transports[victim].kill()
            futures.append(router.submit_verify(sig, [1], session="sess-%d" % (i % 7)))
        outcomes = [_outcome(lambda f=f: f.result(5.0)) for f in futures]
        dangling = sum(not f.done() for f in futures)
        loop.step()
        after_kill = router.directory.state(victim)
        transports[victim].revive()
        loop.step()
        before = replicas[victim].engine.calls
        for _ in range(5):
            router.submit_verify(sig, [1], session="sess-0").result(5.0)
        return (outcomes, dangling, after_kill, router.directory.state(victim),
                replicas[victim].engine.calls - before)

    outcomes, dangling, after_kill, rejoined, returned = _same(script)
    assert outcomes == [("ok", True)] * 60 and dangling == 0
    assert (after_kill, rejoined, returned) == ("down", "up", 5)


def test_tenant_rate_limit_over_the_wire(codecs):
    def script(pkg):
        clock = FakeClock()
        tenants = pkg.tenant.TenantTable(clock=clock)
        tenants.provision("slow", "key-slow", rate_per_s=1.0, burst=1)
        tenants.provision("fast", "key-fast")
        codec = codecs.codec[pkg.name]
        t = pkg.rpc.LoopbackTransport(pkg.rpc.Replica(StubEngine(pkg), codec, tenants=tenants))
        slow = pkg.rpc.GatewayClient(t, codec, api_key="key-slow")
        fast = pkg.rpc.GatewayClient(t, codec, api_key="key-fast")
        stranger = pkg.rpc.GatewayClient(t, codec, api_key="key-none")
        sig = codecs.sig[pkg.name]
        out = [_outcome(lambda: slow.submit_verify(sig, [1]).result(5.0)) for _ in range(2)]
        out += [_outcome(lambda: fast.submit_verify(sig, [1]).result(5.0)) for _ in range(3)]
        out.append(_outcome(lambda: stranger.submit_verify(sig, [1]).result(5.0)))
        clock.advance(1.5)
        out.append(_outcome(lambda: slow.submit_verify(sig, [1]).result(5.0)))
        return out

    out = _same(script)
    assert out == [("ok", True), ("TenantRateLimitError", "tenant_rate_limited", 1.0)] + [
        ("ok", True)] * 3 + [("TenantAuthError", "tenant_auth", None), ("ok", True)]


def test_unknown_program_and_garbage_frames(codecs):
    def script(pkg):
        wire = pkg.wire
        rep = pkg.rpc.Replica(StubEngine(pkg), codecs.codec[pkg.name], replica_id="rg")
        out = []
        for frame in (wire.encode_frame(0x3F, b"", seq=9), b"\x00" * wire.HEADER_BYTES,
                      wire.encode_frame(0x01, b"\x07", seq=4)):
            msg_type, seq, payload = wire.decode_frame(rep.handle_frame(frame))
            err = wire.decode_error(payload)
            out.append((msg_type, seq, type(err).__name__))
        rep.close()
        out.append(_outcome(lambda: rep.handle_frame(wire.encode_frame(0x20, b""))))
        return out, pkg.metrics.get_count("gateway_wire_errors")

    out, wire_errors = _same(script)
    assert [o[:2] for o in out[:3]] == [(0x7F, 9), (0x7F, 0), (0x7F, 4)]
    assert out[3][0] == "ConnectionError" and wire_errors == 3


def test_draining_replica_hands_off_and_serves_state_pulls(codecs, tmp_path):
    """A draining replica refuses program requests with a retryable
    ServiceClosedError (the router hands the request to a ring successor
    and notes DRAINING), still answers beacons as "draining" and still
    serves state pulls; once closed it refuses both."""

    def script(pkg):
        router, replicas, transports = _stub_fleet(pkg, codecs, n=2)
        store = pkg.store.StateStore(str(tmp_path / pkg.name), replica_id="r0")
        store.put_many("nullifier/0", [("aa", 1), ("bb", 1)])
        replicas["r0"].engine.state_store = store
        client = router.clients["r0"]
        sess = [s for s in ("d%d" % k for k in range(64)) if router.candidates(s)[0] == "r0"][0]
        replicas["r0"]._draining = True
        fut = router.submit_verify(codecs.sig[pkg.name], [1], session=sess)
        out = [fut.result(5.0), fut.replica_id, router.directory.state("r0"),
               client.poll_beacon().state,
               [(r["k"], r["s"]) for r in client.pull_state("nullifier/0", "r0", 0)],
               [(r["k"], r["s"]) for r in client.pull_state("nullifier/0", "r0", 1, limit=5)]]
        replicas["r0"].close()
        out.append(_outcome(lambda: client.poll_beacon()))
        out.append(pkg.metrics.get_count("gateway_drain_handoffs"))
        store.close()
        return out

    out = _same(script)
    assert out[:6] == [True, "r1", "draining", "draining", [("aa", 1), ("bb", 2)], [("bb", 2)]]
    assert out[6][0] == "TransientBackendError" and out[7] == 1


@pytest.mark.parametrize("transport", ["loopback", "socket"])
@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port_client", "ref_client"])
def test_one_wire_across_packages(codecs, transport, client_pkg, server_pkg):
    """One package's client drives the other's replica: verdicts, beacons,
    typed tenant refusals and state pulls cross in both directions."""
    tenants = server_pkg.tenant.TenantTable()
    tenants.provision("acme", "key-a")
    rep = server_pkg.rpc.Replica(
        StubEngine(server_pkg, verdict=False), codecs.codec[server_pkg.name], tenants=tenants,
        replica_id="x")
    if transport == "socket":
        rep.serve()
        t = client_pkg.rpc.SocketTransport(rep.address)
    else:
        t = client_pkg.rpc.LoopbackTransport(rep)
    codec = codecs.codec[client_pkg.name]
    sig = codecs.sig[client_pkg.name]
    try:
        ok = client_pkg.rpc.GatewayClient(t, codec, api_key="key-a")
        bad = client_pkg.rpc.GatewayClient(t, codec, api_key="key-b")
        assert ok.submit_verify(sig, [1, 2, 3]).result(10.0) is False
        with pytest.raises(client_pkg.errors.TenantAuthError):
            bad.submit(sig, [1]).result(10.0)
        b = ok.poll_beacon()
        assert (b.replica_id, b.state, b.executors) == ("x", "healthy", 0)
        assert ok.pull_state("nullifier/0", "x", 0) == []
    finally:
        t.close()
        rep.close()
    if transport == "socket":
        with pytest.raises(client_pkg.errors.TransientBackendError):
            ok.submit_verify(sig, [1]).result(10.0)


def test_socket_replica_kill_fails_every_pending_future(codecs):
    """A real socket: requests parked on an engine that never answers all
    fail with TransientBackendError the moment the replica closes."""

    class Parked(StubEngine):
        def submit_verify(self, sig, messages, lane="interactive", max_wait_ms=None):
            self.calls += 1
            return PORT.queue.ServeFuture()

    rep = PORT.rpc.Replica(Parked(PORT), codecs.codec[PORT.name], replica_id="p")
    rep.serve()
    t = PORT.rpc.SocketTransport(rep.address)
    client = PORT.rpc.GatewayClient(t, codecs.codec[PORT.name])
    futs = [client.submit_verify(codecs.sig[PORT.name], [1]) for _ in range(8)]
    assert client.poll_beacon().replica_id == "p"  # every request has reached the engine
    rep.close()
    outs = [type(f.exception(10.0)).__name__ for f in futs]
    assert outs == ["TransientBackendError"] * 8 and t.dead


# --- end to end on real engines --------------------------------------------------------


def _seeded(seed):
    saved = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    return saved


def _session_over_loopback(pkg, backend):
    """Keys, an engine, a loopback replica with a tenant table; one full
    session and a forged credential. Every draw from SEED."""
    saved = _seeded(SEED)
    try:
        params = pkg.params.Params.new(MSGS, b"test-torch-gateway-e2e")
        # 2-of-2 keeps the mint to two blind signatures on the CPU
        _, _, signers = pkg.keygen.trusted_party_SSS_keygen(2, 2, params)
        esk, epk = pkg.elgamal.elgamal_keygen(params.ctx.sig, params.g)
        msgs = [secrets.randbelow(1 << 250) for _ in range(MSGS)]
        eng = pkg.engine.ProtocolEngine(
            signers, params, 2, count_hidden=HIDDEN, revealed_msg_indices=REVEALED,
            backend=backend, devices=1, max_batch=1, max_wait_ms=5.0, watchdog_interval_s=None,
        ).start()
        codec = pkg.wire.WireCodec(params)
        tenants = pkg.tenant.TenantTable()
        tenants.provision("acme", "key-acme")
        rep = pkg.rpc.Replica(eng, codec, tenants=tenants, replica_id="r0")
        client = pkg.rpc.GatewayClient(
            pkg.rpc.LoopbackTransport(rep), codec, api_key="key-acme", session="e2e")
        try:
            beacon = client.poll_beacon()
            sig_req, _ = client.submit_prepare(msgs, epk).result(300.0)
            cred = client.submit_mint(sig_req, msgs, esk).result(300.0)
            proof, challenge, revealed = client.submit_show_prove(cred, msgs).result(300.0)
            forged = pkg.signature.Signature(params.g, params.g)
            # the credential itself passed the mint's verify-before-release
            futs = [client.submit_verify(forged, msgs),
                    client.submit_show_verify(proof, revealed, challenge)]
            verdicts = [f.result(300.0) for f in futs]
        finally:
            eng.drain(timeout=120.0)
    finally:
        secrets.randbelow = saved
    ctx = params.ctx
    return SimpleNamespace(
        beacon=(beacon.state, beacon.executors), verdicts=verdicts,
        bytes=(sig_req.to_bytes(ctx), cred.to_bytes(ctx), proof.to_bytes(ctx), challenge,
               revealed),
    )


def test_full_session_over_loopback_matches_the_reference():
    from coconut_tpu_torch.gpu.backend import TorchBackend

    port = _session_over_loopback(PORT, TorchBackend(device="cpu", comb_window=4))
    ref = _session_over_loopback(REF, "python")
    assert port.verdicts == ref.verdicts == [False, True]
    assert port.beacon == ref.beacon == ("healthy", 1)
    assert port.bytes == ref.bytes


@pytest.fixture(scope="module")
def spec_engine():
    """A port ProtocolEngine on its host spec backend (loadgen runs)."""
    from coconut_tpu_torch.backend import SpecBackend
    from coconut_tpu_torch.elgamal import elgamal_keygen
    from coconut_tpu_torch.keygen import trusted_party_SSS_keygen
    from coconut_tpu_torch.params import Params
    from coconut_tpu_torch.sss import rand_fr

    with entry.seeded_draws(SEED + 1):
        params = Params.new(MSGS, b"test-torch-gateway-loadgen")
        _, _, signers = trusted_party_SSS_keygen(2, 3, params)
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        msgs = [rand_fr() for _ in range(MSGS)]
    eng = PORT.engine.ProtocolEngine(
        signers, params, 2, count_hidden=HIDDEN, revealed_msg_indices=REVEALED,
        backend=SpecBackend(), devices=1, max_batch=4, max_wait_ms=5.0,
        watchdog_interval_s=None,
    ).start()
    sig_req, _ = eng.submit_prepare(msgs, epk).result(120.0)
    cred = eng.submit_mint(sig_req, msgs, esk).result(120.0)
    yield SimpleNamespace(eng=eng, params=params, codec=PORT.wire.WireCodec(params),
                          msgs=msgs, esk=esk, epk=epk, cred=cred)
    eng.drain(timeout=60.0)


class _RefVerifier:
    """A reference-package client whose every verify is True at once: the
    reference's report keys, for comparison."""

    def submit(self, sig, messages, lane="interactive", max_wait_ms=None):
        fut = REF.queue.ServeFuture()
        fut.set_result(True)
        return fut

    def submit_prepare(self, messages, elgamal_pk, lane="bulk", max_wait_ms=None):
        raise REF.errors.GeneralError("no session on the key probe")


def test_loadgen_rpc_transport(spec_engine):
    w = spec_engine
    rep = PORT.rpc.Replica(w.eng, w.codec, replica_id="lg")
    client = PORT.rpc.GatewayClient(PORT.rpc.LoopbackTransport(rep), w.codec)
    forged = PORT.signature.Signature(w.params.g, w.params.g)
    report = PORT.loadgen.run_loadgen(
        client, [(w.cred, w.msgs, True), (forged, w.msgs, False)], duration_s=0.4,
        concurrency=2, transport="rpc", rng=random.Random(3),
    )
    assert report["transport"] == "rpc"
    assert report["completed"] > 0 and report["errors"] == 0
    assert report["dropped_futures"] == 0 and report["verdict_mismatches"] == 0
    assert report["rpc_overhead_s"] is not None and report["rpc_overhead_s"] >= 0.0
    ref = REF.loadgen.run_loadgen(_RefVerifier(), [(None, None, True)], duration_s=0.05,
                                  concurrency=1, transport="rpc")
    assert set(report) == set(ref)


def test_session_loadgen_rpc_through_a_router(spec_engine):
    """run_session_loadgen(transport="rpc") over a two-replica router: each
    session is bound to its ring primary; the report has the reference's
    keys and rpc_overhead_s."""
    w = spec_engine
    reps = {rid: PORT.rpc.Replica(w.eng, w.codec, replica_id=rid) for rid in ("a", "b")}
    router = PORT.router.ReplicaRouter({
        rid: PORT.rpc.GatewayClient(PORT.rpc.LoopbackTransport(rep), w.codec)
        for rid, rep in reps.items()})
    router.gossip_loop(clock=FakeClock()).step()
    report = PORT.loadgen.run_session_loadgen(
        router, [(w.msgs, w.epk, w.esk)], duration_s=0.5, concurrency=2, transport="rpc",
        rng=random.Random(5),
    )
    assert report["transport"] == "rpc"
    assert report["sessions_completed"] > 0
    assert report["errors"] == 0 and report["failed_shows"] == 0
    assert report["rpc_overhead_s"] is not None
    assert PORT.metrics.get_count("gateway_affinity_hits") >= 4 * report["sessions_completed"]
    ref = REF.loadgen.run_session_loadgen(_RefVerifier(), [(None, None, None)], duration_s=0.05,
                                          concurrency=1, transport="rpc")
    assert set(report) == set(ref) and set(report["per_program"]) == set(ref["per_program"])


def _state_fleet(pkg, root, shows):
    """Two ProtocolEngines with StateStores behind loopback replicas, a
    gossip directory and a replicator on the survivor pulling from the
    witness; then the witness verifies show 0, the survivor pulls it, the
    witness is killed, the replay goes to the survivor, and the survivor
    reopened from its WAL refuses it again."""
    params, vk, proofs, rms, chals = shows[pkg.name]
    if pkg is PORT:
        from coconut_tpu_torch.backend import SpecBackend

        backend = SpecBackend()
        backend.device = torch.device("cpu")
    else:
        backend = "python"
    signers = [SimpleNamespace(id=i, sigkey=None, verkey=None) for i in (1, 2, 3)]
    codec = pkg.wire.WireCodec(params)

    def engine(store):
        return pkg.engine.ProtocolEngine(
            signers, params, 2, count_hidden=1, revealed_msg_indices=list(entry.SHOW_REVEALED),
            vk=vk, backend=backend, devices=1, max_batch=1, max_wait_ms=5.0,
            watchdog_interval_s=None, state_store=store,
        ).start()

    stores = {rid: pkg.store.StateStore(str(root / pkg.name / rid), replica_id=rid)
              for rid in ("w", "s")}
    engines = {rid: engine(st) for rid, st in stores.items()}
    replicas = {rid: pkg.rpc.Replica(e, codec, replica_id=rid) for rid, e in engines.items()}
    clients = {rid: pkg.rpc.GatewayClient(pkg.rpc.LoopbackTransport(r), codec)
               for rid, r in replicas.items()}
    directory = pkg.gossip.HealthDirectory()
    loop = pkg.gossip.GossipLoop(directory, {r: c.poll_beacon for r, c in clients.items()})
    puller = pkg.replicate.StateReplicator(stores["s"], directory, {"w": clients["w"]})
    out = []
    try:
        out.append(clients["w"].submit_show_verify(proofs[0], rms[0], chals[0]).result(120.0))
        digest = pkg.nullifier.nullifier_of(proofs[0], chals[0], None, params)
        out.append(stores["s"].seen("nullifier/0", digest))
        loop.step()
        out.append(directory.state_marks("w"))
        puller.step()
        out.append(stores["s"].seen("nullifier/0", digest))
        replicas["w"].close()
        clients["w"].close()
        replay = clients["s"].submit_show_verify(proofs[0], rms[0], chals[0])
        err = replay.exception(120.0)
        out.append((type(err).__name__, err.nullifier == digest, err.wire_retryable))
        out.append(clients["s"].submit_show_verify(proofs[1], rms[1], chals[1]).result(120.0))
        engines["s"].drain(timeout=60.0)
        stores["s"].close()
        stores["s"] = pkg.store.StateStore(str(root / pkg.name / "s"), replica_id="s")
        engines["s"] = engine(stores["s"])
        reborn = pkg.rpc.GatewayClient(
            pkg.rpc.LoopbackTransport(pkg.rpc.Replica(engines["s"], codec, replica_id="s")), codec)
        err = reborn.submit_show_verify(proofs[1], rms[1], chals[1]).exception(120.0)
        out.append((type(err).__name__, err.nullifier == pkg.nullifier.nullifier_of(
            proofs[1], chals[1], None, params)))
        out.append(sorted(stores["s"].keys("nullifier/0")) == sorted(
            [digest, pkg.nullifier.nullifier_of(proofs[1], chals[1], None, params)]))
        counters = {k: pkg.metrics.get_count(k) for k in (
            "gateway_state_pulls", "state_antientropy_pulls", "nullifier_double_spends")}
    finally:
        for e in engines.values():
            e.drain(timeout=60.0)
        for st in stores.values():
            st.close()
    return out, counters


def test_state_pull_and_replay_refused_over_the_wire(tmp_path):
    params, _, vk, proofs, rms, chals = entry.show_fixture(2, seed=0x6A7E)
    jparams, jvk, _ = as_jax(params, vk, [])
    shows = {PORT.name: (params, vk, proofs, rms, chals),
             REF.name: (jparams, jvk, [spec_proof(p) for p in proofs], rms, chals)}
    out, counters = _same(lambda pkg: _state_fleet(pkg, tmp_path, shows))
    assert out[0] is True and out[1] is False and out[3] is True
    assert out[2] == (("nullifier/0", "w", 1),)
    assert out[4] == ("DoubleSpendError", True, False)
    assert out[5] is True and out[6] == ("DoubleSpendError", True) and out[7] is True
    assert counters == {"gateway_state_pulls": 1, "state_antientropy_pulls": 1,
                        "nullifier_double_spends": 2}
