"""The port's ProtocolEngine with a state store — the nullifier guard on the
show-verify lane, the store-indexed dead-letter log, the executor-health
and epoch journals, `CredentialService(state_store=...)` — against the
JAX package's, on the CPU.

- Replays: B = 4 shows (entry.show_fixture, 6 attributes, {2, 3, 4, 5}
  revealed) verified on `TorchBackend(device="cpu", comb_window=4)` by the
  port and on the host spec by the reference, each over its own
  StateStore: the first batch is accepted, the replayed batch resolves to
  DoubleSpendError carrying the reference's nullifier hex, the schema-4
  dead-letter lines match field for field, and an engine restarted over
  the same directory still refuses a replay.
- Degraded paths: a probe that raises moves detection to commit time and
  counts `nullifier_probe_errors`; a WAL fsync that fails during the
  commit fails every accepted lane with TransientBackendError and counts
  `nullifier_commit_errors` — in both packages alike.
- Journals: an EpochRegistry over a store restores the reference's epochs
  and retirements; ExecutorHealth's `snapshot_record` and `restore`, and
  the engine's `attach_health_journal`, equal the reference's after the
  same transitions.
- `CredentialService(state_store=...)` keeps the store, as the reference's
  does (the parent of this port raised TypeError); DoubleSpendError's
  message round trip recovers its fields as the reference's does.

Tolerance: exact — verdicts, error types, digests, lines and counters.
"""

import importlib
import os
from types import SimpleNamespace

import pytest

from coconut_tpu_torch import entry
from coconut_tpu_torch.gpu.backend import TorchBackend
from torch_show_helpers import as_jax, spec_proof, two_torch_threads  # noqa: F401 (autouse)

B = 4
HOLD_MS = 600000.0  # a batch flushes when B requests are queued, or at drain
COUNTERS = (
    "nullifier_commits", "nullifier_double_spends", "nullifier_probe_hits",
    "nullifier_probe_errors", "nullifier_commit_errors", "showv_valid", "showv_invalid",
)


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        engine=imp("engine"),
        errors=imp("errors"),
        faults=imp("faults"),
        health=imp("serve.health"),
        service=imp("serve.service"),
        store=imp("state.store"),
        nullifier=imp("state.nullifier"),
        epoch=imp("keylife.epoch"),
    )


REF, PORT = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")


@pytest.fixture(scope="module")
def world():
    """2 * B valid shows, as the port's holders and the JAX package's
    objects, and one cpu TorchBackend shared by the module's engines."""
    params, _, vk, proofs, rms, chals = entry.show_fixture(2 * B, seed=0x57A7E)
    jparams, jvk, _ = as_jax(params, vk, [])
    return SimpleNamespace(
        shows={
            "coconut_tpu_torch": (params, vk, proofs),
            "coconut_tpu": (jparams, jvk, [spec_proof(p) for p in proofs]),
        },
        rms=rms,
        chals=chals,
        backend=TorchBackend(device="cpu", comb_window=4),
    )


def _engine(pkg, world, store, dlq=None):
    params, vk, _ = world.shows[pkg.name]
    signers = [SimpleNamespace(id=i, sigkey=None, verkey=None) for i in (1, 2, 3)]
    return pkg.engine.ProtocolEngine(
        signers, params, 2, count_hidden=1, revealed_msg_indices=list(entry.SHOW_REVEALED),
        vk=vk, backend=world.backend if pkg is PORT else "python", devices=1,
        max_batch=B, max_wait_ms=HOLD_MS, watchdog_interval_s=None,
        state_store=store, dead_letter_path=dlq,
    )


def _submit(eng, world, pkg, lanes, **kw):
    _, _, proofs = world.shows[pkg.name]
    return [
        eng.submit_show_verify(proofs[i], world.rms[i], world.chals[i], **kw) for i in lanes
    ]


def _outcomes(futs):
    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(120.0)))
        except Exception as e:  # the typed refusals under test
            out.append((type(e).__name__, getattr(e, "nullifier", None), getattr(e, "epoch", None)))
    return out


def _counters(pkg):
    return {k: pkg.metrics.get_count(k) for k in COUNTERS}


def _digests(pkg, world, lanes):
    params, _, proofs = world.shows[pkg.name]
    return [pkg.nullifier.nullifier_of(proofs[i], world.chals[i], None, params) for i in lanes]


# --- replays, dead letters, restart ---------------------------------------------


def _replay_script(pkg, world, root):
    pkg.metrics.reset()
    dlq = os.path.join(root, "dead.jsonl")
    store = pkg.store.StateStore(os.path.join(root, "s"), replica_id="rA")
    eng = _engine(pkg, world, store, dlq)
    fresh = _submit(eng, world, pkg, range(B))  # one full batch, queued before start
    eng.start()
    try:
        first = _outcomes(fresh)
        replay = _outcomes(_submit(eng, world, pkg, range(B)))
    finally:
        assert eng.drain(timeout=120.0)
    fsyncs = pkg.metrics.get_count("wal_fsyncs")
    indexed = len(store.keys("deadletter"))
    store.close()
    # a restart over the same directory: the WAL replays, the replay is refused
    store = pkg.store.StateStore(os.path.join(root, "s"), replica_id="rA")
    eng = _engine(pkg, world, store).start()
    try:
        restarted = _outcomes(_submit(eng, world, pkg, [1], max_wait_ms=1.0))
    finally:
        assert eng.drain(timeout=120.0)
    seen = [eng.nullifiers.seen(d) for d in _digests(pkg, world, range(2 * B))]
    store.close()
    lines = pkg.faults.DeadLetterLog.read(dlq)
    return {
        "first": first, "replay": replay, "restarted": restarted, "seen": seen,
        "lines": lines, "indexed": indexed, "fsyncs": fsyncs, "counters": _counters(pkg),
    }


def test_replays_are_refused_as_the_reference(world, tmp_path):
    got = {}
    for pkg in (REF, PORT):
        got[pkg.name] = _replay_script(pkg, world, str(tmp_path / pkg.name))
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    digests = _digests(PORT, world, range(B))
    assert digests == _digests(REF, world, range(B))
    assert port["first"] == [("ok", True)] * B
    assert port["replay"] == [("DoubleSpendError", d, None) for d in digests]
    assert port["restarted"] == [("DoubleSpendError", digests[1], None)]
    assert port["seen"] == [True] * B + [False] * B
    assert [(r["schema"], r["reason"], r["program"], r["nullifier"], r["credential"])
            for r in port["lines"]] == [(4, "double_spend", "show_verify", d, i)
                                        for i, d in enumerate(digests)]
    assert port["indexed"] == B and port["fsyncs"] == 1  # one group commit
    assert port["counters"]["nullifier_commits"] == B
    # the restart's lone replay is padded to B lanes by cloning it, and
    # every lane of the batch is probed
    assert port["counters"]["nullifier_probe_hits"] == 2 * B


# --- degraded paths -------------------------------------------------------------


def _probe_failure_script(pkg, world, root):
    """The first B shows already spent; the engine's probe raises."""
    pkg.metrics.reset()
    store = pkg.store.StateStore(root, replica_id="rA")
    pkg.nullifier.NullifierGuard(store, use_device=False).commit(_digests(pkg, world, range(B)))
    eng = _engine(pkg, world, store)

    def broken_probe(*args, **kw):
        raise RuntimeError("probe unavailable")

    eng.nullifiers.probe = broken_probe
    futs = _submit(eng, world, pkg, range(B))
    eng.start()
    try:
        out = _outcomes(futs)
    finally:
        assert eng.drain(timeout=120.0)
    store.close()
    return out, _counters(pkg)


def test_probe_failure_degrades_to_commit_time(world, tmp_path):
    got = {pkg.name: _probe_failure_script(pkg, world, str(tmp_path / pkg.name))
           for pkg in (REF, PORT)}
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    out, counters = got["coconut_tpu_torch"]
    assert out == [("DoubleSpendError", d, None) for d in _digests(PORT, world, range(B))]
    assert counters["nullifier_probe_errors"] == 1 and counters["nullifier_probe_hits"] == 0
    assert counters["nullifier_double_spends"] == B  # every lane refused at commit
    assert counters["nullifier_commits"] == B  # the setup commit alone


def _commit_failure_script(pkg, world, root):
    pkg.metrics.reset()
    chaos = pkg.faults.WalChaos(fsync_fail_on={0})
    store = pkg.store.StateStore(root, replica_id="rA", chaos=chaos)
    eng = _engine(pkg, world, store)
    futs = _submit(eng, world, pkg, range(B, 2 * B))
    eng.start()
    try:
        out = [(type(e).__name__, isinstance(e, pkg.errors.TransientBackendError))
               for e in (f.exception(120.0) for f in futs)]
    finally:
        assert eng.drain(timeout=120.0)
    seen = [eng.nullifiers.seen(d) for d in _digests(pkg, world, range(B, 2 * B))]
    store.close()
    return out, seen, _counters(pkg)


def test_failed_commit_fails_lanes_retryably(world, tmp_path):
    got = {pkg.name: _commit_failure_script(pkg, world, str(tmp_path / pkg.name))
           for pkg in (REF, PORT)}
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    out, seen, counters = got["coconut_tpu_torch"]
    assert out == [("TransientBackendError", True)] * B and seen == [False] * B
    assert counters["nullifier_commit_errors"] == 1 and counters["nullifier_commits"] == 0


# --- journals -------------------------------------------------------------------


def _registry_script(pkg, root):
    store = pkg.store.StateStore(root, replica_id="rA")
    reg = pkg.epoch.EpochRegistry(window=2, store=store)
    retired = []
    reg.add_retire_hook(retired.append)
    for e in (1, 2, 3, 4):
        reg.register(pkg.epoch.KeySet(e, 0, 2, [], "vk%d" % e))
        reg.activate(e)
    live = reg.live_epochs()
    store.close()
    store = pkg.store.StateStore(root, replica_id="rA")
    again = pkg.epoch.EpochRegistry(window=2, store=store)
    restored = {
        "next": again.next_epoch(),
        "retired": sorted(again._retired),
        "journal": {k: store.get("epoch", k) for k in sorted(store.keys("epoch"))},
    }
    try:
        again.resolve(1)
        restored["resolve1"] = None
    except Exception as e:
        restored["resolve1"] = type(e).__name__
    store.close()
    return live, retired, restored


def test_epoch_registry_journal_restores_as_the_reference(tmp_path):
    got = {pkg.name: _registry_script(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)}
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    live, retired, restored = got["coconut_tpu_torch"]
    assert retired == [1, 2] and restored["retired"] == [1, 2] and restored["next"] == 5
    assert restored["journal"]["4"] == {"event": "active"}
    assert restored["resolve1"] == "EpochRetiredError"


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _health_script(pkg, root):
    clock = _Clock()
    policy = pkg.health.HealthPolicy(probe_after_s=5.0, probe_successes=1)
    journal = []
    h = pkg.health.ExecutorHealth("0", policy, clock=clock,
                                  journal=lambda label, rec: journal.append((label, rec)))
    for _ in range(3):
        h.on_failure("boom")
    clock.t += 6.0
    h.try_probation()
    h.on_failure("boom again")  # re-quarantine: the cooldown escalates
    rec = h.snapshot_record()
    fresh = pkg.health.ExecutorHealth("1", policy, clock=clock)
    fresh.restore(rec)
    # the engine's journal: a breaker's transitions land in the store, and
    # a new engine over the same store seeds its breaker from them
    store = pkg.store.StateStore(root, replica_id="rA")
    eng = pkg.engine.ExecutionEngine(name="t", clock=clock, health_policy=policy,
                                     watchdog_interval_s=None)
    eng.attach_health_journal(store)
    for _ in range(3):
        eng._health_of("0").on_failure("boom")
    stored = store.get("health", "0")
    store.close()
    store = pkg.store.StateStore(root, replica_id="rA")
    eng2 = pkg.engine.ExecutionEngine(name="t", clock=clock, health_policy=policy,
                                      watchdog_interval_s=None)
    eng2.attach_health_journal(store)
    seeded = eng2._health_of("0").snapshot_record()
    store.close()
    return rec, fresh.snapshot_record(), fresh.state, journal, stored, seeded


def test_health_journal_matches_the_reference(tmp_path):
    got = {pkg.name: _health_script(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)}
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    rec, restored, state, journal, stored, seeded = got["coconut_tpu_torch"]
    assert rec["quarantines"] == 2 and rec["cooldown_s"] > 5.0
    assert state == "quarantined" and len(journal) == len(rec["history"])
    assert stored["state"] == "quarantined" and seeded["state"] == "quarantined"


# --- the service's store, the error's round trip -------------------------------


class _StubBackend:
    def batch_verify(self, sigs, msgs, vk, params):
        return [True] * len(sigs)


def test_credential_service_takes_a_state_store(tmp_path):
    for pkg in (REF, PORT):
        store = pkg.store.StateStore(str(tmp_path / pkg.name))
        svc = pkg.service.CredentialService(_StubBackend(), None, None, max_batch=4,
                                            watchdog_interval_s=None, state_store=store)
        assert svc.state_store is store
        assert not hasattr(svc, "nullifiers") or svc.nullifiers is None
        svc.drain(timeout=5.0)
        store.close()


def test_double_spend_error_round_trips_its_message():
    digest = "ab" * 32
    got = {}
    for pkg in (REF, PORT):
        cls = pkg.errors.DoubleSpendError
        rows = []
        for args in ((digest, 3, "ecash"), (digest, None, None), (digest, 7, None), (None, None, None)):
            err = cls(*args)
            back = cls.__new__(cls)
            pkg.errors.CoconutError.__init__(back, str(err))
            back._restore_wire_fields(str(err))
            rows.append((err.code, str(err), back.nullifier, back.epoch, back.domain))
        got[pkg.name] = rows
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    assert got["coconut_tpu_torch"][0][2:] == (digest, 3, "ecash")
    assert got["coconut_tpu_torch"][3][2] is None
