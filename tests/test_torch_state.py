"""The port's durable state plane (`coconut_tpu_torch.state`: the WAL, the
StateStore, the nullifier set and its membership probe, the replicator,
the chaos schedules of `faults.py`) against the JAX package's
`coconut_tpu.state`, on the CPU.

- Framing and files: `frame_record` / `scan_frames` give equal bytes and
  equal scans, torn tails included; the WAL each package writes for the
  same appends is byte-identical, rotated segments too; each package's
  WAL and snapshot replay in the other's StateStore to the same image,
  marks and per-origin logs.
- Store semantics: last-writer-wins ties resolve as the reference's
  whatever the apply order.
- Crash points: the four WalChaos crash points, a torn write and an fsync
  failure, one parametrised test: the keys acknowledged before the kill
  and the replayed image equal the reference's under the same schedule.
- Derivations: `nullifier_of` (v1 and v2, with a domain and with a tag),
  `spend_tag_of` and `keyspace_of` are hex-equal for shows each package
  proves from one seed.
- Limb tables and the probe: `digests_to_limbs` and `build_table` give
  equal arrays; `membership_probe` on CPU tensors (the plain version)
  equals the reference run with `xp=jax.numpy` on tables of 0, 1, 2, 3,
  1,000, 4,096 and 4,097 rows, with queries below and above every row,
  one bit off a spent digest in the last limb, and limbs with the top
  bit set.
- The guard: `commit` (accept mask, intra-batch duplicates, replays),
  `probe`, `seen` and `retire_epoch` counts equal the reference's.
- The replicator heals a partitioned pull under ReplicationChaos with
  duck-typed clients, step for step as the reference's.

Tolerance: exact — bytes, arrays, masks and counters.
"""

import hashlib
import importlib
import json
import os
import random
import secrets
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp

from torch_show_helpers import two_torch_threads  # noqa: F401 (autouse)



def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        faults=imp("faults"),
        state=imp("state"),
        wal=imp("state.wal"),
        store=imp("state.store"),
        nullifier=imp("state.nullifier"),
        replicate=imp("state.replicate"),
    )


REF, PORT = _pkg("coconut_tpu"), _pkg("coconut_tpu_torch")


def _payloads(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(0, 300, size=n)]


def _read_all(root):
    """{file name: bytes} of every file under `root`."""
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def _image(store):
    """A StateStore's whole in-memory image: data, marks, per-origin logs."""
    return {
        "data": {ks: dict(sp) for ks, sp in store._data.items()},
        "marks": store.marks(),
        "log": {"%s|%s" % k: list(v) for k, v in store._log.items()},
        "keyspaces": store.keyspaces(),
    }


# --- framing and files ----------------------------------------------------------


def test_frames_and_torn_tail_scans_match_the_reference():
    payloads = _payloads(1, 40) + [b"", b"\x00" * 17]
    ref = b"".join(REF.wal.frame_record(p) for p in payloads)
    port = b"".join(PORT.wal.frame_record(p) for p in payloads)
    assert port == ref
    rng = np.random.default_rng(2)
    cuts = sorted(set(int(c) for c in rng.integers(0, len(ref), size=48))) + [len(ref)]
    for cut in cuts:
        raw = ref[:cut]
        assert PORT.wal.scan_frames(raw) == REF.wal.scan_frames(raw)
    # a CRC flip mid-log: everything after it is unreachable in both
    bad = bytearray(ref)
    bad[len(ref) // 2] ^= 0x40
    got = PORT.wal.scan_frames(bytes(bad))
    assert got == REF.wal.scan_frames(bytes(bad)) and got[1] < len(ref)


def _wal_script(pkg, root):
    pkg.metrics.reset()
    log = pkg.wal.WriteAheadLog(os.path.join(root, "wal.log"), segment_bytes=2048, keep=2)
    for i in range(6):
        log.append_many(_payloads(10 + i, 9))
    log.append(b"last")
    replayed = log.replay()
    log.close()
    counts = {k: pkg.metrics.get_count(k) for k in (
        "wal_appends", "wal_fsyncs", "wal_segments_rotated", "wal_replayed_records")}
    return _read_all(root), replayed, counts


def test_wal_files_are_byte_identical(tmp_path):
    got = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        got[pkg.name] = _wal_script(pkg, str(root))
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    files, _, counts = port
    assert sorted(files) == ["wal.log", "wal.log.1", "wal.log.2"]
    assert counts["wal_fsyncs"] == 7 and counts["wal_segments_rotated"] >= 2


def _store_script(pkg, root, compact):
    """A deterministic workload: group commits, single puts, a tombstone,
    remote records from another origin, optionally a compaction midway."""
    st = pkg.store.StateStore(root, replica_id="rA")
    st.put_many("nullifier/1", [("%064x" % (i * 7919), 1) for i in range(40)], epoch=1)
    st.put("epoch", "1", {"event": "registered"}, epoch=1)
    st.put("health", "0", {"state": "healthy", "history": [["a", "b", "c"]]}, fsync=False)
    if compact:
        st.compact()
    st.delete("health", "0")
    st.apply_remote([
        {"ks": "nullifier/1", "k": "%064x" % 5, "v": 1, "o": "rB", "s": s, "e": 1, "t": 0}
        for s in (1, 2)
    ])
    st.put_many("nullifier/2", [("%064x" % (i + 1), 1) for i in range(3)], epoch=2)
    st.close()


@pytest.mark.parametrize("compact", [False, True], ids=["wal_only", "snapshot"])
def test_each_store_replays_in_the_other(tmp_path, compact):
    """Same workload, same bytes on disk (WAL and snapshot); each package
    opens the other's directory to the same image and marks."""
    files = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        _store_script(pkg, root, compact)
        files[pkg.name] = _read_all(root)
    assert files["coconut_tpu_torch"] == files["coconut_tpu"]
    assert ("store.snap" in files["coconut_tpu"]) == compact
    images = {}
    for writer in (REF, PORT):
        for reader in (REF, PORT):
            st = reader.store.StateStore(str(tmp_path / writer.name), replica_id="rA")
            images[writer.name, reader.name] = _image(st)
            st.close()
    first = images["coconut_tpu", "coconut_tpu"]
    assert all(img == first for img in images.values())
    assert first["marks"] == (
        ("epoch", "rA", 1), ("health", "rA", 2), ("nullifier/1", "rA", 40),
        ("nullifier/1", "rB", 2), ("nullifier/2", "rA", 3),
    )


def test_lww_ties_resolve_as_the_reference(tmp_path):
    """Records racing on one key from three origins, applied in four
    orders: the winner is the reference's (epoch, apply index, origin)
    maximum in every order, tombstones and null epochs included."""
    recs = [
        {"ks": "ks", "k": "k", "v": v, "o": o, "s": s, "e": e, "t": t}
        for v, o, s, e, t in [
            ("a", "r1", 1, None, 0), ("b", "r2", 1, None, 0), ("c", "r3", 1, 0, 0),
            ("d", "r1", 2, 0, 1), ("e", "r2", 2, 0, 0), ("f", "r3", 2, 0, 0),
            ("g", "r1", 3, 1, 0), ("h", "r2", 3, 1, 0),
        ]
    ]
    rng = random.Random(7)
    for trial in range(4):
        order = list(recs)
        rng.shuffle(order)
        got = {}
        for pkg in (REF, PORT):
            st = pkg.store.StateStore(str(tmp_path / ("%s%d" % (pkg.name, trial))))
            # one origin's records must arrive in seq order to be applied
            for r in sorted(order, key=lambda r: (order.index(r) if r["s"] == 1 else 99, r["s"])):
                st.apply_remote([r])
            got[pkg.name] = (st.get("ks", "k"), st.seen("ks", "k"), _image(st))
            st.close()
        assert got["coconut_tpu_torch"] == got["coconut_tpu"]
        assert got["coconut_tpu"][0] == "h"  # epoch 1, seq 3, origin r2 > r1


def test_rotation_past_keep_drops_the_oldest_records_as_the_reference(tmp_path):
    """A store that never compacts loses its oldest acknowledged records
    once rotation pushes a segment past `keep` — the reference's
    semantics, followed byte for byte: both packages keep the same keys
    after a reopen, and fewer than were written."""
    got = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name)
        st = pkg.store.StateStore(root, replica_id="rA", segment_bytes=1024, keep=1)
        for i in range(40):
            st.put("ks", "k%02d" % i, i)
        st.close()
        st = pkg.store.StateStore(root, replica_id="rA", segment_bytes=1024, keep=1)
        got[pkg.name] = (sorted(st.keys("ks")), _read_all(root))
        st.close()
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    kept = got["coconut_tpu_torch"][0]
    assert 0 < len(kept) < 40 and kept[-1] == "k39" and "k00" not in kept


# --- crash points ---------------------------------------------------------------

CRASH_SCHEDULES = {
    "wal.pre_append": dict(crash_at={"wal.pre_append"}),
    "wal.post_append": dict(crash_at={"wal.post_append"}),
    "store.mid_snapshot": dict(crash_at={"store.mid_snapshot"}),
    "store.mid_compact": dict(crash_at={"store.mid_compact"}),
    "torn_write": dict(torn_on={4}),
    "fsync_failure": dict(fsync_fail_on={4}),
}


def _drive_until_crash(pkg, root, chaos):
    """The reference suite's workload under `chaos`: keys acknowledged (the
    call returned) before the kill."""
    acked, store = [], None
    try:
        store = pkg.store.StateStore(root, replica_id="rA", chaos=chaos)
        for i in range(6):
            if i == 3:
                store.compact()
            store.put("ks", "k%d" % i, i)
            acked.append("k%d" % i)
    except (pkg.faults.SimulatedCrash, OSError):
        pass  # the "process" dies here; the object is abandoned
    finally:
        if store is not None:
            store.wal.close()
    return acked


@pytest.mark.parametrize("schedule", sorted(CRASH_SCHEDULES))
def test_crash_schedules_replay_as_the_reference(tmp_path, schedule):
    got = {}
    for pkg in (REF, PORT):
        pkg.metrics.reset()
        root = str(tmp_path / pkg.name)
        chaos = pkg.faults.WalChaos(**CRASH_SCHEDULES[schedule])
        acked = _drive_until_crash(pkg, root, chaos)
        recovered = pkg.store.StateStore(root, replica_id="rA")
        image = _image(recovered)
        recovered.close()
        again = pkg.store.StateStore(root, replica_id="rA")  # a second open truncates nothing
        again.close()
        got[pkg.name] = {
            "acked": acked, "image": image, "files": _read_all(root),
            "chaos": (chaos.crashes, chaos.torn_writes),
            "torn_tails": pkg.metrics.get_count("wal_torn_tails"),
        }
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    assert sum(port["chaos"]) == 1 or schedule == "fsync_failure"
    assert set(port["acked"]) <= set(port["image"]["data"].get("ks", {}))
    assert port["torn_tails"] == (1 if schedule == "torn_write" else 0)


# --- derivations ----------------------------------------------------------------


def _seeded(fn, seed):
    saved = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    try:
        return fn()
    finally:
        secrets.randbelow = saved


def _show(name, seed):
    """One credential of entry.fixture and two shows of it, each proved by
    the package `name` itself under seeded draws: (params, credential
    bytes, [(proof, challenge)])."""
    from coconut_tpu_torch import entry
    from torch_show_helpers import as_jax

    params, _, vk, sigs, msgs = entry.fixture(1, msg_count=3, seed=seed)
    if name == "coconut_tpu":
        params, vk, sigs = as_jax(params, vk, sigs)
    pok = importlib.import_module("%s.pok_sig" % name)
    shows = [
        _seeded(lambda: pok.show(sigs[0], vk, params, msgs[0], {1}), seed + 1 + k)[:2]
        for k in range(2)
    ]
    return params, sigs[0].to_bytes(params.ctx), shows


def test_nullifier_derivations_match_the_reference():
    got = {}
    for pkg in (REF, PORT):
        params, cred_bytes, shows = _show(pkg.name, 0x5EED)
        nf = pkg.nullifier
        tags = [nf.spend_tag_of(cred_bytes, d) for d in ("ecash", "petition/bees", None)]
        rows = []
        for proof, chal in shows:
            for epoch in (None, 0, 3):
                for domain, tag in ((None, None), ("ecash", None), ("ecash", tags[0]),
                                    (None, tags[2])):
                    rows.append(nf.nullifier_of(proof, chal, epoch, params, domain=domain, tag=tag))
        with pytest.raises(ValueError, match="32 bytes"):
            nf.nullifier_of(shows[0][0], shows[0][1], 1, params, tag=b"short")
        spaces = [nf.keyspace_of(e, d) for e in (None, 0, 7) for d in (None, "", "ecash")]
        got[pkg.name] = (rows, [t.hex() for t in tags], spaces, cred_bytes)
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    rows = port[0]
    # a second show is fresh except where a tag decides: the tagged rows
    # of epochs 0 (None is 0) and 3, in two scopes, collide across shows
    assert len(set(rows[:12]).intersection(rows[12:])) == 4
    assert rows[0] == rows[4] and rows[0] != rows[8]  # epoch None == epoch 0
    assert all(len(r) == 64 for r in rows)


# --- limb tables and the membership probe ---------------------------------------


def _digests(rng, n):
    return [rng.bytes(32).hex() for _ in range(n)]


def _queries(rng, spent):
    """Queries below and above every row, spent ones, one bit off a spent
    digest in the last limb, fresh ones, and top-bit limbs."""
    qs = ["00" * 32, "ff" * 32, "ff" * 31 + "fe", "80" + "00" * 31, "7f" + "ff" * 31]
    for d in spent[: min(len(spent), 40)]:
        qs.append(d)
        last = int(d[-8:], 16)
        qs.append(d[:-8] + "%08x" % (last ^ 1))
        qs.append(d[:-8] + "%08x" % ((last + 1) % (1 << 32)))
    qs += _digests(rng, 24)
    qs += ["%08x" % (0x80000000 | int(rng.integers(0, 1 << 31))) * 8 for _ in range(8)]
    return qs


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 4096, 4097])
def test_membership_probe_matches_the_reference(n):
    rng = np.random.default_rng(n + 17)
    spent = _digests(rng, n)
    if n >= 3:
        spent[1] = "ff" * 31 + "fe"  # a real row just under the sentinels
        spent[2] = "%08x" % 0x80000000 * 8
    table, n_real = PORT.nullifier.build_table(spent)
    rtable, rn_real = REF.nullifier.build_table(spent)
    assert table.dtype == rtable.dtype == np.uint32
    assert np.array_equal(table, rtable) and n_real == rn_real == len(set(spent))
    assert table.shape[0] == (1 if n <= 1 else 1 << (n - 1).bit_length())
    queries = _queries(rng, sorted(spent))
    q = PORT.nullifier.digests_to_limbs(queries)
    assert np.array_equal(q, REF.nullifier.digests_to_limbs(queries))
    assert (q >= 0x80000000).any()
    plain = PORT.nullifier.membership_probe(table, n_real, q)
    ref = REF.nullifier.membership_probe(rtable, rn_real, q, xp=jnp)
    want = np.array([d in set(spent) for d in queries])
    assert plain.dtype == bool and np.array_equal(plain, np.asarray(ref, dtype=bool))
    assert np.array_equal(plain, want)


def test_limb_tables_of_no_digest():
    assert PORT.nullifier.digests_to_limbs([]).shape == (0, 8)
    t, n = PORT.nullifier.build_table([])
    rt, rn = REF.nullifier.build_table([])
    assert np.array_equal(t, rt) and n == rn == 0
    assert PORT.nullifier.membership_probe(t, 0, np.zeros((0, 8), np.uint32)).shape == (0,)


# --- the guard ------------------------------------------------------------------


def _guard_script(pkg, root):
    pkg.metrics.reset()
    store = pkg.store.StateStore(root, replica_id="rA")
    kw = {"device": "cpu"} if pkg is PORT else {}
    g = pkg.nullifier.NullifierGuard(store, use_device=True, **kw)
    d = [hashlib.sha256(b"n%d" % i).hexdigest() for i in range(6)]
    out = {}
    out["probe_empty"] = g.probe(d[:2], epochs=[1, 1])
    out["c1"] = g.commit([d[0], d[1], d[0]], epochs=[1, 1, 1])
    out["c2"] = g.commit([d[0], d[2], d[3]], epochs=[1, 1, 2], accept=[True, True, False])
    out["c3"] = g.commit([d[4], d[4], d[5]], epochs=[1, 1, 1], domains=["ecash", "ecash", "poll"])
    out["probe"] = g.probe(d, epochs=[1] * 6)
    out["probe_dom"] = g.probe([d[4], d[5], d[4]], epochs=[1, 1, 2], domains=["ecash", "poll", "ecash"])
    out["seen"] = [g.seen(x, 1) for x in d] + [g.seen(d[4], 1, "ecash"), g.seen(d[3], 2)]
    out["retire_2"] = g.retire_epoch(2)
    out["retire_1"] = g.retire_epoch(1)
    out["spaces"] = store.keyspaces()
    store.close()
    out["counters"] = {
        k: pkg.metrics.get_count(k) for k in (
            "nullifier_commits", "nullifier_double_spends", "nullifier_probe_hits",
            "state_nullifiers_compacted", "state_keyspaces_dropped", "wal_fsyncs")
    }
    return out


def test_guard_commit_probe_and_retirement_match_the_reference(tmp_path):
    got = {pkg.name: _guard_script(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)}
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    assert port["c1"] == [True, True, False] and port["c2"] == [False, True, False]
    assert port["c3"] == [True, False, True]
    assert port["probe"] == [True, True, True, False, False, False]
    assert port["retire_1"] == 5 and port["spaces"] == ()


def test_guard_device_is_explicit(tmp_path):
    import torch

    store = PORT.store.StateStore(str(tmp_path / "s"))
    g = PORT.nullifier.NullifierGuard(store, device="cpu")
    assert g.device == torch.device("cpu")
    assert PORT.nullifier.NullifierGuard(store, use_device=False).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.nullifier.NullifierGuard(store)
    store.close()


# --- replication ----------------------------------------------------------------


class _DirectPuller:
    """Duck-typed client pulling straight from a peer store."""

    def __init__(self, store, dead=False):
        self.store = store
        self.dead = dead

    def pull_state(self, ks, origin, after_seq, limit):
        if self.dead:
            raise ConnectionError("peer is down")
        return self.store.records_after(ks, origin, after_seq, limit)


class _StaticDirectory:
    def __init__(self, stores):
        self.stores = stores

    def state_marks(self, rid):
        return self.stores[rid].marks()


def _replication_script(pkg, root):
    pkg.metrics.reset()
    mk = lambda rid: pkg.store.StateStore(os.path.join(root, rid), replica_id=rid)
    a, b, c = mk("rA"), mk("rB"), mk("rC")
    directory = _StaticDirectory({"rA": a, "rB": b, "rC": c})
    chaos = pkg.faults.ReplicationChaos(drop_pairs={("rA", None), ("rB", "ks2")})
    rep_b = pkg.replicate.StateReplicator(b, directory, {"rA": _DirectPuller(a)}, chaos=chaos, page=3)
    a.put_many("ks", [("k%d" % i, i) for i in range(7)], epoch=1)
    a.put("ks2", "x", "y")
    steps = [rep_b.step()]  # partitioned: every pull swallowed
    chaos.drop_pairs.discard(("rA", None))
    steps.append(rep_b.step())  # healed: 7 + 1 records in pages of 3
    steps.append(rep_b.step())  # converged: idempotent
    # a fact outlives its witness: C pulls A's records from B
    rep_c = pkg.replicate.StateReplicator(
        c, directory, {"rA": _DirectPuller(a, dead=True), "rB": _DirectPuller(b)}, chaos=chaos)
    steps.append(rep_c.step())  # rB's ks2 pull is still dropped
    chaos.heal()
    steps.append(rep_c.step())
    out = {
        "steps": steps, "dropped": chaos.dropped, "images": [_image(s) for s in (b, c)],
        "counters": {k: pkg.metrics.get_count(k) for k in (
            "state_antientropy_pulls", "state_antientropy_dropped", "state_records_applied")},
    }
    for s in (a, b, c):
        s.close()
    return out


def test_replicator_heals_gaps_as_the_reference(tmp_path):
    got = {pkg.name: _replication_script(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)}
    ref, port = got["coconut_tpu"], got["coconut_tpu_torch"]
    assert port == ref
    assert port["steps"][0] == 0 and port["steps"][1] == 8 and port["steps"][2] == 0
    b_img, c_img = port["images"]
    assert c_img["data"] == b_img["data"] and json.dumps(c_img["marks"]) == json.dumps(b_img["marks"])
