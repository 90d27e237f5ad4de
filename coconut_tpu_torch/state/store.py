"""Snapshot + replay state store over the per-replica WAL — the port's
copy of `coconut_tpu/state/store.py`, with the same record model, snapshot
file and counters, so a directory either package writes the other opens.

Named keyspaces of key -> record maps where every mutation is
WAL-appended BEFORE it is applied in memory, so the in-memory image is
always snapshot + replay. Consumers (`state/nullifier.py`, the
EpochRegistry journal, the executor-health journal, the dead-letter
index) never touch the WAL directly: they `put` / `put_many` / `get`, and
the store owns framing, recovery, compaction and replication bookkeeping.

Record model (one JSON object per WAL frame, compact keys):

    {"ks": keyspace, "k": key, "v": value, "o": origin replica id,
     "s": per-(keyspace, origin) monotonic apply index,
     "e": epoch or null, "t": 0|1 tombstone}

Conflict rule: last-writer-wins by (epoch, apply-index, origin) — a
record with a higher epoch beats any lower-epoch record, ties resolve
by apply index then lexicographic origin, so every replica converges
to the same winner whatever the apply order. `apply_remote` is
idempotent: a record at or below the origin's high-water mark is a
no-op, which is what makes "replay a pre-compaction WAL over a
post-snapshot image" safe.

Replication surface: `marks()` is the per-keyspace high-water map;
`records_after(ks, origin, after_seq)` serves anti-entropy pulls from
the per-origin ordered logs (a replica relays records it merely
replicated, so a killed witness's facts keep spreading).

Compaction: `snapshot()` writes the full image + marks + per-origin
logs crash-atomically (`store.snap`, `{"crc", "body"}` with
SNAPSHOT_SCHEMA in the body; a corrupt snapshot is quarantined to
`.corrupt` and the store falls back to WAL replay alone); `compact()` =
snapshot, then WAL reset. Crash points "store.mid_snapshot" (before
the atomic replace: old snapshot + full WAL survive) and
"store.mid_compact" (snapshot taken, WAL not yet reset: replay over the
snapshot is idempotent)."""

import json
import os
import threading
import zlib

from .. import metrics
from .atomic import replace_json
from .wal import WriteAheadLog

SNAPSHOT_SCHEMA = 1


def _rank(rec):
    """LWW total order: (epoch, apply index, origin). Epoch None ranks
    below every real epoch (epoch-scoped facts beat legacy ones)."""
    e = rec["e"]
    return (-1 if e is None else e, rec["s"], rec["o"])


class StateStore:
    """Durable keyspace/key/value store: WAL-append before apply,
    snapshot+replay recovery, per-origin logs for anti-entropy."""

    def __init__(
        self,
        root,
        replica_id="r0",
        segment_bytes=None,
        keep=None,
        chaos=None,
    ):
        self.root = str(root)
        self.replica_id = replica_id
        self.chaos = chaos
        self._lock = threading.RLock()
        self._data = {}  # ks -> {key -> rec}
        self._marks = {}  # ks -> {origin -> highest applied seq}
        self._log = {}  # (ks, origin) -> [rec, ...] ordered by seq
        os.makedirs(self.root, exist_ok=True)
        self.snap_path = os.path.join(self.root, "store.snap")
        self._load_snapshot()
        kw = {}
        if segment_bytes is not None:
            kw["segment_bytes"] = segment_bytes
        if keep is not None:
            kw["keep"] = keep
        self.wal = WriteAheadLog(
            os.path.join(self.root, "wal.log"), chaos=chaos, **kw
        )
        for payload in self.wal.replay():
            # replay is idempotent against the snapshot: records at or
            # below the snapshot's marks are skipped by _apply_locked
            self._apply_locked(json.loads(payload.decode("utf-8")))

    # -- crash points --------------------------------------------------------

    def _fault(self, point):
        if self.chaos is not None:
            self.chaos.crash(point)

    # -- recovery ------------------------------------------------------------

    def _load_snapshot(self):
        if not os.path.exists(self.snap_path):
            return
        try:
            with open(self.snap_path, "r") as f:
                doc = json.load(f)
            body = doc["body"]
            blob = json.dumps(body, sort_keys=True).encode("utf-8")
            if doc["crc"] != zlib.crc32(blob):
                raise ValueError("snapshot CRC mismatch")
            if body["schema"] != SNAPSHOT_SCHEMA:
                raise ValueError(
                    "snapshot schema %r" % (body["schema"],)
                )
        except (OSError, ValueError, KeyError, TypeError):
            # same quarantine posture as stream checkpoints: a corrupt
            # snapshot is set aside, never silently trusted, and the
            # store rebuilds from the WAL alone
            metrics.count("state_snapshot_corrupt")
            try:
                os.replace(self.snap_path, self.snap_path + ".corrupt")
            except OSError:  # pragma: no cover - platform-dependent
                pass
            return
        for rec in body["records"]:
            self._apply_locked(rec, count=False)
        metrics.count("state_snapshot_loads")

    # -- apply ---------------------------------------------------------------

    def _apply_locked(self, rec, count=True):
        """Apply one record. Idempotent: seq at or below the origin's
        mark is a no-op. Returns True if the record was new."""
        ks, origin, seq = rec["ks"], rec["o"], rec["s"]
        marks = self._marks.setdefault(ks, {})
        if seq <= marks.get(origin, 0):
            return False
        marks[origin] = seq
        self._log.setdefault((ks, origin), []).append(rec)
        space = self._data.setdefault(ks, {})
        old = space.get(rec["k"])
        if old is None or _rank(rec) > _rank(old):
            space[rec["k"]] = rec
        if count:
            metrics.count("state_records_applied")
        return True

    # -- local mutation (WAL-append before apply) ----------------------------

    def _make_rec(self, keyspace, key, value, epoch, tombstone):
        marks = self._marks.setdefault(keyspace, {})
        seq = marks.get(self.replica_id, 0) + 1
        return {
            "ks": keyspace,
            "k": key,
            "v": value,
            "o": self.replica_id,
            "s": seq,
            "e": epoch,
            "t": 1 if tombstone else 0,
        }

    def put_many(self, keyspace, items, epoch=None, fsync=True):
        """Group commit: ONE WAL fsync for the whole batch, applied in
        memory only after the append returns. `items` is an iterable of
        (key, value). Returns the applied records."""
        with self._lock:
            recs = []
            seq_base = self._marks.setdefault(keyspace, {}).get(
                self.replica_id, 0
            )
            for i, (key, value) in enumerate(items):
                recs.append(
                    {
                        "ks": keyspace,
                        "k": key,
                        "v": value,
                        "o": self.replica_id,
                        "s": seq_base + 1 + i,
                        "e": epoch,
                        "t": 0,
                    }
                )
            if not recs:
                return ()
            self.wal.append_many(
                [
                    json.dumps(r, sort_keys=True).encode("utf-8")
                    for r in recs
                ],
                fsync=fsync,
            )
            for r in recs:
                self._apply_locked(r)
            return tuple(recs)

    def put(self, keyspace, key, value, epoch=None, fsync=True):
        return self.put_many(
            keyspace, [(key, value)], epoch=epoch, fsync=fsync
        )[0]

    def delete(self, keyspace, key, epoch=None, fsync=True):
        """Tombstone a key (the record still replicates — deletion is
        a fact, not an absence)."""
        with self._lock:
            rec = self._make_rec(keyspace, key, None, epoch, True)
            self.wal.append(
                json.dumps(rec, sort_keys=True).encode("utf-8"),
                fsync=fsync,
            )
            self._apply_locked(rec)
            return rec

    # -- reads ---------------------------------------------------------------

    def get(self, keyspace, key, default=None):
        with self._lock:
            rec = self._data.get(keyspace, {}).get(key)
            if rec is None or rec["t"]:
                return default
            return rec["v"]

    def seen(self, keyspace, key):
        with self._lock:
            rec = self._data.get(keyspace, {}).get(key)
            return rec is not None and not rec["t"]

    def keys(self, keyspace):
        with self._lock:
            return tuple(
                k
                for k, rec in self._data.get(keyspace, {}).items()
                if not rec["t"]
            )

    def keyspaces(self):
        with self._lock:
            return tuple(sorted(self._marks))

    # -- replication surface -------------------------------------------------

    def marks(self):
        """Per-keyspace high-water marks as ((ks, origin, seq), ...) —
        the beacon piggyback. Sorted for a deterministic wire image."""
        with self._lock:
            out = []
            for ks in sorted(self._marks):
                for origin in sorted(self._marks[ks]):
                    out.append((ks, origin, self._marks[ks][origin]))
            return tuple(out)

    def records_after(self, keyspace, origin, after_seq, limit=512):
        """Anti-entropy page: records from `origin`'s log in `keyspace`
        with seq > after_seq, oldest first. Serves records this replica
        merely replicated too — facts outlive their witness."""
        with self._lock:
            log = self._log.get((keyspace, origin), ())
            return tuple(
                r for r in log if r["s"] > after_seq
            )[:limit]

    def apply_remote(self, recs):
        """Apply replicated records: WAL-append the new ones (so a
        restart keeps them) then apply. Idempotent. Returns the number
        of records that were new."""
        with self._lock:
            fresh = [
                r
                for r in recs
                if r["s"]
                > self._marks.setdefault(r["ks"], {}).get(r["o"], 0)
            ]
            if not fresh:
                return 0
            self.wal.append_many(
                [
                    json.dumps(r, sort_keys=True).encode("utf-8")
                    for r in fresh
                ]
            )
            n = 0
            for r in fresh:
                if self._apply_locked(r):
                    n += 1
            return n

    # -- compaction ----------------------------------------------------------

    def snapshot(self):
        """Crash-atomically persist the full image (records in per-
        origin order, so both `_data` and `records_after` rebuild)."""
        with self._lock:
            records = []
            for key in sorted(self._log):
                records.extend(self._log[key])
            body = {
                "schema": SNAPSHOT_SCHEMA,
                "replica": self.replica_id,
                "records": records,
            }
            blob = json.dumps(body, sort_keys=True).encode("utf-8")
            self._fault("store.mid_snapshot")
            replace_json(
                self.snap_path,
                {"crc": zlib.crc32(blob), "body": body},
            )
            metrics.count("state_snapshots")

    def drop_keyspace(self, keyspace):
        """Retire a whole keyspace: remove its image, marks, and
        per-origin logs, then compact so the WAL no longer carries the
        dropped records either (epoch retirement wants the nullifier
        set's memory gone wholesale, not tombstoned key-by-key).
        Returns the number of live (non-tombstone) keys dropped."""
        with self._lock:
            space = self._data.pop(keyspace, {})
            self._marks.pop(keyspace, None)
            for key in [k for k in self._log if k[0] == keyspace]:
                del self._log[key]
            n = sum(1 for rec in space.values() if not rec["t"])
            # the snapshot inside compact() is rebuilt from _log, so
            # the dropped keyspace vanishes from disk atomically too
            self.compact()
            metrics.count("state_keyspaces_dropped")
            return n

    def compact(self):
        """snapshot + WAL reset. A crash between the two leaves the
        snapshot AND the full WAL — replay is idempotent, so the next
        open converges to the same image with zero duplicates."""
        with self._lock:
            self.snapshot()
            self._fault("store.mid_compact")
            self.wal.reset()
            metrics.count("state_compactions")

    def close(self):
        self.wal.close()
