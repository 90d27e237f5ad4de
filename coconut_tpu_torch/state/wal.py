"""Per-replica append-only write-ahead log — the port's copy of
`coconut_tpu/state/wal.py`, byte-compatible with it: a WAL one package
writes, the other replays.

One WAL = one active segment file plus a bounded chain of rotated
segments (`<path>.1` newest rotated .. `<path>.<keep>` oldest — the
keep-N naming the dead-letter and flight rotation use). Records are
length-prefixed and CRC-framed:

    offset  size  field
    0       4     length   u32 big-endian payload byte count
    4       4     crc32    zlib.crc32(payload)
    8       len   payload  opaque bytes (the StateStore writes one
                           JSON-encoded record per frame)

Durability contract:

  - `append` / `append_many` write the frame(s), flush, and fsync —
    ONE fsync per call, so a batch of records group-commits at one
    disk-flush cost (the show-verify demux's per-batch commit;
    "wal_fsyncs" against "wal_appends" shows the policy is per batch,
    not per lane);
  - a crash mid-append leaves a TORN TAIL: a trailing frame whose
    length prefix is incomplete, whose payload is short, or whose CRC
    disagrees. `open` scans from the start, keeps the longest valid
    prefix, truncates the tail IN PLACE exactly once (counted under
    "wal_torn_tails"), and the store replays only acknowledged records
    — an unacknowledged append can vanish, an acknowledged one cannot
    (the fsync returned before the caller's future resolved);
  - `rotate_if_needed` bounds the active segment: past
    `segment_bytes` it shifts the chain (`.1` -> `.2`, ..., dropping
    beyond `keep`) and starts a fresh active segment. Compaction
    (StateStore.compact: snapshot, then `reset`) is the primary bound;
    rotation is the backstop for a store that never compacts.

Fault seams (faults.WalChaos): `torn_on` append indices write only a
PREFIX of the frame then raise (a kill mid-record), `fsync_fail_on`
indices raise OSError from the sync (a dying disk), and `crash(point)`
fires at the named seams "wal.pre_append" and "wal.post_append"."""

import os
import struct
import zlib

from .. import metrics

_FRAME = struct.Struct(">II")  # length, crc32
FRAME_HEADER_BYTES = _FRAME.size  # 8

#: default active-segment size bound (rotation backstop)
DEFAULT_SEGMENT_BYTES = 8 << 20
#: rotated segments kept (newest .1 .. oldest .keep)
DEFAULT_KEEP = 4


def frame_record(payload):
    """One framed WAL record: u32 length + u32 crc32 + payload."""
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def scan_frames(raw):
    """(payloads, valid_bytes): the longest valid record prefix of
    `raw` and its byte length. Anything past `valid_bytes` is a torn
    tail (incomplete header, short payload, or CRC mismatch)."""
    payloads, off = [], 0
    n = len(raw)
    while off + FRAME_HEADER_BYTES <= n:
        length, crc = _FRAME.unpack_from(raw, off)
        end = off + FRAME_HEADER_BYTES + length
        if end > n:
            break  # short payload: torn tail
        payload = raw[off + FRAME_HEADER_BYTES : end]
        if zlib.crc32(payload) != crc:
            break  # corrupt frame: everything after is unreachable
        payloads.append(payload)
        off = end
    return payloads, off


class WriteAheadLog:
    """Append-only CRC-framed log with torn-tail recovery and bounded
    rotation. NOT thread-safe on its own — the StateStore serializes
    every append/replay/reset under its lock."""

    def __init__(
        self,
        path,
        segment_bytes=DEFAULT_SEGMENT_BYTES,
        keep=DEFAULT_KEEP,
        chaos=None,
    ):
        self.path = str(path)
        self.segment_bytes = segment_bytes
        self.keep = keep
        #: faults.WalChaos (or None): torn-write / fsync-failure /
        #: crash-point injection, indexed by the append counter
        self.chaos = chaos
        self.appends = 0
        dirn = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(dirn, exist_ok=True)
        self._truncate_torn_tail()
        self._f = open(self.path, "ab")

    # -- recovery ------------------------------------------------------------

    def _segments(self):
        """Every existing segment path, oldest first, active last."""
        chain = [
            "%s.%d" % (self.path, k)
            for k in range(self.keep, 0, -1)
        ]
        return [p for p in chain if os.path.exists(p)] + (
            [self.path] if os.path.exists(self.path) else []
        )

    def _truncate_torn_tail(self):
        """Drop a torn tail from the ACTIVE segment, exactly once per
        open, under the "wal_torn_tails" counter. Rotated segments were
        sealed by a successful rotation and are never truncated."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        _, valid = scan_frames(raw)
        if valid < len(raw):
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
            metrics.count("wal_torn_tails")

    def replay(self):
        """Every acknowledged payload, oldest segment first. Counted
        under "wal_replayed_records"."""
        out = []
        for seg in self._segments():
            with open(seg, "rb") as f:
                payloads, _ = scan_frames(f.read())
            out.extend(payloads)
        metrics.count("wal_replayed_records", len(out))
        return out

    # -- append path ---------------------------------------------------------

    def _fault(self, point):
        if self.chaos is not None:
            self.chaos.crash(point)

    def append_many(self, payloads, fsync=True):
        """Group commit: frame and write every payload, then flush and
        fsync ONCE. The per-batch WAL policy — N accepted show-verify
        lanes cost one disk flush, not N."""
        payloads = list(payloads)
        if not payloads:
            return 0
        self._fault("wal.pre_append")
        for payload in payloads:
            idx = self.appends
            self.appends += 1
            frame = frame_record(payload)
            if self.chaos is not None and idx in self.chaos.torn_on:
                # torn-write injection: half the frame reaches the
                # disk, then the "process" dies mid-record
                self._f.write(frame[: max(1, len(frame) // 2)])
                self._f.flush()
                os.fsync(self._f.fileno())
                self.chaos.torn_writes += 1
                raise self.chaos.error(
                    "injected torn write on WAL append #%d" % idx
                )
            self._f.write(frame)
        metrics.count("wal_appends", len(payloads))
        self._fault("wal.post_append")
        self._f.flush()
        if fsync:
            if self.chaos is not None and self.chaos.fsync_fails():
                raise OSError("injected WAL fsync failure")
            os.fsync(self._f.fileno())
            metrics.count("wal_fsyncs")
        self.rotate_if_needed()
        return len(payloads)

    def append(self, payload, fsync=True):
        return self.append_many([payload], fsync=fsync)

    def sync(self):
        self._f.flush()
        os.fsync(self._f.fileno())
        metrics.count("wal_fsyncs")

    # -- bounding ------------------------------------------------------------

    def rotate_if_needed(self):
        """Shift the segment chain when the active segment crosses the
        bound: .keep is dropped, .k -> .k+1, active -> .1, and a fresh
        active segment opens. Sealed segments are never rewritten, so
        recovery only ever truncates the active one."""
        if self._f.tell() < self.segment_bytes:
            return False
        self._f.close()
        drop = "%s.%d" % (self.path, self.keep)
        if os.path.exists(drop):
            os.remove(drop)
        for k in range(self.keep - 1, 0, -1):
            src = "%s.%d" % (self.path, k)
            if os.path.exists(src):
                os.replace(src, "%s.%d" % (self.path, k + 1))
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "ab")
        metrics.count("wal_segments_rotated")
        return True

    def reset(self):
        """Drop every record (post-snapshot compaction): truncate the
        active segment and remove the rotated chain. Crash-safe against
        the snapshot: the store snapshots BEFORE resetting, and replay
        of a pre-reset WAL over a post-snapshot store is idempotent
        (apply indices make re-applied records no-ops)."""
        self._f.close()
        for k in range(1, self.keep + 1):
            seg = "%s.%d" % (self.path, k)
            if os.path.exists(seg):
                os.remove(seg)
        self._f = open(self.path, "wb")
        self._f.flush()
        os.fsync(self._f.fileno())

    def size_bytes(self):
        return sum(os.path.getsize(p) for p in self._segments())

    def close(self):
        if not self._f.closed:
            self._f.close()
