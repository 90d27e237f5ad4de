"""The port's durable state plane — a copy of `coconut_tpu/state/`, with the
same file formats, so a directory one package writes the other opens.

`atomic`    — the tmp + fsync + os.replace + directory-fsync replacement
              the stream checkpoints and the store's snapshots use.
`wal`       — per-replica append-only CRC-framed write-ahead log:
              group-commit fsync, torn-tail truncation, bounded segment
              rotation.
`store`     — snapshot + replay StateStore over the WAL: named
              keyspaces, per-origin monotonic apply indices,
              last-writer-wins by (epoch, apply-index, origin),
              compaction = snapshot + WAL reset.
`replicate` — pull-based anti-entropy over duck-typed peers: advertised
              high-water marks, gaps pulled and applied idempotently.
`nullifier` — the epoch-scoped double-spend set: a batched membership
              probe on the device (torch ops; the plain version is the
              same function on CPU tensors) and the authoritative host
              check-and-set, WAL-group-committed."""

from .atomic import fsync_dir, replace_file, replace_json
from .nullifier import (
    NullifierGuard,
    build_table,
    digests_to_limbs,
    keyspace_of,
    membership_probe,
    nullifier_of,
    spend_tag_of,
)
from .replicate import StateReplicator
from .store import SNAPSHOT_SCHEMA, StateStore
from .wal import (
    DEFAULT_KEEP,
    DEFAULT_SEGMENT_BYTES,
    FRAME_HEADER_BYTES,
    WriteAheadLog,
    frame_record,
    scan_frames,
)

__all__ = [
    "DEFAULT_KEEP",
    "DEFAULT_SEGMENT_BYTES",
    "FRAME_HEADER_BYTES",
    "NullifierGuard",
    "SNAPSHOT_SCHEMA",
    "StateReplicator",
    "StateStore",
    "WriteAheadLog",
    "build_table",
    "digests_to_limbs",
    "frame_record",
    "fsync_dir",
    "keyspace_of",
    "membership_probe",
    "nullifier_of",
    "replace_file",
    "replace_json",
    "scan_frames",
    "spend_tag_of",
]
