"""Crash-atomic file replacement — the port's copy of
`coconut_tpu/state/atomic.py`: the tmp + fsync + os.replace +
directory-fsync dance the stream checkpoints (stream.StreamState.save)
use.

  - the WHOLE document is written to `<path>.tmp` (a fixed sibling:
    a crash mid-write leaves at most one stale tmp, truncated by the
    next save and invisible to readers, which only ever open `path`);
  - the tmp is flushed and fsync'd BEFORE the rename, so the rename
    can never expose a file whose bytes are still in the page cache;
  - os.replace is atomic on POSIX: a reader sees the old complete
    file or the new complete file, never torn bytes;
  - the directory entry is fsync'd afterwards (best-effort: some
    filesystems refuse O_RDONLY directory fsync), so the rename itself
    survives a power cut.

`fsync=False` skips both syncs for callers on a lazy-durability
contract while keeping the torn-file atomicity guarantee."""

import json
import os


def fsync_dir(dirname):
    """Best-effort fsync of a directory entry (persists a rename)."""
    try:
        dfd = os.open(dirname or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - platform-dependent
        pass


def replace_file(path, data, fsync=True):
    """Atomically replace `path` with `data` (bytes or str). Returns
    `path`. Parent directories are created on demand."""
    path = str(path)
    dirn = os.path.dirname(os.path.abspath(path))
    if dirn:
        os.makedirs(dirn, exist_ok=True)
    tmp = path + ".tmp"
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(tmp, mode) as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX
    if fsync:
        fsync_dir(dirn)
    return path


def replace_json(path, doc, sort_keys=False, fsync=True):
    """Atomically replace `path` with `doc` serialized as JSON."""
    return replace_file(
        path, json.dumps(doc, sort_keys=sort_keys), fsync=fsync
    )
