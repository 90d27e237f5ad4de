"""Fault flight recorder: dump the trace context of a failure the moment
it happens.

The tracer's ring buffer forgets (bounded memory is the point), so by the
time an operator greps a dead-letter line the spans that explain it may
be gone. This module closes that gap: on a dead-letter append or a
checkpoint quarantine, `record()` writes ONE JSONL line holding

  - the failing request's FULL span tree (finished + still-live spans of
    its trace, plus the batch trace linked via the `batch_trace`
    attribute — the request->batch join the serve layer records), and
  - the last `last_n` completed spans overall (what the system was doing
    just before the fault — the classic flight-recorder tail),

to `<base>.flight.jsonl` next to the artifact that triggered it (the
dead-letter log, the checkpoint file). Joining back is one grep: the
dead-letter line and the flight line share the trace_id.

Zero-cost when tracing is disabled: `record()` returns None without
touching the filesystem. Failures to WRITE the flight record are
swallowed (`flight_write_errors` counter) — the recorder must never turn
a handled fault into a crash.

BOUNDED ON DISK: both this file and the dead-letter JSONL it rides next
to are written by fault paths, and a sustained fault storm must not fill
the disk. `rotate_if_needed()` implements size/record-count JSONL
rotation (`<path>.1` newest rotated, up to `<path>.<keep>`); the flight
recorder applies it with `FLIGHT_MAX_BYTES`/`FLIGHT_KEEP`, and
faults.DeadLetterLog calls the same helper with its own knobs — one
rotation discipline for every append-only fault artifact.
"""

import json
import os
import time

from .. import metrics
from . import trace as _trace
from .export import span_records

FLIGHT_SCHEMA = 1

#: completed-span tail included in every flight record
DEFAULT_LAST_N = 64

#: per-file size cap before a flight/dead-letter JSONL rotates, and how
#: many rotated generations (`<path>.1` .. `<path>.<keep>`) are retained
FLIGHT_MAX_BYTES = 64 * 1024 * 1024
FLIGHT_KEEP = 3


def flight_path(base_path):
    """The flight-recorder file that rides next to `base_path`."""
    return "%s.flight.jsonl" % (base_path,)


def rotate_if_needed(
    path, max_bytes=None, max_records=None, keep=FLIGHT_KEEP, record_count=None
):
    """Rotate `path` aside (`path` -> `path.1` -> ... -> `path.keep`,
    oldest dropped) when it has reached `max_bytes` or `max_records`
    lines; call BEFORE appending. `record_count` lets a caller that
    already tracks its line count skip the O(file) recount. Returns True
    iff a rotation happened. None caps disable that check; rotation
    errors are swallowed (a full-disk fault path must not crash its
    handler) under the "rotation_errors" counter."""
    try:
        if keep < 1 or not os.path.exists(path):
            return False
        need = (
            max_bytes is not None and os.path.getsize(path) >= max_bytes
        )
        if not need and max_records is not None:
            if record_count is None:
                with open(path, "rb") as f:
                    record_count = sum(1 for line in f if line.strip())
            need = record_count >= max_records
        if not need:
            return False
        for i in range(keep - 1, 0, -1):
            older = "%s.%d" % (path, i)
            if os.path.exists(older):
                os.replace(older, "%s.%d" % (path, i + 1))
        os.replace(path, "%s.1" % (path,))
        metrics.count("rotations")
        return True
    except OSError:
        metrics.count("rotation_errors")
        return False


def record(base_path, reason, trace_id=None, extra=None, last_n=DEFAULT_LAST_N):
    """Append one flight record next to `base_path`; returns the record
    (None when tracing is disabled or base_path is falsy)."""
    tracer = _trace.get_tracer()
    if tracer is None or not base_path:
        return None
    tree = tracer.spans_for(trace_id) if trace_id is not None else []
    rec = {
        "schema": FLIGHT_SCHEMA,
        "wall_time": time.time(),
        "reason": reason,
        "trace_id": trace_id,
        "tree": span_records(tree),
        "recent": span_records(tracer.tail(last_n)),
    }
    if extra:
        rec.update(extra)
    rotate_if_needed(
        flight_path(base_path), max_bytes=FLIGHT_MAX_BYTES, keep=FLIGHT_KEEP
    )
    try:
        # lint: allow(durability, best-effort append-only observability
        # artifact; read() skips+counts a torn tail)
        with open(flight_path(base_path), "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    except OSError:
        metrics.count("flight_write_errors")
        return None
    metrics.count("flight_records")
    return rec


def read(path):
    """All flight records in `path` (empty list if it does not exist) —
    accepts either the base path or the .flight.jsonl path itself.
    Torn-tail tolerant like DeadLetterLog.read: a crash mid-append can
    truncate the final line; skip it (counted under
    "flight_torn_lines") instead of poisoning every later read."""
    import os

    if not path.endswith(".flight.jsonl"):
        path = flight_path(path)
    if not os.path.exists(path):
        return []
    recs = []
    torn = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                torn += 1
    if torn:
        metrics.count("flight_torn_lines", torn)
    return recs
