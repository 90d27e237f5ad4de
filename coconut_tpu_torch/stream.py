"""Streamed batch verification with checkpoint/resume and a
fault-supervision layer — the port's copy of `coconut_tpu/stream.py`, with
the same checkpoint format, counters and span names.

The stream is processed in fixed-size batches through a backend
(TorchBackend on the card), and a small JSON state file records the last
fully-verified batch index plus running tallies: kill the process at any
point and a rerun skips straight to the first unverified batch. Batch
verification is stateless, so recovery is "resubmit from the checkpoint".

Three result modes, each with honest accounting:

  - mode="per_credential": `backend.batch_verify` returns one bool per
    credential; `verified`/`failed` count credentials.
  - mode="grouped": `backend.batch_verify_grouped` returns ONE bool per
    batch (soundness 2^-128 per forged credential); `batches_ok` /
    `batches_failed` count batches and `verified` counts only credentials
    in accepted batches — a failing batch is recorded in `failed`
    wholesale unless bisection is on (below).
  - mode="batched": the RLC combined check, one bool per batch like
    grouped (`backend.batch_verify_combined`).

Pipelining: when the backend exposes the `*_async` dispatch seam
(TorchBackend does), batch i+1's host fetch and encode run while batch i
executes on the device: dispatch batch i, fetch/encode/dispatch i+1, then
block on i's result; `prefetch_depth` moves the encode onto a bounded
worker thread.

Fault supervision:

  - a batch whose dispatch or readback raises `TransientBackendError` is
    re-attempted under a `retry.RetryPolicy` (bounded exponential backoff,
    deterministic jitter, per-batch attempt cap);
  - after retries exhaust, the batch re-dispatches on `fallback_backend`
    (e.g. "spec") so the stream completes degraded instead of dying; with
    no fallback the transient error propagates, and the checkpoint lets a
    rerun resume at the failed batch;
  - in grouped and batched modes a rejected batch can be bisected:
    probes over recursively halved slices isolate the culprit
    credentials, which are appended to the `dead_letter_path` JSONL
    (faults.DeadLetterLog) with batch index, credential index and the
    batch's retry attempt history; `failed` then counts only the culprits;
  - the checkpoint is integrity-checked (schema version + CRC + run
    fingerprint): corruption quarantines the file and restarts cleanly, a
    fingerprint mismatch refuses to resume the wrong run.

  Counters (metrics.snapshot()): "retries", "fallbacks", "bisections",
  "dead_letters", "checkpoint_quarantined".

Placement: `device=` pins a dispatch to one card by entering
`torch.cuda.device`; `mesh=` runs the grouped or per-credential mode
sharded over a gpu/shard.py Mesh instead (the two are exclusive).

The credential source is any callable `batch_index -> (sigs, messages_list)`
so a long stream never needs to exist in memory at once.

Ledgers: `verify_ledger` verifies a ledger whose records come from several
issuers, of schemas with any attribute count, through the same pipeline:
each record is routed into its issuer's batches, the verkeys are padded to
a few base counts so the batches share shape keys, and verdicts come back
per ledger segment, in ledger order.
"""

import binascii
import hashlib
import json
import os

from . import metrics
from .errors import (
    CheckpointCorruptError,
    CheckpointMismatchError,
    TransientBackendError,
)
from .obs import trace as otrace

STATE_SCHEMA_VERSION = 2


def _verkey_bytes(vk, params):
    """A verkey's canonical bytes when the GroupContext can serialize it,
    the repr of its components otherwise."""
    vkb = None
    if params is not None and vk is not None:
        try:
            vkb = vk.to_bytes(params.ctx)
        except Exception:
            vkb = None
    if vkb is None:
        vkb = repr(
            (getattr(vk, "X_tilde", None), getattr(vk, "Y_tilde", None))
        ).encode()
    return vkb


def run_fingerprint(mode, vk, params=None):
    """Digest binding a stream run's configuration: the result mode and
    the verkey (_verkey_bytes). Stored in the checkpoint so a
    resume against a DIFFERENT run fails loudly (CheckpointMismatchError)
    instead of silently merging tallies. The batch count is deliberately
    NOT part of the digest: growing a stream (resuming a 2-batch
    checkpoint with n_batches=4 to verify the next batches) is a
    first-class resume pattern — what must never change across a resume
    is WHAT is being verified (the verkey) and what the tallies mean
    (the mode)."""
    h = hashlib.sha256()
    h.update(("%s|" % (mode,)).encode())
    h.update(_verkey_bytes(vk, params))
    return h.hexdigest()[:16]


def ledger_fingerprint(mode, issuers, params=None):
    """run_fingerprint of a ledger (verify_ledger): the mode and every
    (issuer id, verkey) pair, in the order of the ids' reprs, so a resume
    under another issuer set, or another verkey for one issuer, is
    refused. The segment count and the batch width are not part of it."""
    h = hashlib.sha256()
    h.update(("ledger|%s|" % (mode,)).encode())
    for iid in sorted(issuers, key=repr):
        h.update(("%r|" % (iid,)).encode())
        h.update(_verkey_bytes(issuers[iid], params))
        h.update(b"|")
    return h.hexdigest()[:16]


def _canon_payload(payload):
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _payload_crc(payload):
    return binascii.crc32(_canon_payload(payload).encode()) & 0xFFFFFFFF


def _quarantine(path):
    """Move a corrupt state file aside (never overwrite an earlier
    quarantine) and return its new location."""
    dest = path + ".corrupt"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = "%s.corrupt-%d" % (path, n)
    os.replace(path, dest)
    return dest


class StreamState:
    """Durable checkpoint, atomically saved and integrity-checked on load.

    Fields: next_batch, verified, failed (credentials), batches_ok,
    batches_failed (grouped mode).

    On-disk format (schema v2):
      {"schema": 2, "crc32": <crc32 of the canonical payload JSON>,
       "payload": {next_batch, verified, failed, batches_ok,
                   batches_failed, fingerprint}}

    Loading validates the schema version and CRC. ANY corruption —
    truncated bytes, unparseable JSON, unknown schema, CRC mismatch,
    missing tallies — quarantines the file to `<path>.corrupt*` and starts
    fresh (`quarantined` holds the new location; counter
    "checkpoint_quarantined") instead of crashing on json.load. A stored
    run fingerprint that disagrees with `fingerprint` raises
    CheckpointMismatchError: resuming the wrong run must fail loudly, not
    silently continue someone else's tallies."""

    def __init__(self, path, fingerprint=None):
        self.path = path
        self.fingerprint = fingerprint
        self.quarantined = None
        self.next_batch = 0
        self.verified = 0
        self.failed = 0
        self.batches_ok = 0
        self.batches_failed = 0
        if path and os.path.exists(path):
            try:
                payload = self._load_checked(path)
            except CheckpointCorruptError as e:
                self.quarantined = _quarantine(path)
                metrics.count("checkpoint_quarantined")
                # flight-record the quarantine next to the state file:
                # the recent-span tail shows what the stream was doing
                # when it last wrote (no-op with tracing disabled)
                from .obs import flight as _flight

                _flight.record(
                    path,
                    "checkpoint_quarantine",
                    extra={
                        "quarantined_to": self.quarantined,
                        "detail": str(e),
                    },
                )
                return
            stored = payload.get("fingerprint")
            if (
                fingerprint is not None
                and stored is not None
                and stored != fingerprint
            ):
                raise CheckpointMismatchError(stored, fingerprint)
            self.next_batch = payload["next_batch"]
            self.verified = payload["verified"]
            self.failed = payload["failed"]
            self.batches_ok = payload.get("batches_ok", 0)
            self.batches_failed = payload.get("batches_failed", 0)

    @staticmethod
    def _load_checked(path):
        """Parse + integrity-check a state file; CheckpointCorruptError on
        any structural problem (the caller quarantines)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            doc = json.loads(raw.decode("utf-8"))
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError("unparseable checkpoint: %s" % e)
        if not isinstance(doc, dict):
            raise CheckpointCorruptError("checkpoint is not an object")
        if doc.get("schema") != STATE_SCHEMA_VERSION:
            raise CheckpointCorruptError(
                "unknown checkpoint schema %r (want %d)"
                % (doc.get("schema"), STATE_SCHEMA_VERSION)
            )
        payload = doc.get("payload")
        if not isinstance(payload, dict):
            raise CheckpointCorruptError("checkpoint missing payload")
        if _payload_crc(payload) != doc.get("crc32"):
            raise CheckpointCorruptError("checkpoint CRC mismatch")
        for k in ("next_batch", "verified", "failed"):
            if not isinstance(payload.get(k), int):
                raise CheckpointCorruptError("checkpoint missing tally %r" % k)
        return payload

    def save(self):
        if not self.path:
            return
        payload = {
            "next_batch": self.next_batch,
            "verified": self.verified,
            "failed": self.failed,
            "batches_ok": self.batches_ok,
            "batches_failed": self.batches_failed,
            "fingerprint": self.fingerprint,
        }
        doc = {
            "schema": STATE_SCHEMA_VERSION,
            "crc32": _payload_crc(payload),
            "payload": payload,
        }
        # crash-atomic (state/atomic.py — the shared tmp+fsync+replace
        # dance): a kill at any point leaves either the old complete
        # file or the new complete file at `path`, never torn bytes
        # that a restart would quarantine as `.corrupt*`
        from .state.atomic import replace_json

        replace_json(self.path, doc)


def _pin_to_device(dispatch, device):
    """Wrap a dispatch callable so its host encode + launch run with
    `device` as the current CUDA device — the placement seam of the
    per-device executor pool (serve/service.py) and of the issuance
    authorities' sign dispatch (issue/authority.py): tensors a backend on
    `cuda` creates inside land on that card, and its caches are keyed by
    the card (gpu/backend.py). device=None, or a device that is not a CUDA
    one, is the identity (stub backends, single-device services, the
    CPU)."""
    if device is None:
        return dispatch
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return dispatch

    def pinned(*args):
        with torch.cuda.device(device):
            return dispatch(*args)

    return pinned


def _dispatchers(
    backend, mode, mesh=None, device=None, mesh_pad_to=None, pad_bases_to=None
):
    """(dispatch, record, is_async) for the chosen mode. dispatch(sigs,
    msgs, vk, params) -> zero-arg finalizer; record(state, result,
    batch_size). is_async=False means dispatch computes synchronously —
    pipelining such a backend would only delay checkpoints, never overlap
    work, so verify_stream settles each batch immediately.

    pad_bases_to: vk -> the base count to pad that verkey's batches to
    (None: unpadded), handed to a per-credential `batch_verify_async`
    (a synchronous `batch_verify` runs unpadded); verify_ledger's few
    shapes over many schemas.

    mesh: run the grouped or per-credential mode sharded over a
    gpu/shard.py Mesh (config 5 over several devices: the batch is split
    across the mesh AND host encode pipelines under device execution).
    device: pin single-device dispatch to one card (_pin_to_device;
    mutually exclusive with mesh — a sharded program owns its placement).
    mesh_pad_to: fixed grouped-mode batch pad on the mesh path, so a
    serving workload with varying coalesced sizes keeps ONE program
    shape."""
    if mesh is not None:
        if device is not None:
            raise ValueError(
                "mesh and device are mutually exclusive: a sharded "
                "program spans the mesh, it cannot also pin to one device"
            )
        if mode not in ("grouped", "per_credential"):
            raise ValueError(
                "mesh streaming supports mode='grouped' or "
                "'per_credential' (got %r)" % (mode,)
            )
        needed = (
            "encode_verify_batch"
            if mode == "per_credential"
            else "encode_grouped_batch"
        )
        if not hasattr(backend, needed):
            raise ValueError(
                "backend %r cannot shard over a mesh (no %s); "
                "use the torch backend" % (backend, needed)
            )
        from .gpu import shard as _shard

        # check the mesh's axes up front with a clear error, not a bare
        # KeyError from mesh.shape['tp'] on the first batch
        if mode == "per_credential":
            _shard.require_axes(mesh, "dp", "tp")

            def dispatch(s, m, vk, params):
                return _shard.batch_verify_sharded_async(
                    backend, s, m, vk, params, mesh
                )

            return dispatch, _record_percred, True

        _shard.require_axes(mesh, "dp")

        def dispatch(s, m, vk, params):
            return _shard.batch_verify_grouped_sharded_async(
                backend, s, m, vk, params, mesh, pad_batch_to=mesh_pad_to
            )

        return dispatch, _record_grouped, True
    if mode == "per_credential":
        async_fn = getattr(backend, "batch_verify_async", None)
        if async_fn is None:

            def dispatch(s, m, vk, params):
                bits = backend.batch_verify(s, m, vk, params)
                return lambda: bits

        elif pad_bases_to is None:
            dispatch = async_fn
        else:

            def dispatch(s, m, vk, params):
                return async_fn(s, m, vk, params, pad_bases_to=pad_bases_to(vk))

        return (
            _pin_to_device(dispatch, device),
            _record_percred,
            async_fn is not None,
        )
    if mode == "grouped":
        async_fn = getattr(backend, "batch_verify_grouped_async", None)
        if async_fn is None:
            grouped = getattr(backend, "batch_verify_grouped", None)
            if grouped is None:
                raise ValueError(
                    "backend %r has no grouped verify" % (backend,)
                )

            def dispatch(s, m, vk, params):
                ok = grouped(s, m, vk, params)
                return lambda: ok

        else:
            dispatch = async_fn

        return (
            _pin_to_device(dispatch, device),
            _record_grouped,
            async_fn is not None,
        )
    if mode == "batched":
        # RLC-combined pairing check: same one-bool-per-batch
        # result shape as grouped, but the verdict comes from ONE
        # multi-Miller product under deterministic per-lane combiners
        # with a single shared final exponentiation.
        async_fn = getattr(backend, "batch_verify_combined_async", None)
        if async_fn is None:
            combined = getattr(backend, "batch_verify_combined", None)
            if combined is None:
                raise ValueError(
                    "backend %r has no combined (RLC) verify" % (backend,)
                )

            def dispatch(s, m, vk, params):
                ok = combined(s, m, vk, params)
                return lambda: ok

        else:
            dispatch = async_fn

        return (
            _pin_to_device(dispatch, device),
            _record_grouped,
            async_fn is not None,
        )
    raise ValueError("unknown stream mode %r" % (mode,))


def _record_percred(state, bits, _n):
    """Per-credential accounting: one bool per credential."""
    state.verified += sum(1 for b in bits if b)
    state.failed += sum(1 for b in bits if not b)


def _record_grouped(state, ok, n):
    """Grouped- and batched-mode accounting: one bool covers the whole
    batch, so tallies move batch-wholesale."""
    if ok:
        state.batches_ok += 1
        state.verified += n
    else:
        state.batches_failed += 1
        state.failed += n


def _fallback_dispatcher(backend, mode):
    """Synchronous dispatch on the fallback backend, in the primary mode's
    result shape. A fallback without a grouped entry point (the python
    reference) emulates the grouped verdict as all(per-credential bits) —
    same semantics, deterministic instead of 2^-128-probabilistic."""
    if mode == "grouped":
        grouped = getattr(backend, "batch_verify_grouped", None)
        if grouped is not None:
            return lambda s, m, vk, p: (lambda: bool(grouped(s, m, vk, p)))
        return lambda s, m, vk, p: (
            lambda: all(backend.batch_verify(s, m, vk, p))
        )
    if mode == "batched":
        combined = getattr(backend, "batch_verify_combined", None)
        if combined is not None:
            return lambda s, m, vk, p: (
                lambda: bool(combined(s, m, vk, p))
            )
        return lambda s, m, vk, p: (
            lambda: all(backend.batch_verify(s, m, vk, p))
        )
    return lambda s, m, vk, p: (lambda: backend.batch_verify(s, m, vk, p))


def _group_oracle(backend, vk, params, predicate="grouped"):
    """slice -> bool probe for bisection. predicate="grouped" prefers the
    backend's grouped verify; predicate="combined" prefers the RLC
    combined check — each sub-slice gets FRESH exponents derived
    from its own transcript, so a cancellation pair that fooled the
    parent draw cannot survive both child draws except w.p. <= 2^-lam.
    Either falls back to all() over per-credential bits; None if the
    backend can do neither."""
    if backend is None:
        return None
    if predicate == "combined":
        combined = getattr(backend, "batch_verify_combined", None)
        if combined is not None:
            return lambda s, m: bool(combined(s, m, vk, params))
    grouped = getattr(backend, "batch_verify_grouped", None)
    if grouped is not None:
        return lambda s, m: bool(grouped(s, m, vk, params))
    bv = getattr(backend, "batch_verify", None)
    if bv is not None:
        return lambda s, m: all(bv(s, m, vk, params))
    return None


def _make_bisector(
    backend, fallback_backend, vk, params, policy, dead_letter_path,
    program=None, predicate="grouped",
):
    """bisect(sigs, msgs, batch_index, attempts) -> culprit indices.

    A rejected grouped (or RLC-combined, predicate="combined") batch is
    recursively halved; each slice is probed with a grouped check
    (per-credential at single-credential leaves — a 1-slice grouped
    check IS the per-credential verify), probes riding the same
    retry/fallback ladder as regular dispatches. Culprits are appended
    to the dead-letter JSONL with the batch's attempt history.
    Counters: "bisections" per split, "dead_letters" per culprit."""
    from .retry import call_with_retry

    primary = _group_oracle(backend, vk, params, predicate=predicate)
    fb = _group_oracle(fallback_backend, vk, params, predicate=predicate)
    if primary is None:
        primary, fb = fb, None
    if primary is None:
        return None
    from .faults import DeadLetterLog

    log = DeadLetterLog(dead_letter_path) if dead_letter_path else None

    def check(s, m, key):
        fallback = (lambda: fb(s, m)) if fb is not None else None
        return call_with_retry(
            lambda: primary(s, m), policy, key=key, fallback=fallback
        )

    def bisect(sigs, msgs, batch_index, attempts, trace_ids=None):
        """trace_ids: optional per-credential trace ids (the serve path's
        request traces) so each dead-letter line carries ITS request's
        trace_id; None (the offline stream) falls back to the active
        bisection span's trace."""
        culprits = []

        with otrace.span("bisect", batch=batch_index, n=len(sigs)) as bspan:

            def rec(lo, hi, known_bad):
                if not known_bad and check(
                    sigs[lo:hi], msgs[lo:hi], batch_index
                ):
                    return
                if hi - lo == 1:
                    culprits.append(lo)
                    return
                metrics.count("bisections")
                mid = (lo + hi) // 2
                bspan.event("split", lo=lo, hi=hi)
                rec(lo, mid, False)
                rec(mid, hi, False)

            rec(0, len(sigs), True)
            if log is not None:
                for c in culprits:
                    log.append(
                        batch=batch_index,
                        credential=c,
                        reason="grouped batch rejected; culprit isolated by "
                        "bisection",
                        attempts=attempts,
                        trace_id=(
                            trace_ids[c]
                            if trace_ids is not None and c < len(trace_ids)
                            else None
                        ),
                        program=program,
                    )
                    metrics.count("dead_letters")
        return culprits

    return bisect


def _prefetch_launches(produce, depth):
    """Run `produce()` — a generator yielding launched batches — on a
    background worker thread, buffering at most `depth` items in a bounded
    queue: batch i+1 (and i+2, ...) encodes and dispatches while the main
    thread blocks on batch i's readback (the blocking wait releases the
    GIL, so the host-side encode genuinely overlaps it).

    Yields items in production order (the queue is FIFO, so the settle
    order and checkpoint sequence are identical to the serial path). A
    producer exception is re-raised here at the point of consumption —
    matching the serial path, where a non-retryable launch error
    propagates before later batches run. When the consumer abandons the
    generator (e.g. a settle raised), the worker is told to stop and the
    queue drained so a blocked put can finish.

    Observability: the "prefetch_wait" timer accumulates main-thread
    seconds blocked on the queue (near zero = the worker keeps the device
    fed) and "prefetched_batches" counts deliveries."""
    import queue as queue_mod
    import threading

    from . import metrics

    q = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                continue

    def work():
        try:
            for item in produce():
                if stop.is_set():
                    return
                _put((None, item))
            _put((None, done))
        except BaseException as e:  # re-raised on the consuming thread
            _put((e, None))

    t = threading.Thread(
        target=work, name="coconut-encode-prefetch", daemon=True
    )
    t.start()
    try:
        while True:
            with metrics.timer("prefetch_wait"):
                exc, item = q.get()
            if exc is not None:
                raise exc
            if item is done:
                return
            metrics.count("prefetched_batches")
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        t.join(timeout=5.0)


def verify_stream(
    source,
    n_batches,
    vk,
    params,
    backend,
    state_path=None,
    on_batch=None,
    mode="per_credential",
    pipeline=True,
    mesh=None,
    pipeline_depth=3,
    prefetch_depth=2,
    retry_policy=None,
    fallback_backend=None,
    dead_letter_path=None,
    bisect_failures=None,
):
    """Verify `n_batches` batches from `source(i) -> (sigs, messages_list)`.

    Resumes from `state_path` if present (batch granularity). Returns the
    final StreamState. `on_batch(i, result)` is called after each batch
    with the mode's result type (bools list / one bool) — the hook for
    collecting results or metrics. `pipeline=True` overlaps host encode of
    batch i+1 with device execution of batch i when the backend supports
    async dispatch; `pipeline_depth` batches stay in flight before the
    oldest is settled, keeping the device queue non-empty across the
    result-readback round trip. Checkpoint lag is bounded by the depth: a crash
    re-runs at most `pipeline_depth` batches (at-least-once delivery, same
    as depth 1). `prefetch_depth` (when pipelining) moves `source(i)` and
    the host encode+dispatch onto a bounded background worker so batch
    i+1 encodes while the main thread blocks on batch i's readback —
    see _prefetch_launches; 0 disables the worker (encode stays on the
    calling thread, still overlapped with device execution by async
    dispatch alone). Checkpoint-lag and delivery semantics are unchanged:
    the worker only ENCODES ahead; settle order, retry accounting, and
    checkpoint writes stay on the calling thread, so a crash still re-runs
    at most `pipeline_depth` batches. `mesh` shards the grouped or
    per-credential mode over a gpu/shard.py Mesh.

    backend: an instance or a registry name; None is a TorchBackend on
    `cuda` (raises without a card), as for every entry point of the
    port.

    Fault tolerance (module docstring for the full story):
      retry_policy      — retry.RetryPolicy; a batch whose dispatch or
                          readback raises TransientBackendError re-runs
                          the full dispatch+readback cycle with backoff,
                          up to the policy's attempt cap. None = one
                          attempt.
      fallback_backend  — backend instance or registry name ("spec");
                          after retries exhaust, the batch re-dispatches
                          here synchronously so the stream completes
                          degraded. None = exhaustion propagates (the
                          checkpoint still allows resuming at the failed
                          batch).
      dead_letter_path  — JSONL file receiving culprit credentials from
                          grouped-failure bisection.
      bisect_failures   — force grouped-failure bisection on/off; default
                          (None) enables it in grouped and batched (RLC
                          combined) modes when a dead_letter_path
                          is given. When a rejected
                          grouped batch is bisected, `failed` counts only
                          the culprits (granular accounting) while
                          `batches_failed` still counts the batch; the
                          raw grouped verdict (False) is what on_batch
                          sees.

    The checkpoint at `state_path` carries a schema version, a payload
    CRC, and this run's fingerprint (mode, vk digest): corrupt
    files are quarantined to `<state_path>.corrupt*` and the stream
    restarts cleanly; a fingerprint mismatch raises
    CheckpointMismatchError."""
    sup = _Supervisor(
        backend, mode, retry_policy, fallback_backend, pipeline,
        pipeline_depth, prefetch_depth, mesh=mesh,
    )
    backend, policy = sup.backend, sup.policy
    if bisect_failures is None:
        bisect_failures = (
            mode in ("grouped", "batched") and dead_letter_path is not None
        )
    bisector = None
    if bisect_failures and mode in ("grouped", "batched"):
        bisector = _make_bisector(
            backend, sup.fallback_backend, vk, params, policy, dead_letter_path,
            predicate="combined" if mode == "batched" else "grouped",
        )

    fingerprint = None
    if state_path:
        fingerprint = run_fingerprint(mode, vk, params)
    state = StreamState(state_path, fingerprint=fingerprint)

    def settle(idx, finalize, n, sigs, msgs, attempts, bspan):
        with otrace.use(bspan):
            try:
                with otrace.span("device"):
                    result = finalize()
            except BaseException as e:
                bspan.end(error=type(e).__name__)
                raise
            if bisector is not None and not result:
                culprits = bisector(sigs, msgs, idx, attempts)
                state.batches_failed += 1
                state.failed += len(culprits)
                state.verified += n - len(culprits)
            else:
                sup.record(state, result, n)
            # deliver results BEFORE persisting the checkpoint: a crash
            # inside on_batch then re-runs the batch (at-least-once
            # delivery) instead of silently dropping its verdicts
            if on_batch is not None:
                on_batch(idx, result)
            state.next_batch = idx + 1
            state.save()
            bspan.event("checkpoint", next_batch=idx + 1)
        bspan.end(
            ok=bool(result) if not isinstance(result, list) else None
        )

    def launched():
        for i in range(state.next_batch, n_batches):
            sigs, messages_list = source(i)
            finalize, attempts, bspan = sup.launch(
                i, sigs, messages_list, vk, params
            )
            yield (
                i,
                finalize,
                len(sigs),
                sigs,
                messages_list,
                attempts,
                bspan,
            )

    sup.drive(launched, settle)
    return state


class _Supervisor:
    """What verify_stream and verify_ledger share: the backend, the
    mode's dispatch and accounting (_dispatchers), the retry policy and
    the fallback, each batch's launch under them, and the pipeline that
    settles launched batches in order (`drive`)."""

    def __init__(
        self, backend, mode, retry_policy, fallback_backend, pipeline,
        pipeline_depth, prefetch_depth, mesh=None, pad_bases_to=None,
    ):
        from .backend import get_backend
        from .retry import RetryPolicy

        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch")
        self.backend = backend
        self.dispatch, self.record, is_async = _dispatchers(
            backend, mode, mesh=mesh, pad_bases_to=pad_bases_to
        )
        # sync backends: settle immediately
        self.pipeline = pipeline and is_async
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0")
        self.pipeline_depth, self.prefetch_depth = pipeline_depth, prefetch_depth
        if isinstance(fallback_backend, str):
            fallback_backend = get_backend(fallback_backend)
        self.fallback_backend = fallback_backend
        self.fallback_dispatch = (
            _fallback_dispatcher(fallback_backend, mode)
            if fallback_backend is not None
            else None
        )
        policy = retry_policy
        if policy is None:
            # no retry ladder: transient errors go straight to the fallback
            # when one exists, else propagate exactly as they always did
            policy = RetryPolicy(
                max_attempts=1,
                base_delay=0.0,
                retryable=(
                    (TransientBackendError,)
                    if self.fallback_dispatch is not None
                    else ()
                ),
            )
        self.policy = policy

    def launch(self, i, sigs, msgs, vk, params):
        """Dispatch batch i now (pipelining) and return (finalize,
        attempts, span). finalize() re-runs the whole dispatch+readback
        cycle under the retry ladder, then the fallback, before giving
        up. The batch's "stream_batch" trace starts here (possibly on the
        prefetch worker thread) and is handed to settle() with the rest
        of the launch state."""
        from .retry import call_with_retry, note_attempt

        dispatch, policy = self.dispatch, self.policy
        attempts = []
        box = [None]
        bspan = otrace.start_span(
            "stream_batch", root=True, batch=i, n=len(sigs)
        )
        with otrace.use(bspan):
            with otrace.span("dispatch", backend=type(self.backend).__name__):
                try:
                    box[0] = dispatch(sigs, msgs, vk, params)
                except policy.retryable as e:
                    note_attempt(attempts, e)
                    otrace.event(
                        "attempt_failed",
                        attempt=len(attempts),
                        error=type(e).__name__,
                    )

        def cycle():
            fin, box[0] = box[0], None
            if fin is None:
                fin = dispatch(sigs, msgs, vk, params)
            return fin()

        fallback = (
            (lambda: self.fallback_dispatch(sigs, msgs, vk, params)())
            if self.fallback_dispatch is not None
            else None
        )

        def finalize():
            return call_with_retry(
                cycle, policy, key=i, attempts=attempts, fallback=fallback
            )

        return finalize, attempts, bspan

    def drive(self, produce, settle):
        """Settle every item of `produce()` (a generator of launched
        batches) in order: at most `pipeline_depth` in flight, the
        launches on the prefetch worker when pipelining with a
        `prefetch_depth`."""
        pipeline = self.pipeline
        launched = (
            _prefetch_launches(produce, self.prefetch_depth)
            if pipeline and self.prefetch_depth > 0
            else produce()
        )
        pending = []  # [(index, finalize, batch_size, sigs, msgs, attempts, span)]
        try:
            for item in launched:
                if not pipeline:
                    settle(*item)
                    continue
                pending.append(item)
                if len(pending) >= self.pipeline_depth:
                    settle(*pending.pop(0))
        finally:
            # a settle error must tear the prefetch worker down NOW, not at
            # GC (the propagating traceback pins this frame — and with it
            # the generator — alive), so the worker never lingers blocked
            # on a full queue
            launched.close()
        for p in pending:
            settle(*p)


def _pad_classes(issuers):
    """vk -> the base count verify_ledger pads that verkey's batches to, in
    two classes: the ledger's largest base count m, and (m + 1) // 2 for
    the verkeys it holds. The comb MSM's device time grows with the base
    count: at B = 4,096 on an H100 padding 3 bases to 9 cost 17 % of the
    padded batch's device time, to 5 bases 6 % (PERF.md)."""
    m = 1 + max(len(vk.Y_tilde) for vk in issuers.values())
    half = (m + 1) // 2
    return lambda vk: half if 1 + len(vk.Y_tilde) <= half else m


def verify_ledger(
    source,
    n_segments,
    issuers,
    params,
    backend,
    batch=4096,
    state_path=None,
    on_segment=None,
    mode="per_credential",
    pipeline_depth=3,
    prefetch_depth=2,
    retry_policy=None,
    fallback_backend=None,
):
    """Verify a ledger of credentials from several issuers, in ledger
    order, through verify_stream's pipeline with routing in front.

    source(i) -> ledger segment i as records [(sig, messages, issuer_id)];
    issuers: {issuer_id: verkey}, all under `params`, their schemas of any
    attribute counts. Each record is routed into its issuer's queue (span
    `route`, one a segment, on the thread that calls `source`); a queue
    that holds `batch` records is dispatched as one batch under its
    issuer's verkey, through the same dispatch, pipeline depth, prefetch
    worker, retry policy, fallback and StreamState as verify_stream. At
    the end of the ledger each issuer's tail is dispatched too; in mode
    "per_credential" it is filled to `batch` with identity lanes
    (serve.batcher.PAD_CREDENTIAL), whose verdicts are dropped, so every
    batch has one width.

    Each verkey is padded (identity bases, zero scalars) to one of two
    base counts, the ledger's largest m and (m + 1) // 2 (_pad_classes), so
    issuers of different schemas share two shape keys and, on `cuda`, two
    CUDA graphs of the backend's four, each replay copying in its own
    issuer's tables: a per-credential `batch_verify_async` is handed
    `pad_bases_to`, as TorchBackend's takes it.

    on_segment(i, verdicts) fires once every record of segment i has
    settled, segments in order, with one verdict per record in ledger
    order: a bool per record in mode "per_credential"; in modes "grouped"
    and "batched" each record gets its issuer batch's one bool (no
    bisection). Padded lanes never reach it. Returns the final StreamState:
    `next_batch` is the next segment to deliver, `verified` / `failed`
    count the delivered records.

    The checkpoint at `state_path` is the highest segment below which
    every record has settled and been delivered; its fingerprint
    (ledger_fingerprint) digests the mode and every (issuer_id, verkey)
    pair, so a resume under another issuer set raises
    CheckpointMismatchError. Delivery is at-least-once: a crash re-runs
    every record from the checkpoint's segment on, that is the records of
    the batches in flight (at most pipeline_depth + prefetch_depth + 1), of
    the partly filled queues (fewer than `batch` an issuer), and every
    record routed after the oldest of those. With k issuers of equal
    share that is at most about (k + pipeline_depth + prefetch_depth + 1)
    * batch records; an issuer with a small share holds the checkpoint
    back until its queue fills, and every record routed meanwhile re-runs.

    Counters: "ledger_dispatches" (issuer batches), "ledger_lanes" (their
    lanes, padding included), "ledger_pad_lanes"."""
    import threading

    from .serve.batcher import PAD_CREDENTIAL

    if batch < 1:
        raise ValueError("batch must be >= 1 (got %r)" % (batch,))
    if not issuers:
        raise ValueError("a ledger needs at least one issuer")
    sup = _Supervisor(
        backend, mode, retry_policy, fallback_backend, True,
        pipeline_depth, prefetch_depth,
        pad_bases_to=_pad_classes(issuers) if mode == "per_credential" else None,
    )
    fingerprint = ledger_fingerprint(mode, issuers, params) if state_path else None
    state = StreamState(state_path, fingerprint=fingerprint)
    pad_tails = mode == "per_credential"

    # ledger order: verdicts[i][pos] of segment i, remaining[i] records of
    # it unsettled; made by the routing thread before any batch holding
    # its records is launched, filled by the settling thread
    verdicts, remaining = {}, {}
    lock = threading.Lock()

    def batches():
        queues = {iid: [] for iid in issuers}
        job = 0
        for i in range(state.next_batch, n_segments):
            records = source(i)
            full = []
            with otrace.span("route", segment=i, n=len(records)):
                with lock:
                    verdicts[i] = [None] * len(records)
                    remaining[i] = len(records)
                for pos, (sig, msgs, iid) in enumerate(records):
                    try:
                        q = queues[iid]
                    except KeyError:
                        raise ValueError(
                            "segment %d record %d names issuer %r, not in "
                            "the ledger's issuers" % (i, pos, iid)
                        ) from None
                    q.append((i, pos, sig, msgs))
                    if len(q) == batch:
                        full.append((iid, q))
                        queues[iid] = []
            for iid, lanes in full:
                yield launch(job, iid, lanes)
                job += 1
        for iid, lanes in queues.items():
            if lanes:
                yield launch(job, iid, lanes)
                job += 1

    def launch(job, iid, lanes):
        sigs = [s for _, _, s, _ in lanes]
        msgs = [m for _, _, _, m in lanes]
        n_pad = batch - len(lanes) if pad_tails else 0
        if n_pad:
            sigs += [PAD_CREDENTIAL] * n_pad
            msgs += [list(msgs[0])] * n_pad
        metrics.count("ledger_dispatches")
        metrics.count("ledger_lanes", len(sigs))
        if n_pad:
            metrics.count("ledger_pad_lanes", n_pad)
        finalize, attempts, bspan = sup.launch(job, sigs, msgs, issuers[iid], params)
        return job, finalize, lanes, attempts, bspan

    def settle(job, finalize, lanes, attempts, bspan):
        with otrace.use(bspan):
            try:
                with otrace.span("device"):
                    result = finalize()
            except BaseException as e:
                bspan.end(error=type(e).__name__)
                raise
            per_lane = isinstance(result, list)
            with lock:
                for lane, (i, pos, _, _) in enumerate(lanes):
                    verdicts[i][pos] = bool(result[lane] if per_lane else result)
                    remaining[i] -= 1
            deliver()
        bspan.end(ok=None if per_lane else bool(result))

    def deliver():
        """Hand on every segment, in order, whose records have all
        settled; checkpoint after each."""
        while state.next_batch < n_segments:
            i = state.next_batch
            with lock:
                if remaining.get(i) != 0:
                    return
                out = verdicts.pop(i)
                del remaining[i]
            # deliver BEFORE persisting the checkpoint: a crash inside
            # on_segment re-runs the segment (at-least-once)
            if on_segment is not None:
                on_segment(i, out)
            ok = sum(out)
            state.verified += ok
            state.failed += len(out) - ok
            state.next_batch = i + 1
            state.save()

    sup.drive(batches, settle)
    deliver()  # segments with no records left at the end
    return state
