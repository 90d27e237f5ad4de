"""Deterministic fault injection and the dead-letter sink — the port's
copy of the verify and sign halves of `coconut_tpu/faults.py`.

  - `FaultyBackend` wraps any verify-capable backend and injects scheduled
    faults at exactly the seams `stream.verify_stream` and the serve
    engine dispatch through: raise-on-Nth-dispatch transient errors,
    flipped verdicts, corrupted (raising) finalizers, latency, executor
    loop crashes (`InjectedCrash`, a BaseException that escapes the
    per-batch containment) and hung dispatches (blocking on
    `hang_release`; `hang_entered` is the test's sync point, `hang_max_s`
    bounds an un-released hang). Schedules address dispatches by one
    0-based global index, so every fault is reproducible. Its sign seam
    (`batch_blind_sign`, the issuance authorities' dispatch) has
    schedules and a counter of its own.

  - `DeadLetterLog` is the append-only JSONL file that receives culprit
    credentials isolated by grouped-failure bisection: one object per
    line with the batch index, the credential's index within the batch,
    a reason, the batch's retry attempt history, the trace ids, the
    program and the nullifier field (schema 4, the reference's). It
    rotates (`<path>.1`, `.2`, ...) at a size or record-count cap, each
    append triggers the flight recorder (obs/flight.py), and with a
    `store` each append is also indexed into the state plane.

  - `SimulatedCrash`, `WalChaos` and `ReplicationChaos` inject crashes,
    torn writes, fsync failures and dropped anti-entropy pulls into the
    durable state plane (state/); `ChaosSchedule` is a declarative
    dispatch-index schedule that wraps backends in FaultyBackend and
    describes itself for reports.
"""

import json
import os
import threading
import time

from . import metrics
from .errors import TransientBackendError
from .obs import flight as _flight
from .obs import trace as otrace

#: dead-letter JSONL schema (the reference's): v2 added trace_id/span_id,
#: v3 the engine program name, v4 `nullifier` (absent fields read as null)
DEAD_LETTER_SCHEMA = 4


class InjectedCrash(BaseException):
    """Deterministic executor-loop crash injection. Derives from
    BaseException ON PURPOSE: the serve layer's per-batch containment
    (`except Exception` in _launch/_settle) must NOT catch it — it
    escapes to the executor loop's crash handler, modeling a genuine code
    bug in the dispatch path rather than a batch-level backend fault."""


class SimulatedCrash(Exception):
    """A process kill simulated at a named durability seam, raised by
    `WalChaos.crash(point)` inside the WAL / StateStore write paths.
    Unlike `InjectedCrash` this is a plain Exception: a crash-point
    harness catches it at the call site and abandons the store object
    mid-operation, as a SIGKILL would abandon the process, then reopens
    the directory to show that replay converges."""


class WalChaos:
    """Deterministic fault schedule for the durable state plane
    (state/wal.py, state/store.py).

      crash_at       — named crash points ("wal.pre_append",
                       "wal.post_append", "store.mid_snapshot",
                       "store.mid_compact") at which `crash()` raises
                       SimulatedCrash; each fires every time it is hit,
                       so remove the point (or swap the chaos object)
                       before re-driving a recovered store;
      torn_on        — 0-based WAL append indices that write only a
                       PREFIX of the frame (fsync'd, so the torn bytes
                       really land on disk) then raise — the
                       mid-record kill, counted in `torn_writes`;
      fsync_fail_on  — 0-based WAL fsync indices that raise OSError
                       instead of syncing (a dying disk).

    All schedules are index-based and deterministic, the same
    discipline as FaultyBackend's dispatch schedules."""

    def __init__(self, crash_at=(), torn_on=(), fsync_fail_on=()):
        self.crash_at = set(crash_at)
        self.torn_on = set(torn_on)
        self.fsync_fail_on = set(fsync_fail_on)
        self.torn_writes = 0
        self.crashes = 0
        self._fsyncs = 0

    def crash(self, point):
        if point in self.crash_at:
            self.crashes += 1
            raise SimulatedCrash("injected crash at %s" % point)

    def fsync_fails(self):
        idx = self._fsyncs
        self._fsyncs += 1
        return idx in self.fsync_fail_on

    def error(self, message):
        return SimulatedCrash(message)


class ReplicationChaos:
    """Replication-gap injection for the anti-entropy path
    (state/replicate.py): `drop_pairs` is a set of (peer_id, keyspace)
    pairs — with keyspace None matching every keyspace — whose pulls
    are swallowed (counted under "state_antientropy_dropped"). Dropped
    pulls retry on a later step, so clearing the schedule demonstrates
    convergence-after-heal."""

    def __init__(self, drop_pairs=()):
        self.drop_pairs = set(drop_pairs)
        self.dropped = 0

    def drop(self, peer, keyspace):
        hit = (peer, keyspace) in self.drop_pairs or (
            peer,
            None,
        ) in self.drop_pairs
        if hit:
            self.dropped += 1
        return hit

    def heal(self):
        self.drop_pairs.clear()


_SYNC_VERIFY = frozenset({
    "batch_verify",
    "batch_verify_grouped",
    "batch_verify_combined",
    "batch_show_verify_combined",
})
_ASYNC_VERIFY = frozenset({
    "batch_verify_async",
    "batch_verify_grouped_async",
    "batch_verify_combined_async",
})


class FaultyBackend:
    """Capability-transparent fault-injecting wrapper around a backend.

    Attribute access delegates to the wrapped backend, so a wrapped
    backend exposes exactly the verify capabilities of the inner one
    (`hasattr` probes in stream._dispatchers see through the wrapper).
    A single dispatch counter ticks across all wrapped verify methods;
    schedules address dispatches by that 0-based global index:

      raise_every=N  — every Nth dispatch (indices N-1, 2N-1, ...) raises
                       `error` at dispatch time, before the inner backend
                       runs (a device/tunnel failure on submit);
      raise_on       — explicit dispatch indices that raise at dispatch;
      flip_on        — dispatch indices whose verdicts are negated
                       (elementwise for per-credential lists, the single
                       bool for grouped) — a miscompute, not a crash;
      corrupt_finalizer_on — dispatch indices whose readback raises
                       `error`: for async seams the returned finalizer
                       raises when settled; for sync seams the call raises
                       after the inner compute (the result is lost in
                       flight);
      delay_every=N / delay_on — dispatch indices that `sleep(delay_s)`
                       BEFORE the inner backend runs (a slow device, not a
                       dead one): deterministic latency injection for the
                       serving layer's deadline-flush and timeout tests.
                       `sleep` is injectable (default time.sleep) so those
                       tests can record the scheduled delays instead of
                       actually waiting.
      crash_on       — dispatch indices that raise `InjectedCrash` (a
                       BaseException: escapes per-batch containment and
                       crashes the executor LOOP — the quarantine +
                       redistribution path, not the retry ladder);
      hang_every=N / hang_on — dispatch indices that BLOCK on the
                       `hang_release` event instead of returning (a wedged
                       device: only the serve watchdog frees its batch).
                       `hang_entered` is set when a hang begins (the
                       test's deterministic sync point); `hang_max_s`
                       bounds an un-released hang.

    Schedule sets are plain attributes and may be reassigned mid-run
    (e.g. ``fb.crash_on = frozenset({fb.dispatches})`` to crash the NEXT
    dispatch) — the probe/bench chaos phases schedule faults relative to
    the live dispatch counter this way.

    SIGN-PATH seams (threshold issuance, issue/): an authority dispatches
    `batch_blind_sign` through its backend object when it has one, and
    this wrapper always does. Sign dispatches tick their own 0-based
    counter (`sign_dispatches`), apart from the verify counter:

      fail_sign_on    — sign dispatch indices that raise `error` before
                        the inner signer runs (a transient authority
                        fault: the quorum layer re-covers around it);
      crash_sign_on   — sign dispatch indices that raise `InjectedCrash`
                        (crashes the authority loop: quarantine and
                        re-coverage from spares);
      hang_sign_on    — sign dispatch indices that block on the shared
                        `hang_release` event (a wedged authority: only
                        the issue watchdog frees its fan-out);
      corrupt_partial_on — sign dispatch indices whose first partial
                        comes back with c_tilde_2 displaced by its own h:
                        a valid point that no longer interpolates, which
                        only the verify-before-release gate catches
                        (`corrupted_partials` counts them).

    `error` is the exception class raised (default TransientBackendError;
    pass e.g. RuntimeError to model a permanent fault)."""

    def __init__(
        self,
        inner,
        raise_every=None,
        raise_on=(),
        flip_on=(),
        corrupt_finalizer_on=(),
        delay_every=None,
        delay_on=(),
        delay_s=0.0,
        crash_on=(),
        hang_every=None,
        hang_on=(),
        hang_release=None,
        hang_max_s=30.0,
        fail_sign_on=(),
        crash_sign_on=(),
        hang_sign_on=(),
        corrupt_partial_on=(),
        sleep=time.sleep,
        error=TransientBackendError,
    ):
        self.inner = inner
        self.raise_every = raise_every
        self.raise_on = frozenset(raise_on)
        self.flip_on = frozenset(flip_on)
        self.corrupt_finalizer_on = frozenset(corrupt_finalizer_on)
        self.delay_every = delay_every
        self.delay_on = frozenset(delay_on)
        self.delay_s = delay_s
        self.crash_on = frozenset(crash_on)
        self.hang_every = hang_every
        self.hang_on = frozenset(hang_on)
        self.hang_release = (
            hang_release if hang_release is not None else threading.Event()
        )
        self.hang_entered = threading.Event()
        self.hang_max_s = hang_max_s
        self.fail_sign_on = frozenset(fail_sign_on)
        self.crash_sign_on = frozenset(crash_sign_on)
        self.hang_sign_on = frozenset(hang_sign_on)
        self.corrupt_partial_on = frozenset(corrupt_partial_on)
        self.hangs = 0
        self.crashes = 0
        self.corrupted_partials = 0
        self.sleep = sleep
        self.error = error
        self.dispatches = 0
        self.sign_dispatches = 0

    def _tick(self):
        idx = self.dispatches
        self.dispatches += 1
        return idx

    def _sign_tick(self):
        idx = self.sign_dispatches
        self.sign_dispatches += 1
        return idx

    def _dispatch_faulted(self, idx):
        if self.raise_every and (idx + 1) % self.raise_every == 0:
            return True
        return idx in self.raise_on

    def _dispatch_delayed(self, idx):
        if self.delay_every and (idx + 1) % self.delay_every == 0:
            return True
        return idx in self.delay_on

    def _maybe_delay(self, idx):
        if self.delay_s and self._dispatch_delayed(idx):
            self.sleep(self.delay_s)

    def _dispatch_hangs(self, idx):
        if self.hang_every and (idx + 1) % self.hang_every == 0:
            return True
        return idx in self.hang_on

    def _maybe_crash(self, idx, name):
        if idx in self.crash_on:
            self.crashes += 1
            raise InjectedCrash(
                "injected executor crash #%d (%s)" % (idx, name)
            )

    def _maybe_hang(self, idx):
        if self._dispatch_hangs(idx):
            self.hangs += 1
            # deterministic hang: block until the harness releases it —
            # no sleeps, and hang_max_s keeps an un-released hang from
            # wedging a whole test run
            self.hang_entered.set()
            self.hang_release.wait(self.hang_max_s)

    def _mangle(self, idx, result):
        if idx in self.flip_on:
            if isinstance(result, list):
                return [not b for b in result]
            if isinstance(result, tuple) and len(result) == 2:
                # batch_show_verify_combined's (schnorr bits, pairing ok)
                bits, ok = result
                return ([not b for b in bits], not ok)
            return not result
        return result

    def batch_blind_sign(self, sig_requests, sigkey, params):
        """The authority-side sign seam: ticks the sign counter, applies
        the sign schedules, and delegates to the inner backend's own
        `batch_blind_sign` when it has one, else to
        `signature.batch_blind_sign` with the inner backend's MSMs."""
        idx = self._sign_tick()
        if idx in self.crash_sign_on:
            self.crashes += 1
            raise InjectedCrash("injected authority crash on sign dispatch #%d" % idx)
        if idx in self.fail_sign_on:
            raise self.error("injected sign-dispatch fault #%d" % idx)
        if idx in self.hang_sign_on:
            self.hangs += 1
            self.hang_entered.set()
            self.hang_release.wait(self.hang_max_s)
        inner_sign = getattr(self.inner, "batch_blind_sign", None)
        if inner_sign is not None:
            out = inner_sign(sig_requests, sigkey, params)
        else:
            from .signature import batch_blind_sign as _bbs

            out = _bbs(sig_requests, sigkey, params, backend=self.inner)
        if idx in self.corrupt_partial_on and out:
            # displace the first partial's c_tilde_2 by its own h: still a
            # point of the group, but the share no longer interpolates
            from .signature import BlindSignature

            bs = out[0]
            ops = params.ctx.sig
            out = [
                BlindSignature(bs.h, (bs.blinded[0], ops.add(bs.blinded[1], bs.h)))
            ] + list(out[1:])
            self.corrupted_partials += 1
        return out

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in _SYNC_VERIFY:

            def sync_injected(*args, **kwargs):
                idx = self._tick()
                self._maybe_crash(idx, name)
                if self._dispatch_faulted(idx):
                    raise self.error(
                        "injected dispatch fault #%d (%s)" % (idx, name)
                    )
                self._maybe_hang(idx)
                self._maybe_delay(idx)
                result = attr(*args, **kwargs)
                if idx in self.corrupt_finalizer_on:
                    raise self.error(
                        "injected readback fault #%d (%s)" % (idx, name)
                    )
                return self._mangle(idx, result)

            return sync_injected
        if name in _ASYNC_VERIFY:

            def async_injected(*args, **kwargs):
                idx = self._tick()
                self._maybe_crash(idx, name)
                if self._dispatch_faulted(idx):
                    raise self.error(
                        "injected dispatch fault #%d (%s)" % (idx, name)
                    )
                self._maybe_delay(idx)
                fin = attr(*args, **kwargs)

                def finalize():
                    # async seams hang at READBACK: the launch returned,
                    # the result never arrives
                    self._maybe_hang(idx)
                    if idx in self.corrupt_finalizer_on:
                        raise self.error(
                            "injected finalizer fault #%d (%s)" % (idx, name)
                        )
                    return self._mangle(idx, fin())

                return finalize

            return async_injected
        return attr


class ChaosSchedule:
    """A declarative chaos experiment: WHICH 0-based dispatch indices
    crash, hang, fault, flip, or stall — one object a test, probe, or
    bench lane can both APPLY (`wrap()` a backend) and DESCRIBE
    (`describe()` into a report). Everything stays deterministic: the
    schedule is pure data, the wrapped FaultyBackend's single dispatch
    counter drives it, and `release_hangs()` is the only side-effectful
    control (freeing every hung dispatch across every wrapped backend —
    call it before drain so abandoned workers exit promptly)."""

    def __init__(
        self,
        crash_on=(),
        hang_on=(),
        fault_on=(),
        flip_on=(),
        delay_on=(),
        delay_s=0.0,
        fail_sign_on=(),
        crash_sign_on=(),
        hang_sign_on=(),
        corrupt_partial_on=(),
    ):
        self.crash_on = frozenset(crash_on)
        self.hang_on = frozenset(hang_on)
        self.fault_on = frozenset(fault_on)
        self.flip_on = frozenset(flip_on)
        self.delay_on = frozenset(delay_on)
        self.delay_s = delay_s
        self.fail_sign_on = frozenset(fail_sign_on)
        self.crash_sign_on = frozenset(crash_sign_on)
        self.hang_sign_on = frozenset(hang_sign_on)
        self.corrupt_partial_on = frozenset(corrupt_partial_on)
        self.backends = []

    def wrap(self, inner, **kwargs):
        """FaultyBackend over `inner` carrying this schedule; extra
        kwargs (sleep, error, hang_max_s, ...) pass through."""
        fb = FaultyBackend(
            inner,
            raise_on=self.fault_on,
            flip_on=self.flip_on,
            delay_on=self.delay_on,
            delay_s=self.delay_s,
            crash_on=self.crash_on,
            hang_on=self.hang_on,
            fail_sign_on=self.fail_sign_on,
            crash_sign_on=self.crash_sign_on,
            hang_sign_on=self.hang_sign_on,
            corrupt_partial_on=self.corrupt_partial_on,
            **kwargs,
        )
        self.backends.append(fb)
        return fb

    def release_hangs(self):
        for fb in self.backends:
            fb.hang_release.set()

    def describe(self):
        """JSON-ready description for bench/probe reports."""
        return {
            "crash_on": sorted(self.crash_on),
            "hang_on": sorted(self.hang_on),
            "fault_on": sorted(self.fault_on),
            "flip_on": sorted(self.flip_on),
            "delay_on": sorted(self.delay_on),
            "delay_s": self.delay_s,
            "fail_sign_on": sorted(self.fail_sign_on),
            "crash_sign_on": sorted(self.crash_sign_on),
            "hang_sign_on": sorted(self.hang_sign_on),
            "corrupt_partial_on": sorted(self.corrupt_partial_on),
        }


class DeadLetterLog:
    """Append-only JSONL sink for credentials the stream could not accept.

    One object per line, keys sorted for grep-ability (schema v4):
      {"attempts": [...], "batch": int, "credential": int,
       "nullifier": str|null, "reason": str, "schema": 4,
       "span_id": int|null, "trace_id": str|null}
    where `credential` is the index WITHIN the batch, `attempts` is the
    batch's retry attempt history (retry.note_attempt records),
    trace_id/span_id join the line to its request's span tree (null with
    tracing disabled), and `nullifier` is the spent-nullifier hex digest
    on show-verify double-spend rejections (null everywhere else).

    Disk-bounded: before an append that would cross `max_bytes` or
    `max_records`, the file rotates aside (`<path>.1` newest ..
    `<path>.<keep>` oldest, via obs/flight.rotate_if_needed — the same
    cap discipline the flight-recorder sidecar uses). `read()` reads ONE
    file; pass the rotated names explicitly to walk history.

    Given a `store` (state/store.py StateStore), every append is also
    indexed into its "deadletter" keyspace — key
    `<batch>/<credential>/<n>` -> the record — so the dead-letter index
    survives restarts via WAL replay and replicates with the rest of the
    state plane. The JSONL file stays the grep-able source of truth; the
    store index is lazy-durability (fsync=False: losing the last few
    index entries on a crash is acceptable, the JSONL line is what
    operators act on)."""

    def __init__(
        self,
        path,
        max_bytes=_flight.FLIGHT_MAX_BYTES,
        max_records=None,
        keep=_flight.FLIGHT_KEEP,
        store=None,
    ):
        self.path = path
        self.max_bytes = max_bytes
        self.max_records = max_records
        self.keep = keep
        self.store = store
        self._indexed = 0  # store-index sequence (uniquifies keys)
        self._records = None  # lazy line count of the live file

    def append(
        self,
        batch,
        credential,
        reason,
        attempts=(),
        trace_id=None,
        span_id=None,
        program=None,
        nullifier=None,
    ):
        """Append one culprit record. trace_id/span_id default to the
        ACTIVE span's (the bisection span, within the batch trace) when
        tracing is enabled; the serve path overrides trace_id with the
        culprit request's own. `program` names the engine program whose
        batch produced the culprit (schema v3); `nullifier` is the spent
        digest on double-spend rejections (schema v4). Triggers a
        flight-recorder dump for the recorded trace."""
        cur = otrace.current()
        if cur is not None:
            if trace_id is None:
                trace_id = cur.trace_id
            if span_id is None:
                span_id = cur.span_id
        rec = {
            "schema": DEAD_LETTER_SCHEMA,
            "batch": int(batch),
            "credential": int(credential),
            "reason": reason,
            "attempts": list(attempts),
            "trace_id": trace_id,
            "span_id": span_id,
            "program": program,
            "nullifier": nullifier,
        }
        if self._records is None:
            self._records = (
                len(DeadLetterLog.read(self.path))
                if self.max_records is not None
                else 0
            )
        if _flight.rotate_if_needed(
            self.path,
            max_bytes=self.max_bytes,
            max_records=self.max_records,
            keep=self.keep,
            record_count=self._records,
        ):
            self._records = 0
        # lint: allow(durability, append-only JSONL; read() skips+counts a
        # torn tail, so a crash mid-append loses at most this one record)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._records += 1
        if self.store is not None:
            self._indexed += 1
            try:
                self.store.put(
                    "deadletter",
                    "%d/%d/%d"
                    % (rec["batch"], rec["credential"], self._indexed),
                    rec,
                    fsync=False,
                )
            except Exception:
                # the JSONL line already landed: a failing durable
                # index must not turn a dead-letter append into a
                # second failure
                metrics.count("dead_letter_index_errors")
        _flight.record(
            self.path,
            "dead_letter",
            trace_id=trace_id,
            extra={
                "batch": rec["batch"],
                "credential": rec["credential"],
                "program": program,
            },
        )
        return rec

    @staticmethod
    def read(path):
        """All records in `path` (empty list if it does not exist).
        Older records are normalized on read: absent trace fields become
        null (pre-v2), absent program becomes null (pre-v3), absent
        nullifier becomes null (pre-v4), absent schema becomes 1 —
        readers never need per-version key checks.

        Torn-tail tolerant (the WAL's recovery contract, in miniature):
        the append path is plain JSONL, so a crash mid-append can leave
        a truncated final line. Unparseable lines are skipped and
        counted under "dead_letter_torn_lines" instead of poisoning
        every future read() — and, through the lazy record count above,
        every future append()."""
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
            metrics.count("dead_letter_torn_lines", torn)
        for rec in recs:
            rec.setdefault("schema", 1)
            rec.setdefault("trace_id", None)
            rec.setdefault("span_id", None)
            rec.setdefault("program", None)
            rec.setdefault("nullifier", None)
        return recs
