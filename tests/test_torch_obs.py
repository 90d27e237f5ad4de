"""The port's tracer inside the verify dispatch (`coconut_tpu_torch.obs`).

The span tree `verify_stream` records over `TorchBackend(device="cpu")`:
`dispatch` holds the backend's `encode` and `enqueue`, and `enqueue` the
program's stages `comb_msm`, `affine`, `miller_loop`, `final_exp`. The
device lock's `lock_wait.<caller>` span: recorded under contention only,
parented to the waiting caller's span and named after it, never opened
with tracing off; the lock's re-entrancy and `bench_threads`' no-op
stand-in for it. The tracer's clock against torch.profiler's (the Unix
epoch), through the benchmark harness's offset and through the Chrome
export.
"""

import contextlib
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from coconut_tpu_torch import bench_threads, entry
from coconut_tpu_torch.gpu import serial
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.obs import export as oexport
from coconut_tpu_torch.obs import trace as otrace
from coconut_tpu_torch.stream import verify_stream

BATCH = 4
STAGES = ("comb_msm", "affine", "miller_loop", "final_exp")


@contextlib.contextmanager
def tracing(ring=4096):
    """A fresh tracer for the block; the one before it (or none) after."""
    prev = otrace.get_tracer()
    tracer = otrace.enable(ring=ring)
    try:
        yield tracer
    finally:
        if prev is None:
            otrace.disable()
        else:
            otrace.enable(tracer=prev)


@contextlib.contextmanager
def not_tracing():
    """Tracing off for the block; the tracer before it (if any) after."""
    prev = otrace.get_tracer()
    otrace.disable()
    try:
        yield
    finally:
        if prev is not None:
            otrace.enable(tracer=prev)


def _inside(child, parent):
    return parent.t0 <= child.t0 and child.t1 <= parent.t1


@pytest.fixture(scope="module")
def stream_run():
    """(verdicts, finished spans) of two pipelined batches of 4, lane 6
    forged, with the prefetch worker on."""
    params, _, vk, sigs, msgs = entry.fixture(2 * BATCH, msg_count=2)
    msgs = [list(m) for m in msgs]
    msgs[6][0] += 1
    seen = []
    with tracing() as tracer:
        verify_stream(
            lambda i: (sigs[i * BATCH:(i + 1) * BATCH], msgs[i * BATCH:(i + 1) * BATCH]),
            2, vk, params, TorchBackend(device="cpu", comb_window=4),
            on_batch=lambda i, r: seen.append(r), pipeline_depth=2, prefetch_depth=1,
        )
        spans = tracer.tail()
    return seen, spans


def test_stream_dispatch_holds_encode_enqueue_and_the_stages(stream_run):
    seen, spans = stream_run
    assert seen == [[True] * 4, [True, True, False, True]]
    by_id = {s.span_id: s for s in spans}
    children = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)

    def only(parent, name):
        found = [c for c in children.get(parent.span_id, []) if c.name == name]
        assert len(found) == 1, (parent.name, name, found)
        assert _inside(found[0], parent), (parent.name, name)
        return found[0]

    batches = [s for s in spans if s.name == "stream_batch"]
    assert sorted(b.attrs["batch"] for b in batches) == [0, 1]
    for b in batches:
        dispatch = only(b, "dispatch")
        encode, enqueue = only(dispatch, "encode"), only(dispatch, "enqueue")
        assert encode.t1 <= enqueue.t0
        stages = [only(enqueue, name) for name in STAGES]
        assert all(a.t1 <= z.t0 for a, z in zip(stages, stages[1:]))
        assert by_id[dispatch.parent_id] is b
    for w in (s for s in spans if s.name.startswith("lock_wait")):
        # the settle's readback waiting on the prefetch worker, or back
        assert by_id[w.parent_id].name in ("dispatch", "device")
        assert w.name == "lock_wait." + by_id[w.parent_id].name
        assert w.attrs["thread"] in ("MainThread", "coconut-encode-prefetch")


def _hold(lock, seconds, held):
    with lock:
        held.set()
        time.sleep(seconds)


def _contended(call, seconds=0.05):
    """Run `call()` on this thread while another holds DEVICE_LOCK for
    `seconds`; returns its result."""
    held = threading.Event()
    holder = threading.Thread(target=_hold, args=(serial.DEVICE_LOCK, seconds, held))
    holder.start()
    try:
        assert held.wait(5.0)
        return call()
    finally:
        holder.join(5.0)
        assert not holder.is_alive()


@pytest.mark.parametrize("caller_name", ["dispatch", "device", None])
def test_lock_wait_under_contention_parents_to_the_caller(caller_name):
    """One wait of the holder's 50 ms, named after the caller's span
    (plain `lock_wait` with none), under it, with the thread's name."""
    call = serial.serialized(lambda: "ran")
    with tracing() as tracer:
        with otrace.span(caller_name) if caller_name else contextlib.nullcontext() as caller:
            assert _contended(call) == "ran"
        waits = [s for s in tracer.tail() if s.name.startswith("lock_wait")]
    assert len(waits) == 1
    (w,) = waits
    assert w.name == ("lock_wait." + caller_name if caller_name else "lock_wait")
    assert w.dur >= 0.04
    assert w.attrs["thread"] == threading.current_thread().name
    if caller_name:
        assert w.parent_id == caller.span_id and w.trace_id == caller.trace_id
        assert _inside(w, caller)
    else:
        assert w.parent_id is None


def test_no_lock_wait_without_contention():
    inner = serial.serialized(lambda: 1)
    outer = serial.serialized(lambda: inner() + inner())
    with tracing() as tracer:
        with otrace.span("dispatch"):
            assert outer() == 2
        names = [s.name for s in tracer.tail()]
    assert names == ["dispatch"]


def test_tracing_off_records_nothing_and_keeps_reentrancy(monkeypatch):
    """With tracing off a contended call opens no span (the tracer's
    entry point is never reached), re-entrant calls still run, and the
    lock is free afterwards."""
    opened = []
    monkeypatch.setattr(otrace, "start_span", lambda *a, **k: opened.append(a) or otrace.NOOP)
    inner = serial.serialized(lambda: "inner")
    outer = serial.serialized(lambda: inner() + "+outer")
    with not_tracing():
        assert _contended(outer) == "inner+outer"
        assert otrace.span("encode") is otrace.NOOP
    assert opened == [("encode",)]
    assert serial.DEVICE_LOCK.acquire(blocking=False)
    serial.DEVICE_LOCK.release()


def test_nullcontext_stand_in_still_runs(monkeypatch):
    """bench_threads swaps DEVICE_LOCK for a no-op stand-in with
    `acquire`/`release`: the serialized methods run under it, with
    tracing on or off, and record no wait."""

    @serial.serialize_methods
    class Calls:
        def outer(self):
            return self.inner() * 2

        def inner(self):
            return 21

    monkeypatch.setattr(serial, "DEVICE_LOCK", bench_threads._NO_LOCK)
    assert Calls().outer() == 42
    with tracing() as tracer:
        assert Calls().outer() == 42
        assert tracer.tail() == []


def _profiled_span():
    """(tracer, span, profiler) of a program span holding a
    record_function between two 2 ms sleeps, under torch.profiler's CPU
    activity."""
    with tracing() as tracer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with otrace.span("encode") as s:
                time.sleep(0.002)
                with record_function("probe_fn"):
                    torch.ones(8).add_(1)
                time.sleep(0.002)
                s.event("mark")
    return tracer, s, prof


def test_span_encloses_profiler_event_on_the_epoch_clock():
    """The harness maps a span by one time_ns - monotonic_ns offset; the
    profiler's own event must fall inside it, to 1 ms."""
    off = time.time_ns() - time.monotonic_ns()
    _, s, prof = _profiled_span()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe_fn"]
    t0, t1 = int(s.t0 * 1e9) + off, int(s.t1 * 1e9) + off
    assert t0 - 1_000_000 <= ev.start_ns() <= ev.end_ns() <= t1 + 1_000_000
    assert ev.start_ns() - t0 >= 1_000_000 and t1 - ev.end_ns() >= 1_000_000


def test_chrome_export_overlays_the_profilers_trace(tmp_path):
    """export_chrome writes ts in Unix-epoch microseconds (from the
    tracer's anchor); given the profiler's file, it writes that document
    with the span added on its baseTimeNanoseconds, where the span
    encloses the profiler's event, to 1 ms."""
    tracer, s, prof = _profiled_span()
    prof_path, ours = tmp_path / "prof.json", tmp_path / "both.json"
    prof.export_chrome_trace(str(prof_path))
    theirs = json.loads(prof_path.read_text())
    (pe,) = [e for e in theirs["traceEvents"] if e.get("name") == "probe_fn"]

    assert oexport.export_chrome(str(ours), tracer=tracer, profiler_trace=str(prof_path)) == 2
    doc = json.loads(ours.read_text())
    assert doc["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    assert doc["traceEvents"][: len(theirs["traceEvents"])] == theirs["traceEvents"]
    (x,) = [e for e in doc["traceEvents"] if e.get("args", {}).get("span_id") == s.span_id]
    (mark,) = [e for e in doc["traceEvents"] if e["name"] == "encode.mark"]
    assert x["ts"] - 1000 <= pe["ts"] and pe["ts"] + pe["dur"] <= x["ts"] + x["dur"] + 1000
    assert x["ts"] <= mark["ts"] <= x["ts"] + x["dur"]

    (epoch,) = [e for e in oexport.chrome_events([s]) if e["ph"] == "X"]
    mono0, ns0 = tracer.anchor
    assert epoch["ts"] == pytest.approx(ns0 / 1e3 + (s.t0 - mono0) * 1e6, abs=1.0)
    assert abs(epoch["ts"] - time.time_ns() / 1e3) < 60e6
    assert epoch["dur"] == pytest.approx(s.dur * 1e6)


def test_chrome_export_keeps_bare_records_on_their_own_clock():
    """Records read back as dicts carry no tracer: their ts stay on the
    raw clock they were stamped with, whatever tracer is installed."""
    _, s, _ = _profiled_span()
    rec = s.to_dict()
    with tracing():
        (x,) = [e for e in oexport.chrome_events([rec]) if e["ph"] == "X"]
    assert x["ts"] == pytest.approx(rec["t0"] * 1e6)
