"""One host thread at a time enqueues work on the card.

PyTorch releases the GIL around every operator, so host threads that each
enqueue thousands of tiny CUDA operators (two executors, five signing
authorities, the nullifier probe) interleave operator by operator and hand
the GIL, the driver's launch path and the caching allocator back and forth
on every one. On an H100 host five signing threads took about eight times
as long as the same calls made one after another (`python3 -m
coconut_tpu_torch.bench_threads`, PERF.md §6).

`DEVICE_LOCK` makes each backend call run its operators as one
uninterrupted stretch; the threads that wait for it sleep instead of
contending. It is re-entrant because backend methods call one another.
Work is only ordered, never moved: every call still runs on its own
device.

A call that finds the lock held by another thread records the wait while
tracing is on, as a span parented to the caller's active span and named
after it, `lock_wait.<caller's span>`: `lock_wait.dispatch` on the
stream's prefetch worker, the wait that holds back the next enqueue, and
`lock_wait.device` on its settling thread, a readback that has nothing
else to do meanwhile; plain `lock_wait` with no active span. The span
carries the waiting thread's name (`thread`). An uncontended call, and
every call with tracing off, costs one non-blocking acquire and opens no
span.

One-off host work on this path, such as the capture of a CUDA graph,
runs under `one_off()`: every call waiting behind it waits that much
longer, and a hung-dispatch watchdog (serve/health.Watchdog, given
`one_off_seconds`) adds that time to the budget of each dispatch in
flight meanwhile instead of taking the wait for a hang."""

import contextlib
import functools
import inspect
import threading
import time

from ..obs import trace as otrace

DEVICE_LOCK = threading.RLock()

# (seconds of finished one-off work, monotonic start of the one under way
# or None), replaced whole so a reader never sees half an update
_ONE_OFF = (0.0, None)


@contextlib.contextmanager
def one_off():
    """Mark the block as one-off host work (not nested)."""
    global _ONE_OFF
    start = time.monotonic()
    _ONE_OFF = (_ONE_OFF[0], start)
    try:
        yield
    finally:
        _ONE_OFF = (_ONE_OFF[0] + time.monotonic() - start, None)


def one_off_seconds():
    """Seconds of one-off host work so far, the work under way included."""
    done, start = _ONE_OFF
    return done if start is None else done + time.monotonic() - start


def _acquire(lock):
    """Block on `lock`, inside a `lock_wait.<caller's span>` span while
    tracing is on."""
    if not otrace.enabled():
        lock.acquire()
        return
    caller = otrace.current()
    name = "lock_wait" if caller is None else "lock_wait." + caller.name
    with otrace.span(name, thread=threading.current_thread().name):
        lock.acquire()


def serialized(fn):
    """`fn`, run while holding DEVICE_LOCK."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        lock = DEVICE_LOCK
        if not lock.acquire(blocking=False):
            _acquire(lock)
        try:
            return fn(*args, **kwargs)
        finally:
            lock.release()

    return run


def serialize_methods(cls):
    """Class decorator: every public method (static ones too) of `cls`
    runs while holding DEVICE_LOCK."""
    for name, attr in list(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(attr, staticmethod):
            setattr(cls, name, staticmethod(serialized(attr.__func__)))
        elif inspect.isfunction(attr):
            setattr(cls, name, serialized(attr))
    return cls
