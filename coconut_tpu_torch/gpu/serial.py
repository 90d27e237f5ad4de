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
device."""

import functools
import inspect
import threading

DEVICE_LOCK = threading.RLock()


def serialized(fn):
    """`fn`, run while holding DEVICE_LOCK."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with DEVICE_LOCK:
            return fn(*args, **kwargs)

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
