"""stream.lock_wait_ms.verify: the prefetch worker's waits for the device lock
over the window (the program's `lock_wait.dispatch` spans: a backend call under
the stream's `dispatch` finding the lock held by the settling thread), summed
and divided by the batches settled, ms a batch. That wait holds back the next
enqueue, which sets the pace. The settling thread's waits (`lock_wait.device`)
are left out: its readback has nothing else to do while the worker enqueues, so
they re-read the length of a dispatch.

0.0 where the window holds the backend's spans and batches but no such wait;
None without the tracer, and where the program records no backend span (a
program without the spans has no lock_wait either, so 0.0 would claim no
waits)."""


def read(run):
    batches = run.record.get("batches")
    if not batches or "enqueue" not in run.stages:
        return None
    waits = run.stages.get("lock_wait.dispatch")
    return 1e3 * (waits[1] if waits else 0.0) / batches
