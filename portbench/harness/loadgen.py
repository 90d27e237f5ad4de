"""The open-loop generator of the served cells: one thread submits each
request when it is due, never waiting for an answer, and every request is
timed from when it was due, so a stall of the generator or of the service
shows in the latency of every request it delays.

A copy of the open loop of `coconut_tpu_torch.serve.loadgen.run_loadgen`,
changed where that one measures the wrong thing: it times from the submit
call and reads each answer when it waits for it at the end; this one
times from the due time and stamps each answer when its future resolves.
It reports its own lateness (submit time minus due time).
"""

import threading
import time


class Request:
    """One request: when it was due and submitted, when and how it was
    answered (`verdict`, or `error` naming the exception), all on the
    window's clock."""

    __slots__ = ("k", "due", "submitted", "done", "verdict", "error")

    def __init__(self, k, due):
        self.k = k
        self.due = due
        self.submitted = None
        self.done = None
        self.verdict = None
        self.error = None


def run_open_loop(submit, due_times, clock=time.perf_counter, sleep=time.sleep):
    """Call `submit(k)` for each request k at t0 + due_times[k] and hook
    its future. Returns (t0, [Request]) once the last request is submitted;
    `wait(...)` collects the answers."""
    requests = [Request(k, None) for k in range(len(due_times))]
    lock = threading.Lock()
    t0 = clock()
    for req, due in zip(requests, due_times):
        req.due = t0 + due
        now = clock()
        if now < req.due:
            sleep(req.due - now)
        req.submitted = clock()
        try:
            fut = submit(req.k)
        except Exception as e:  # a refusal: answered, and missing every limit
            req.done, req.error = req.submitted, type(e).__name__
            continue

        def answered(f, req=req):
            t = clock()
            try:
                verdict = f.result(0)
            except Exception as e:
                verdict, err = None, type(e).__name__
            else:
                err = None
            with lock:
                req.done, req.verdict, req.error = t, verdict, err

        fut.add_done_callback(answered)
    return t0, requests


def wait(requests, deadline, clock=time.perf_counter, sleep=time.sleep):
    """Wait until every request is answered or `deadline` (window clock)
    passes; returns how many are still unanswered."""
    while True:
        left = sum(1 for r in requests if r.done is None)
        if left == 0 or clock() >= deadline:
            return left
        sleep(0.01)


def lateness(requests):
    """(max, 95th percentile) of submit time minus due time, seconds."""
    late = sorted(r.submitted - r.due for r in requests)
    if not late:
        return 0.0, 0.0
    return late[-1], late[min(len(late) - 1, int(0.95 * len(late)))]
