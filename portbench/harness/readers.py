"""The arithmetic of the metric readers under portbench/metrics/: each of
those files binds one of these to its name. A reader returns None where
its run has nothing to read (a run without the device trace, a window
without the span), and the harness then leaves the metric out."""

import math

from . import fpbound


def rate(run):
    """Lanes settled in the window over the window's whole length."""
    return run.record["settled"] / run.record["window_s"]


def latency_p95_s(run):
    """The 95th percentile of every request's latency, from when it was
    due; None where it is infinite (more than one in twenty missing)."""
    v = run.record.get("latency_p95_s")
    return v if v is not None and math.isfinite(v) else None


def setup_s(run):
    return run.setup_s


def idle_pct(run):
    """100 * (1 - device busy / traced window), from the device trace."""
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def fp_mul_roofline_pct(run):
    """100 * the field kernel's bound summed over its launches in the
    window / its device time there. The launches are the program's own
    count by width (`cuda_fp.LAUNCH_WIDTHS`, host side); the device time
    is the profiler's, over the same window, which begins before the
    first dispatch and ends after the last settle."""
    t = run.trace
    if t is None or t["fp_mul_s"] <= 0 or not run.widths:
        return None
    return 100.0 * fpbound.bound_s(run.widths) / t["fp_mul_s"]


def kernels_per_batch(run):
    """Device kernels in the traced window / batches it settled."""
    t = run.trace
    if t is None or not run.record.get("batches"):
        return None
    return t["kernels"] / run.record["batches"]


def span_mean_ms(name):
    """The mean of the program's span `name` over the window, in ms (the
    program's tracer is on in traced runs only)."""

    def read(run):
        s = run.stages.get(name)
        if not s or s[0] <= 0:
            return None
        return 1e3 * s[1] / s[0]

    return read


def own_dispatch_ms(run):
    """The mean of the benchmark's own span around each dispatch call."""
    d = run.record.get("dispatch_s")
    if not d:
        return None
    return 1e3 * sum(d) / len(d)


def batch_occupancy(run):
    """Requests a batch: the service's serve_batched_requests over its
    serve_batches, deltas over the window."""
    b = run.counters.get("serve_batches", 0)
    if b <= 0:
        return None
    return run.counters.get("serve_batched_requests", 0) / b
