"""The device trace of a `--trace 1` window: `torch.profiler` (CUPTI, the
device's activities only) over the whole window, reduced to what the
per-layer metrics read.

    busy_s          the union of the intervals in which an operation ran
                    on the device (kernels, copies, sets)
    window_s        the traced window's length on the host clock
    kernels         device kernels (copies and sets left out)
    by_name         {name: [count, seconds]} over every device operation
    fp_mul_s        device seconds of the field kernel `fp_mul_kernel`
    gaps            the longest stretches with nothing on the device,
                    [(start_ns, end_ns)] on the epoch clock

Host clocks never stand in for a device time: where the profiler returns
no device activity, `summary` is None and the readers that need it report
nothing.
"""

import time

FP_MUL_KERNEL = "fp_mul_kernel"
TOP_GAPS = 10


class DeviceTrace:
    """Start before the window's first dispatch, stop after its last
    settle."""

    def __init__(self):
        self.prof = None
        self.summary = None
        self.error = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        try:
            self.summary = self._reduce()
        except (AttributeError, RuntimeError) as e:
            self.error = "%s: %s" % (type(e).__name__, e)
        self.prof = None

    def _reduce(self):
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        spans, by_name, kernels, fp_mul_ns = [], {}, 0, 0
        for ev in events:
            if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
                continue
            name = ev.name()
            if name.startswith("aten::"):
                continue
            start, end = ev.start_ns(), ev.end_ns()
            spans.append((start, end))
            slot = by_name.setdefault(name, [0, 0])
            slot[0] += 1
            slot[1] += end - start
            if not (name.startswith("Memcpy") or name.startswith("Memset")):
                kernels += 1
            if FP_MUL_KERNEL in name:
                fp_mul_ns += end - start
        if not spans:
            return None
        spans.sort()
        busy_ns, gaps = 0, []
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_ns += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            elif e > cur_e:
                cur_e = e
        busy_ns += cur_e - cur_s
        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": self.window_s,
            "kernels": kernels,
            "device_ops": len(spans),
            "by_name": {k: [c, ns / 1e9] for k, (c, ns) in by_name.items()},
            "fp_mul_s": fp_mul_ns / 1e9,
            "gaps": gaps[:TOP_GAPS],
        }


def label_gaps(gaps, host_spans):
    """[[label, seconds]] for each gap: the innermost host span open at its
    middle. host_spans: [(name, start_ns, end_ns)] on the epoch clock."""
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        open_ = [(hs, name) for name, hs, he in host_spans if hs <= mid <= he]
        label = "host in %s" % max(open_)[1] if open_ else "host in no span"
        out.append([label, (e - s) / 1e9])
    return out


def breakdown(summary, host_spans):
    """The result line's `breakdown`: the 10 device operations with the
    most time, and the 10 longest idle gaps by what the host was doing."""
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "device_ops": [[name[:120], secs] for name, (_, secs) in top],
        "idle_gaps": label_gaps(summary["gaps"], host_spans),
    }
