"""One run of one cell: find the cell's files by name, check the card, set
up, measure the window, judge the outputs against the plain reference,
read the cell's metrics and print the result line.

Everything that belongs to one cell, configuration or metric is a file of
its own, found by the names in BENCHMARK.json:

    portbench/configs/<config>.json       the deployment's sizes
    portbench/workloads/<cell>.json       the traffic mix; "runner" names
                                          portbench/harness/runners/<runner>.py
    portbench/metrics/<metric>.py         read(run) -> number or None

The result is the last line of standard output; the numbers the output
check compared, each beside its limit, are the last lines of standard
error and the last key of the result.
"""

import argparse
import collections
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import hoststat

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
#: top-level module names that may not be loaded, compared whole: the
#: measured package `coconut_tpu_torch` is not `coconut_tpu`
FORBIDDEN = ("jax", "jaxlib", "flax", "coconut_tpu")
#: spans kept by the program's tracer in a traced run
TRACE_RING = 1 << 18


def configure():
    """Every build and kernel cache at a fixed path inside the checkout,
    and one intra-op thread for PyTorch's host operators: the program's
    host work is the launch of tens of thousands of small operators, and
    eight OpenMP threads on the card's shared eight-core host spread the
    bulk verify rate over 2,517-2,942 verifies/s where one thread gave
    2,642-2,724, and set-up over 25-30 s where one gave 15-19 s (PERF.md
    §6)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    import torch

    torch.set_num_threads(1)


def load_json(path):
    with open(path) as f:
        return json.load(f)


#: cells whose files are under portbench/ but which BENCHMARK.json leaves
#: out until their runs repeat within a bound (PERF.md §7); the sweep, the
#: control and the tests run them, the benchmark's own runs do not
KEPT_OUT = [
    {"name": "cfg3_show.bulk2048", "config": "cfg3_show", "traffic": "bulk2048", "chips": 1,
     "why": "shows in batches of 2,048 dispatched 2 ahead, revealed {2,3,4,5}, 1 in 64 forged: the distinct "
            "MSM J*c and the heavier Miller loop"},
    {"name": "cfg2_verify.served", "config": "cfg2_verify", "traffic": "served", "chips": 1,
     "why": "open-loop Poisson requests of one credential at 4/5 of capacity into CredentialService "
            "(max_batch 1024, 50 ms): serve, engine, launch path"},
]


def load_spec(kept_out=False):
    """BENCHMARK.json; with `kept_out`, its cells and those of KEPT_OUT."""
    spec = load_json(ROOT / "BENCHMARK.json")
    if kept_out:
        spec["workloads"] = spec["workloads"] + KEPT_OUT
    return spec


def cell_files(spec, name):
    """(cell entry, configuration, traffic) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % (name,))
    cell = cells[name]
    config = load_json(BENCH / "configs" / ("%s.json" % cell["config"]))
    traffic = load_json(BENCH / "workloads" / ("%s.json" % name))
    return cell, config, traffic


def cell_metrics(spec, name, trace):
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace
    1), as BENCHMARK.json entries."""
    if not trace:
        return [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in cell_metrics(spec, name, False)}
    return [
        m for m in spec["per_layer"]
        if name in m.get("workloads", ())
        or ("workloads" not in m and m["moves"] in reported)
    ]


def reader(name):
    """read(run) of portbench/metrics/<name>.py."""
    path = BENCH / "metrics" / ("%s.py" % name)
    spec = importlib.util.spec_from_file_location("portbench_metric_%s" % name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner_class(traffic):
    return importlib.import_module("portbench.harness.runners.%s" % traffic["runner"]).Runner


def forbidden_modules():
    """The FORBIDDEN top-level names that sys.modules holds."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card():
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class Probe:
    """Counter, launch and span deltas over a window, and with `trace` the
    device trace. The program's tracer runs in traced runs only."""

    def __init__(self, trace):
        self.trace = trace
        self.devtrace = None

    def start(self):
        from coconut_tpu_torch import metrics
        from coconut_tpu_torch.gpu import cuda_fp
        from coconut_tpu_torch.obs import trace as otrace

        self.c0 = metrics.counters_with_prefix("")
        self.w0 = collections.Counter(cuda_fp.LAUNCH_WIDTHS)
        tracer = otrace.get_tracer()
        self.s0 = tracer.stage_summary() if tracer else {}
        self.mono0 = time.monotonic()
        self.epoch_minus_mono = time.time_ns() - time.monotonic_ns()
        if self.trace:
            from .devtrace import DeviceTrace

            self.devtrace = DeviceTrace()
            self.devtrace.start()

    def stop(self):
        from coconut_tpu_torch import metrics
        from coconut_tpu_torch.gpu import cuda_fp
        from coconut_tpu_torch.obs import trace as otrace

        if self.devtrace is not None:
            self.devtrace.stop()
        c1 = metrics.counters_with_prefix("")
        self.counters = {k: v - self.c0.get(k, 0) for k, v in c1.items() if v != self.c0.get(k, 0)}
        self.widths = collections.Counter(cuda_fp.LAUNCH_WIDTHS) - self.w0
        tracer = otrace.get_tracer()
        self.stages, self.host_spans = {}, []
        if tracer:
            for name, s in tracer.stage_summary().items():
                c0 = self.s0.get(name, {"count": 0, "total_s": 0.0})
                if s["count"] > c0["count"]:
                    self.stages[name] = (s["count"] - c0["count"], s["total_s"] - c0["total_s"])
            off = self.epoch_minus_mono
            self.host_spans = [
                (s.name, int(s.t0 * 1e9) + off, int(s.t1 * 1e9) + off)
                for s in tracer.tail() if s.t1 is not None and s.t0 >= self.mono0
            ]


class Run:
    """What the metric readers read: the runner's window record (settled
    lanes, batches, window seconds, latencies), the probe's deltas and
    device trace and the set-up time."""

    def __init__(self, setup_s, record, probe):
        self.setup_s = setup_s
        self.record = record
        self.counters = probe.counters
        self.widths = probe.widths
        self.stages = probe.stages
        self.host_spans = probe.host_spans + record.get("host_spans", [])
        dt = probe.devtrace
        self.trace = dt.summary if dt is not None else None
        self.trace_error = dt.error if dt is not None else None


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell of the port.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(spec, name, seed, seconds, trace, device, t_start, control=False, wrap=None, sizes=None):
    """Set up, measure and judge one run of the cell `name` on `device`;
    returns (result, checks). `control`, `wrap` and `sizes` (traffic keys
    to override) are for the control runs and the tests, never the
    benchmark's own runs."""
    import torch

    cell, config, traffic = cell_files(spec, name)
    traffic = dict(traffic, **(sizes or {}))
    on_cuda = device.type == "cuda"
    if on_cuda:
        log("portbench: %s seed %d, %s s, trace %d, card %s" % (name, seed, seconds, trace, card()))
    if trace:
        from coconut_tpu_torch.obs import trace as otrace

        otrace.enable(ring=TRACE_RING)
    runner = runner_class(traffic)(config, traffic, seed, device, control=control, wrap=wrap)
    runner.setup()
    setup_s = time.perf_counter() - t_start
    probe = Probe(bool(trace) and on_cuda)
    host = hoststat.Window()
    host.start()
    record = runner.window(seconds, probe)
    if on_cuda:
        torch.cuda.synchronize()
    host = dict(runner.parts, window_s=record["window_s"], **host.stop())
    host["batches"] = record.get("batches", probe.counters.get("serve_batches"))
    log("portbench: host %s" % json.dumps(host))
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    run = Run(setup_s, record, probe)
    runner.release()
    checks = runner.check()
    values = {}
    for m in cell_metrics(spec, name, trace):
        v = reader(m["name"])(run)
        if v is None:
            log("portbench: %s not measured (%s)" % (
                m["name"], run.trace_error or "nothing to read in this run"))
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": values,
        "device": device_info,
    }
    if run.trace is not None:
        from .devtrace import breakdown

        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace, run.host_spans)
    result["host"] = host
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def main(argv, t_start):
    args = parse(argv)
    configure()
    spec = load_spec()
    cell, _, _ = cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log("portbench: the cell needs %d CUDA card(s); torch sees %s" % (
            cell["chips"], torch.cuda.device_count() if torch.cuda.is_available() else "none"))
        return 2
    result, checks = execute(
        spec, args.workload, args.seed, args.seconds, args.trace, torch.device("cuda", 0), t_start
    )
    found = forbidden_modules()
    if found:
        log("portbench: the run loaded forbidden modules: %s" % ", ".join(found))
        return 3
    for k, (v, lim) in checks.items():
        log("check %s %s limit %s" % (k, v, lim))
    print(json.dumps(result), flush=True)
    return 0
