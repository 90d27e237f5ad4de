"""The field kernel on the card: inputs, exactness checks, timings and bounds
(shared with chip_smoke.py), and a sweep of the kernel's lane-group size.

    python3 -m coconut_tpu_torch.bench_fp_mul [--parent DIR] [--out FILE]

The sweep builds csrc/fp_mul.cu once for each candidate (G threads a lane,
MINB blocks an SM in __launch_bounds__), and the fp_mul.cu of an earlier
tree of the repository (--parent) beside them, with every nvcc started at
once. It checks each build against the plain version exactly at ragged and
full widths, then times each at the main path's three widths in turns
(candidates in order, then in reverse). Prints one JSON object (and writes
it to --out) with ptxas' report, blocks an SM, and times for each. Needs a
CUDA card.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from .gpu import cuda_fp
from .gpu.limbs import NLIMBS

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BATCH = 1024
# lanes of one fp2_mul, fp6_mul and fp12_mul at B = 1024 (3, 18, 54 base
# products a lane)
MAIN_WIDTHS = (3 * BATCH, 18 * BATCH, 54 * BATCH)
FMA_PER_LANE = NLIMBS * NLIMBS + NLIMBS * (NLIMBS + 1) // 2 + NLIMBS * NLIMBS
BYTES_PER_LANE = 3 * NLIMBS * 4  # two operand rows in, one row out

CANDIDATES = ((4, 4), (4, 8), (8, 4), (8, 8), (16, 8), (32, 8))
# Experiments: a candidate built from fp_mul.cu with one text edit. Measured
# beside the shipped kernel to inform later work; never built by the port.
#   fadd_round: ties-to-even by adding and subtracting 1.5 * 2^23 (exact for
#   |t| < 2^30) in place of rintf's FRND instruction.
EXPERIMENTS = {
    "g8_b8_fadd_round": (8, 8, "rintf(x[c] * 0.00390625f)",
                         "__fadd_rn(__fmaf_rn(x[c], 0.00390625f, 12582912.0f), -12582912.0f)"),
}
# widths timed beside the main ones: the main path's tiniest launches (2-3
# lanes) and its B = 1024 base-field products
EXTRA_WIDTHS = (3, BATCH)


def card():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def lazy_inputs(rng, n):
    """[n, 52] f32 LAZY operands in class: normalized-style limbs below
    limb 47 (|value| < 2^376 < p) times a random weight up to 992, so
    |limb| <= 2^17 and |value| < 1024p; limbs 47..51 are zero."""
    x = rng.integers(-128, 129, size=(n, NLIMBS)).astype(np.float64)
    x[:, 47:] = 0.0
    w = rng.integers(1, 993, size=(n, 1)) * rng.choice([-1, 1], size=(n, 1))
    return (x * w).astype(np.float32)


def adversarial_rows():
    """The extremes of tests/test_pallas.py (all limbs +-132, alternating,
    half and half) and rows at +-2^17 with limbs 50-51 vacant."""
    half = NLIMBS // 2
    rows = [
        np.full(NLIMBS, 132.0),
        np.full(NLIMBS, -132.0),
        np.tile([132.0, -132.0], half),
        np.concatenate([np.full(half, 132.0), np.full(half, -132.0)]),
    ]
    big = np.full(NLIMBS, float(1 << 17))
    big[-2:] = 0.0
    rows += [big, -big, big * np.tile([1.0, -1.0], half)]
    return np.array(rows, dtype=np.float32)


def operands(rng, n):
    """a, b: [n, 52] f32, random LAZY rows and then every pair of
    adversarial rows (the last 49); nrand: the count of random rows."""
    adv = adversarial_rows()
    nrand = n - len(adv) ** 2
    a = np.concatenate([lazy_inputs(rng, nrand), np.repeat(adv, len(adv), axis=0)])
    b = np.concatenate([lazy_inputs(rng, nrand), np.tile(adv, (len(adv), 1))])
    return a, b, nrand


def ragged_widths(g):
    """Widths that straddle a group of g lanes' threads and a block."""
    return sorted({1, g - 1, g + 1, 127, 129, 3 * BATCH + 1} - {0})


def time_cuda(fn, reps=5, inner=20, hold_cycles=5_000_000):
    """Warm median of `reps` timings, each over `inner` calls, in ms/call
    of device time. The stream first spins for `hold_cycles` clocks (about
    3 ms), so the host has queued every call before the start event fires
    and a kernel shorter than its own launch is not timed as the host's
    enqueue rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def bound(lanes):
    """The least time an H100 could take for `lanes` lanes: bytes over the
    memory rate, multiply-adds (2 operations each) over the fp32 rate."""
    bytes_ms = BYTES_PER_LANE * lanes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * FMA_PER_LANE * lanes / FP32_FLOP_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads, smem_bytes}} from
    the -Xptxas -v lines of an nvcc build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def sass_counts(lib, tag=""):
    """{opcode: count} of the SASS of the kernels in `lib` whose name holds
    `tag` (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True,
    ).stdout
    counts, take = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            take = tag in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if take and m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def check_exact(bind, a, b, widths):
    """Launch `bind(a, b, out)()` on the last w rows for each width w and
    compare with the plain version; raise on the first width that differs."""
    for w in widths:
        aw, bw = a[-w:], b[-w:]
        out = torch.empty_like(aw)
        bind(aw, bw, out)()
        torch.cuda.synchronize()
        want = cuda_fp.mul_plain(aw, bw)
        if not torch.equal(out, want):
            bad = int((out != want).any(dim=1).sum())
            raise AssertionError("kernel != plain version on %d of %d lanes" % (bad, w))


# --- the sweep --------------------------------------------------------------


_WRAPPER = """#include "%s"
extern "C" int sweep_fp_mul(const void* a, const void* b, const void* c,
                            void* o, long long n, void* s) {
    return launch_fp_mul<%d, %d>(a, b, c, o, n, s);
}
extern "C" int sweep_blocks_per_sm() {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fp_mul_kernel<%d, %d>, THREADS, 0);
    return blocks;
}
"""


def _build_all(parent):
    """{name: (library path, nvcc log)}, every nvcc started at once."""
    out_dir = cuda_fp.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    variants = [("g%d_b%d" % c, c[0], c[1], cuda_fp.SOURCE) for c in CANDIDATES]
    for name, (g, minb, old, new) in EXPERIMENTS.items():
        text = cuda_fp.SOURCE.read_text()
        if old not in text:
            raise RuntimeError("experiment %s: %r is not in %s" % (name, old, cuda_fp.SOURCE))
        edited = out_dir / ("fp_mul_%s_edited.cu" % name)
        # lint: allow(durability, scratch source under build/, rewritten by
        # every sweep before nvcc reads it; nothing resumes from it)
        edited.write_text(text.replace(old, new))
        variants.append((name, g, minb, edited))
    for name, g, minb, source in variants:
        src = out_dir / ("fp_mul_%s.cu" % name)
        # lint: allow(durability, scratch source under build/, rewritten by
        # every sweep before nvcc reads it; nothing resumes from it)
        src.write_text(_WRAPPER % (source, g, minb, g, minb))
        jobs[name] = (src, out_dir / ("lib_%s.so" % name))
    if parent is not None:
        jobs["parent"] = (Path(parent) / "coconut_tpu_torch/csrc/fp_mul.cu",
                          out_dir / "lib_parent.so")
    procs = {
        name: subprocess.Popen(
            [cuda_fp._nvcc(), *cuda_fp.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, (src, lib) in jobs.items()
    }
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (jobs[name][0], log))
        built[name] = (jobs[name][1], log)
    return built


def _runner(lib, symbol, consts):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def bind(a, b, out):
        """A call that launches the kernel on a, b into out, its arguments
        taken once, so that timing it costs the host one ctypes call."""
        args = (a.data_ptr(), b.data_ptr(), consts.data_ptr(), out.data_ptr(),
                a.shape[0], torch.cuda.current_stream().cuda_stream)

        def launch():
            err = fn(*args)
            if err != 0:
                raise RuntimeError("%s launch failed: CUDA error %d" % (symbol, err))

        return launch

    return bind


def sweep(parent=None):
    dev = torch.device("cuda")
    built = _build_all(parent)
    consts = cuda_fp._kernel_consts(dev)
    rng = np.random.default_rng(0x5EE9)
    a_np, b_np, _ = operands(rng, MAIN_WIDTHS[-1])
    a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)

    rows, runs = {}, {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(str(path))
        if name == "parent":
            runs[name] = _runner(lib, "coconut_fp_mul", consts)
            row = {"source": "parent"}
        else:
            g, minb = (int(x) for x in re.findall(r"\d+", name)[:2])
            runs[name] = _runner(lib, "sweep_fp_mul", consts)
            lib.sweep_blocks_per_sm.restype = ctypes.c_int
            blocks = lib.sweep_blocks_per_sm()
            row = {"G": g, "minb": minb, "blocks_per_sm": blocks,
                   "warps_per_sm": blocks * 4}
        ptxas = ptxas_report(log)
        if name != "parent":
            tag = "ILi%dELi%dE" % (row["G"], row["minb"])
            ptxas = {k: v for k, v in ptxas.items() if tag in k}
        row["ptxas"] = ptxas
        row["sass"] = sass_counts(path, "" if name == "parent" else tag)
        widths = sorted(set(ragged_widths(row.get("G", 4)) + ragged_widths(32)
                            + list(MAIN_WIDTHS)))
        check_exact(runs[name], a, b, widths)
        row["exact_widths"] = widths
        row["ms_by_lanes"] = {str(w): [] for w in EXTRA_WIDTHS + MAIN_WIDTHS}
        rows[name] = row

    order = list(runs)
    out = torch.empty_like(a)
    one = torch.empty(1, device=dev)
    floor_ms = []
    for names in (order, order[::-1]):
        floor_ms.append(time_cuda(one.zero_))
        for w in EXTRA_WIDTHS + MAIN_WIDTHS:
            for name in names:
                launch = runs[name](a[:w], b[:w], out[:w])
                rows[name]["ms_by_lanes"][str(w)].append(time_cuda(launch))
    return {
        "card": card(),
        "device": torch.cuda.get_device_name(0),
        "bound_ms_by_lanes": {str(w): bound(w)["bound_ms"] for w in EXTRA_WIDTHS + MAIN_WIDTHS},
        # back-to-back launches of a one-element fill: the device's floor
        # for a kernel that does nothing
        "launch_floor_ms": floor_ms,
        "kernels": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="tree whose fp_mul.cu to time beside")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fp_mul: no CUDA device available")
    text = json.dumps(sweep(args.parent))
    print(text)
    if args.out:
        # lint: allow(durability, a one-shot report the same JSON as stdout;
        # a torn file is rerun, no state is recovered from it)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
