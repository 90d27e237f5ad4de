"""Time the plain field multiply's CPU forms on a warm verify batch.

    python -m coconut_tpu_torch.bench_plain [--batch 8] [--reps 6] [--threads 1]

`gpu/cuda_fp.mul_plain` runs every field product of a TorchBackend on the
CPU. It works in float32 there and, at narrow widths, takes the limb
product as one outer product (up to OUTER_LANES lanes) and a carry pass
as one matrix product (up to CARRY_MATRIX_LANES lanes). This script times
one B-credential `batch_verify` on `TorchBackend(device="cpu")` under
each form in turn, the forms interleaved within every repetition, and
prints each form's walls and median as JSON lines: float64 with neither
narrow form (the card's path), float32 with neither, with each alone,
and with both. Every form must give the same verdicts."""

import argparse
import contextlib
import json
import statistics
import time

import torch

from . import entry
from .gpu import cuda_fp
from .gpu.backend import TorchBackend

FORMS = {  # name: (working type, OUTER_LANES, CARRY_MATRIX_LANES)
    "float64": (torch.float64, 0, 0),
    "float32": (torch.float32, 0, 0),
    "float32+outer": (torch.float32, cuda_fp.OUTER_LANES, 0),
    "float32+carry": (torch.float32, 0, cuda_fp.CARRY_MATRIX_LANES),
    "float32+both": (torch.float32, cuda_fp.OUTER_LANES, cuda_fp.CARRY_MATRIX_LANES),
}


@contextlib.contextmanager
def plain_form(dtype, outer, carry):
    """Run mul_plain on the CPU in `dtype` with the given crossovers."""
    saved = cuda_fp._plain_dtype, cuda_fp.OUTER_LANES, cuda_fp.CARRY_MATRIX_LANES
    cuda_fp._plain_dtype = lambda device: dtype
    cuda_fp.OUTER_LANES, cuda_fp.CARRY_MATRIX_LANES = outer, carry
    cuda_fp._plain_consts.cache_clear()
    try:
        yield
    finally:
        cuda_fp._plain_dtype, cuda_fp.OUTER_LANES, cuda_fp.CARRY_MATRIX_LANES = saved
        cuda_fp._plain_consts.cache_clear()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    params, _, vk, sigs, msgs = entry.fixture(args.batch)
    be = TorchBackend(device="cpu")
    expect = be.batch_verify(sigs, msgs, vk, params)  # warm: tables, caches
    walls = {name: [] for name in FORMS}
    for _ in range(args.reps):
        for name, form in FORMS.items():
            with plain_form(*form):
                t0 = time.perf_counter()
                bits = be.batch_verify(sigs, msgs, vk, params)
                walls[name].append(time.perf_counter() - t0)
            if bits != expect:
                raise SystemExit("form %s changed the verdicts" % name)
    for name, w in walls.items():
        print(json.dumps({"form": name, "batch": args.batch, "threads": args.threads,
                          "walls_s": w, "median_s": statistics.median(w)}), flush=True)


if __name__ == "__main__":
    main()
