"""Probe: what padding the verify's base axis costs on one CUDA card.

A ledger over issuers of different attribute counts pads every verkey to
one base count (identity bases, zero scalars) so that all its batches share
one CUDA graph. This times, with CUDA events around replays of the four
captured stage graphs (`VerifyGraph`), the comb MSM and the whole batch at
the verkey's own base count and padded, and checks that the padded graph
gives the same verdicts as the unpadded one.

    python3 probes/probe_pad_bases.py [--batch 4096] [--reps 10] [--out chiprun_out/pad_bases.json]

One JSON line a (attributes, padded base count) on standard output; the
whole record in --out. Needs a CUDA card.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from coconut_tpu_torch import entry  # noqa: E402
from coconut_tpu_torch.gpu.backend import (  # noqa: E402
    TorchBackend, VerifyGraph, _verify_operands, fused_verify,
)


def stage_ms(graph, reps):
    """{stage: median ms of `reps` replays of its graph alone}."""
    out = {}
    for name, g in graph.stages:
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/pad_bases.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_pad_bases: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    device = torch.device("cuda", 0)
    be = TorchBackend()
    rows = []
    for attrs, pads in ((2, (None, 5, 9)), (4, (None, 5, 9)), (6, (None, 9)), (8, (None,))):
        params, _, vk, sigs, msgs = entry.fixture(64, msg_count=attrs)
        sigs, msgs, expect = entry.forge(params, sigs, msgs, every=8)
        reps = -(-args.batch // 64)
        sigs, msgs, expect = [(x * reps)[: args.batch] for x in (sigs, msgs, expect)]
        bits = {}
        for pad in pads:
            tables, host = be._verify_parts(sigs, msgs, vk, params, pad)
            # an eager run first warms the lazy constants a capture needs
            eager = fused_verify(True, *_verify_operands(tables, be._upload(host))).tolist()
            graph = VerifyGraph(True, _verify_operands(tables, host), device)
            out, done = graph.run(tables, host)
            done.synchronize()
            bits[pad] = out.tolist()
            ms = stage_ms(graph, args.reps)
            row = {
                "attributes": attrs, "bases": attrs + 1 if pad is None else pad,
                "batch": args.batch, "stage_ms": ms, "batch_ms": sum(ms.values()),
                "verdicts_expected": bits[pad] == expect and eager == expect,
                "verdicts_equal_unpadded": bits[pad] == bits[None],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            del graph, out
            torch.cuda.empty_cache()
    record = {"card": smi, "torch": torch.__version__, "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
