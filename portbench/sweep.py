"""Find the highest request rate the served cell's service sustains: one
set-up, then an open-loop window at each offered rate in turn, reporting
the completed rate, the latency percentiles and whether the backlog grew
(the last quarter's median latency against the first quarter's). Run
once, by hand, to fix the rate written in the cell's traffic file.

    python3 portbench/sweep.py --workload cfg2_verify.served --seed 7 --seconds 20 --rates 500,600,700,800
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import core  # noqa: E402


def quarter_medians(reqs):
    done = sorted((r for r in reqs if r.done is not None and r.error is None), key=lambda r: r.due)
    q = max(1, len(done) // 4)
    lat = [r.done - r.due for r in done]
    return statistics.median(lat[:q]), statistics.median(lat[-q:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cfg2_verify.served")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    core.configure()
    import torch

    if not torch.cuda.is_available():
        core.log("sweep: no CUDA card")
        return 2
    spec = core.load_spec(kept_out=True)
    cell, config, traffic = core.cell_files(spec, args.workload)
    runner = core.runner_class(traffic)(config, dict(traffic), args.seed, torch.device("cuda", 0))
    runner.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        runner.traffic["rate"] = rate
        rec = runner.window(args.seconds, core.Probe(False))
        first, last = quarter_medians(runner.requests)
        lat = [x for x in rec["latencies"] if x != float("inf")]
        print(json.dumps({
            "rate": rate, "requests": rec["attempted"], "failed": rec["failed"],
            "completed_per_s": rec["settled"] / rec["window_s"],
            "p50_s": statistics.median(lat) if lat else None,
            "p95_s": rec["latency_p95_s"], "max_s": max(lat) if lat else None,
            "first_quarter_median_s": first, "last_quarter_median_s": last,
            "backlog_grew": last > 1.5 * first + 0.5,
        }), flush=True)
    runner.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
