"""The output check's control, on the card: run a cell with the program's
one-verdict-per-batch path in place of the exact one, on several seeds in
one process, and print each compared number beside its limit. The check
has to fail it. Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --seeds 11,22,33 --seconds 10

One JSON line a seed on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    core.configure()
    import torch

    if not torch.cuda.is_available():
        core.log("control: no CUDA card")
        return 2
    spec = core.load_spec(kept_out=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = core.execute(
            spec, args.workload, seed, args.seconds, 0, torch.device("cuda", 0),
            time.perf_counter(), control=True,
        )
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "checks": result["checks"],
            "attempted": result["attempted"], "metrics": result["metrics"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
