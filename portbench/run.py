"""Run one cell of the port's benchmark on this machine's CUDA card(s).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cells, configurations, traffic mixes and
metrics are named in BENCHMARK.json and found as files under portbench/
(harness/core.py). Prints one JSON result as the last line of standard
output; exits non-zero, with no result, where the card is missing.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
