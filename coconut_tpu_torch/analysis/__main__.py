"""CLI for the invariant lint suite.

    python -m coconut_tpu_torch.analysis                 # human report, exit 1 on NEW findings
    python -m coconut_tpu_torch.analysis --json          # machine report (all findings + verdict)
    python -m coconut_tpu_torch.analysis --fail-on-new   # explicit CI-gate spelling (default behavior)
    python -m coconut_tpu_torch.analysis --write-baseline  # absorb current findings into the baseline
    python -m coconut_tpu_torch.analysis --checkers lock-order,durability
    python -m coconut_tpu_torch.analysis --root /path/to/tree --baseline my_baseline.json
"""

import argparse
import json
import os
import sys

from . import DEFAULT_BASELINE, run_all
from .core import CHECKER_NAMES, write_baseline


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m coconut_tpu_torch.analysis",
        description="coconut_tpu_torch invariant lint suite "
        "(%s)" % ", ".join(CHECKER_NAMES),
    )
    ap.add_argument(
        "--root",
        default=None,
        help="tree to scan (default: the repo containing this package)",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help="suppression baseline JSON (default: <root>/%s)"
        % DEFAULT_BASELINE,
    )
    ap.add_argument(
        "--checkers",
        default=None,
        help="comma-separated subset of: %s" % ", ".join(CHECKER_NAMES),
    )
    ap.add_argument("--json", action="store_true", help="JSON report")
    ap.add_argument(
        "--fail-on-new",
        action="store_true",
        help="exit 1 on findings not covered by a pragma or the baseline "
        "(this is also the default; the flag is the explicit CI spelling)",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="write every new finding into the baseline (then exit 0)",
    )
    args = ap.parse_args(argv)

    root = args.root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    checkers = args.checkers.split(",") if args.checkers else None

    findings, new = run_all(root, checkers, baseline_path)

    if args.write_baseline:
        doc = write_baseline(baseline_path, findings)
        print(
            "wrote %d suppressions to %s"
            % (len(doc["suppressions"]), baseline_path)
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "root": root,
                    "checkers": checkers or list(CHECKER_NAMES),
                    "findings": [f.to_dict() for f in findings],
                    "new": len(new),
                    "suppressed": len(findings) - len(new),
                    "ok": not new,
                },
                indent=2,
                sort_keys=True,
            )
        )
    else:
        for f in findings:
            tag = (
                ""
                if f.suppressed_by is None
                else " [suppressed: %s]" % f.suppressed_by
            )
            print("%r%s" % (f, tag))
        print(
            "analysis: %d finding(s), %d suppressed, %d NEW"
            % (len(findings), len(findings) - len(new), len(new))
        )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
