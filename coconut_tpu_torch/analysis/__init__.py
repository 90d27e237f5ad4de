"""coconut_tpu_torch.analysis — the invariant lint suite over the port, a
copy of `coconut_tpu/analysis/` pointed at `coconut_tpu_torch`.

Five project-specific checkers over the tree (see each module's
docstring for the contract it encodes):

  lock-order     static ``with``-nesting lock graph, fail on cycles
                 (runtime twin: analysis/lockcheck.py LockOrderTracker)
  wire-contract  errors raised on RPC paths have stable wire codes and
                 round-trip through error_from_wire with finite
                 retry_after_s
  const-time     CONSTTIME.md as taint rules: no Python-level branch /
                 int()/bool() cast on secret scalars in gpu/ +
                 signature.py + sss.py
  durability     no bare write-mode open() outside state/atomic.py and
                 the WAL
  metrics-doc    emitted counter/timer/gauge names <-> the documented
                 glossary, both directions

Run: ``python -m coconut_tpu_torch.analysis [--fail-on-new]``. Suppress a
finding inline with ``# lint: allow(<checker>, <why>)`` on (or directly
above) the flagged line, or baseline it in coconut_tpu_torch/analysis_baseline.json (the port's own
file) with a justification. The gate is --fail-on-new.
"""

from .core import (  # noqa: F401
    CHECKER_NAMES,
    Context,
    DEFAULT_BASELINE,
    Finding,
    apply_suppressions,
    load_baseline,
    write_baseline,
)


def get_checkers(names=None):
    """name -> run(ctx, files=None) for the requested checker names."""
    from . import consttime, durability, lockorder, metricsdoc, wirecontract

    table = {
        "lock-order": lockorder.run,
        "wire-contract": wirecontract.run,
        "const-time": consttime.run,
        "durability": durability.run,
        "metrics-doc": metricsdoc.run,
    }
    if names:
        unknown = set(names) - set(table)
        if unknown:
            raise KeyError(
                "unknown checkers: %s (have: %s)"
                % (", ".join(sorted(unknown)), ", ".join(sorted(table)))
            )
        return {n: table[n] for n in names}
    return table


def run_all(root, checkers=None, baseline_path=None):
    """Run the suite over the tree at ``root``.

    Returns (findings, new) where ``new`` is the subset that is neither
    pragma-suppressed nor baselined — the CI gate fails iff it is
    non-empty."""
    ctx = Context(root)
    findings = []
    for name, run in get_checkers(checkers).items():
        found = run(ctx)
        found.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
        findings.extend(found)
    baseline = load_baseline(baseline_path)
    new = apply_suppressions(findings, ctx, baseline)
    return findings, new
