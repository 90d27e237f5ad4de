"""The scenario run's success artifact — the port's copy of
`coconut_tpu/scenarios/report.py`: an availability timeline plus
outcome attribution.

Built on the SAME machinery the serve drills use —
`serve.loadgen.availability_timeline` for the per-second
goodput/error buckets and `serve.loadgen.latency_percentiles` for the
latency summary — so "goodput" means the same thing in a scenario
run as in a rolling-restart drill.

What it adds over the serve report:

  outcomes       every workflow's terminal outcome, by scenario: the
                 acceptance bar is `failed == 0` (zero UNATTRIBUTED
                 errors) and `cancelled == 0` after a clean drain
                 (zero dangling futures).
  rejections     EXPECTED typed rejections (petition re-sign, e-cash
                 double-spend) counted per scenario and label —
                 protections firing, deliberately excluded from both
                 goodput and the error timeline.
  slo            workflow-latency SLO attainment + p99, overall AND
                 split inside/outside a flash-crowd window, the "p99
                 stays in SLO through the flash crowd" number.
  timeline       per-second driver samples: in-flight window, elastic
                 active-executor pool, brownout flags — the elastic
                 sizing trace that must track the diurnal curve.
"""

import threading

from .. import metrics
from ..serve.loadgen import availability_timeline, latency_percentiles
from .workflow import (
    CANCELLED,
    COMPLETED,
    DEADLINE,
    FAILED,
    REJECTED,
    RETRY_EXHAUSTED,
)

#: program metric namespaces whose brownout gauges/shed counters the
#: per-second sample sweeps (engine/phases.py + serve/batcher.py)
_PROGRAM_NS = ("serve", "prep", "issue", "prove", "showv")


def _brownout_now():
    """1 when any program lane is currently shedding (its
    "<ns>_brownout" gauge is set), else 0."""
    for ns in _PROGRAM_NS:
        if metrics.get_gauge("%s_brownout" % ns):
            return 1
    return 0


class ScenarioReport:
    """Thread-safe collector: workflow terminals arrive from engine /
    transport threads, samples from the driver thread."""

    def __init__(self, slo_s=2.0, flash_window=None):
        self.slo_s = float(slo_s)
        #: (start_s, end_s) relative to run start — usually
        #: FlashCrowd.window(); enables the in-crowd SLO split
        self.flash_window = flash_window
        self.t0 = None
        self._lock = threading.Lock()
        self._events = []      # (t_abs, latency|None, ok) — loadgen shape
        self._latencies = []
        self._flash_latencies = []
        self._calm_latencies = []
        self._outcomes = {}    # scenario -> {outcome: n}
        self._rejections = {}  # scenario -> {label: n}
        self._error_codes = {} # code -> n (failed/exhausted attribution)
        self._retries = 0
        self._samples = []     # dicts, one per driver second

    # -- ingest --------------------------------------------------------------

    def record(self, run):
        """Fold one terminal WorkflowRun in (exactly once per run)."""
        name = run.wf.name
        dur = None
        if run.t_end is not None and run.t_start is not None:
            dur = run.t_end - run.t_start
        in_flash = False
        if (self.flash_window is not None and self.t0 is not None
                and run.t_end is not None):
            lo, hi = self.flash_window
            in_flash = lo <= (run.t_end - self.t0) <= hi
        with self._lock:
            per = self._outcomes.setdefault(name, {})
            per[run.outcome] = per.get(run.outcome, 0) + 1
            self._retries += run.retries
            if run.outcome == COMPLETED:
                self._events.append((run.t_end, dur, True))
                self._latencies.append(dur)
                (self._flash_latencies if in_flash
                 else self._calm_latencies).append(dur)
            elif run.outcome == REJECTED:
                # the protection FIRED — tracked apart from goodput
                # and errors both
                rej = self._rejections.setdefault(name, {})
                label = run.outcome_label or "rejected"
                rej[label] = rej.get(label, 0) + 1
            else:
                self._events.append((run.t_end, None, False))
                if run.error_code:
                    self._error_codes[run.error_code] = (
                        self._error_codes.get(run.error_code, 0) + 1
                    )

    def sample(self, t_rel, in_flight, active_executors=None):
        """One per-second driver sample of the live gauges."""
        s = {
            "t": round(t_rel, 3),
            "in_flight": in_flight,
            "active_executors": (
                active_executors
                if active_executors is not None
                else metrics.get_gauge("elastic_active_executors")
            ),
            "brownout": _brownout_now(),
        }
        with self._lock:
            self._samples.append(s)

    # -- build ---------------------------------------------------------------

    def _outcome_total(self, outcome):
        return sum(
            per.get(outcome, 0) for per in self._outcomes.values()
        )

    def build(self, t0, elapsed, driver=None):
        with self._lock:
            # key on the timestamp alone: a goodput event carries a
            # float latency where an error carries None, and tuple
            # comparison on a timestamp tie would TypeError on those
            events = sorted(self._events, key=lambda e: e[0])
            completed = self._outcome_total(COMPLETED)
            failed = self._outcome_total(FAILED)
            rejected = sum(
                sum(r.values()) for r in self._rejections.values()
            )
            sat = sum(1 for d in self._latencies if d <= self.slo_s)
            flash = list(self._flash_latencies)
            calm = list(self._calm_latencies)
            out = {
                "outcomes": {
                    name: dict(per)
                    for name, per in sorted(self._outcomes.items())
                },
                "totals": {
                    "completed": completed,
                    "rejected_expected": rejected,
                    "retry_exhausted": self._outcome_total(
                        RETRY_EXHAUSTED
                    ),
                    "deadline": self._outcome_total(DEADLINE),
                    "failed": failed,
                    "cancelled": self._outcome_total(CANCELLED),
                    "retries": self._retries,
                },
                "rejections": {
                    name: dict(r)
                    for name, r in sorted(self._rejections.items())
                },
                "error_codes": dict(sorted(self._error_codes.items())),
                "availability": availability_timeline(
                    events, t0, elapsed
                ),
                "latency_s": latency_percentiles(self._latencies),
                "slo": {
                    "slo_s": self.slo_s,
                    "attainment": (
                        round(sat / completed, 4) if completed else None
                    ),
                    "p99_s": metrics.percentile(self._latencies, 99),
                    "flash_window": self.flash_window,
                    "flash_p99_s": metrics.percentile(flash, 99),
                    "flash_completed": len(flash),
                    "calm_p99_s": metrics.percentile(calm, 99),
                },
                "timeline": list(self._samples),
                "goodput_per_s": (
                    round(completed / elapsed, 2) if elapsed > 0 else None
                ),
            }
        pool_sizes = [
            s["active_executors"]
            for s in out["timeline"]
            if s["active_executors"] is not None
        ]
        out["elastic"] = {
            "min_active": min(pool_sizes) if pool_sizes else None,
            "max_active": max(pool_sizes) if pool_sizes else None,
            "grown": metrics.get_count("elastic_grown"),
            "shrunk": metrics.get_count("elastic_shrunk"),
        }
        out["brownout_seconds"] = sum(
            1 for s in out["timeline"] if s["brownout"]
        )
        if driver is not None:
            out["driver"] = driver
        return out
