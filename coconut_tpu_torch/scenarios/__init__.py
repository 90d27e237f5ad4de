"""Application scenarios + population-scale traffic model — the port's
copy of `coconut_tpu/scenarios/`, driven over the port's ProtocolEngine
and GatewayClient.

The Coconut paper's entire point is applications — anonymous petitions,
e-cash with double-spend detection, attribute-based service access
(Sonnino et al.) — and this package scripts them as first-class
multi-phase WORKFLOWS over the ProtocolEngine / GatewayClient future
surface, then drives them at population scale.

Two halves:

  workflow.py    — the state-machine runtime: a scenario is a typed
                   generator of Steps over submit_* futures, with
                   per-step retry classification (the
                   ServiceRetryableError taxonomy), a per-workflow
                   deadline, and an explicit terminal outcome.
  petition.py    — one credential per user, one anonymous signature per
                   campaign (campaign-scoped nullifier domain: a
                   double-sign is caught, signing two campaigns is not).
  ecash.py       — issue then ATOMIC spend: show-verify + nullifier
                   commit IS the spend; a replayed spend surfaces as a
                   typed DoubleSpendError end-to-end.
  access.py      — attribute-based service access: mint once, then a
                   long session of repeated re-randomized shows.

  arrivals.py    — deterministic open-loop arrival processes: diurnal
                   rate curve, injectable flash crowds, Zipf skew.
  population.py  — millions of users as lightweight lazily-materialized
                   state records (NOT threads) fed through a bounded
                   in-flight window.
  report.py      — the availability-timeline success artifact
                   (per-second goodput, retryable-vs-terminal errors,
                   SLO attainment, elastic pool size, brownout events),
                   built on serve/loadgen's availability machinery.

chip_smoke.py's phase `scenarios` drives the mix on the card over a
diurnal day with a flash crowd."""

from .access import AccessScenario
from .arrivals import (
    DiurnalCurve,
    FlashCrowd,
    RateSchedule,
    arrival_times,
    zipf_cdf,
    zipf_pick,
)
from .ecash import EcashScenario
from .petition import PetitionScenario
from .population import Population, PopulationDriver, User
from .report import ScenarioReport
from .workflow import (
    CANCELLED,
    COMPLETED,
    DEADLINE,
    FAILED,
    REJECTED,
    RETRY_EXHAUSTED,
    TERMINAL_OUTCOMES,
    Step,
    Workflow,
    WorkflowCheckError,
    WorkflowRun,
    run_workflow,
)

__all__ = [
    "AccessScenario",
    "CANCELLED",
    "COMPLETED",
    "DEADLINE",
    "DiurnalCurve",
    "EcashScenario",
    "FAILED",
    "FlashCrowd",
    "PetitionScenario",
    "Population",
    "PopulationDriver",
    "REJECTED",
    "RETRY_EXHAUSTED",
    "RateSchedule",
    "ScenarioReport",
    "Step",
    "TERMINAL_OUTCOMES",
    "User",
    "Workflow",
    "WorkflowCheckError",
    "WorkflowRun",
    "arrival_times",
    "run_workflow",
    "zipf_cdf",
    "zipf_pick",
]
