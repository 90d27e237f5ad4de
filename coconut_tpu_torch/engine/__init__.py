"""The execution engine of the port's online services — module for module
after `coconut_tpu/engine/`:

  executor.py  Executor: one device's inbox worker thread (the
               launch/settle double buffer).
  program.py   Program: the registration contract — assemble, dispatch,
               demux, pad-lane convention, SLO class, shape key — plus
               lifecycle/health hooks.
  core.py      ExecutionEngine: the queues (one bounded RequestQueue +
               Batcher per program), the executor pool, placement, the
               health registry, the watchdog loop, brownout admission and
               the generic launch/settle path.

  phases.py    PrepareProgram, ShowProveProgram, ShowVerifyProgram: the
               prepare, show-prove and show-verify phases as programs.
  session.py   ProtocolEngine: all five phases on ONE engine instance —
               full prepare -> mint -> show-prove -> show-verify sessions
               against a single pool.
  lifecycle.py Replica lifecycle: ShapeManifest persistence,
               LifecycleController (WARMING -> UP -> DRAINING -> CLOSED
               with warm-boot manifest replay and readiness gating),
               and ElasticPolicy/ElasticController (hysteresis-guarded
               grow/shrink of the executor pool).

serve.CredentialService and issue.IssuanceService are program
registrations on this engine (VerifyProgram and MintProgram).
"""

from .core import ExecutionEngine
from .executor import Executor
from .lifecycle import (
    ElasticController,
    ElasticPolicy,
    LifecycleController,
    ShapeManifest,
)
from .program import Program

__all__ = [
    "ExecutionEngine",
    "Executor",
    "Program",
    "ProtocolEngine",
    "LifecycleController",
    "ShapeManifest",
    "ElasticPolicy",
    "ElasticController",
]


def __getattr__(name):
    # ProtocolEngine pulls in serve/ and issue/ (which import engine.core):
    # resolve it lazily to keep the package import acyclic
    if name == "ProtocolEngine":
        from .session import ProtocolEngine

        return ProtocolEngine
    raise AttributeError(name)
