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

serve.CredentialService is a program registration on this engine
(VerifyProgram).
"""

from .core import ExecutionEngine
from .executor import Executor
from .program import Program

__all__ = ["ExecutionEngine", "Executor", "Program"]
