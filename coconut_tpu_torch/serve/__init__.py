"""Online serving layer of the port: dynamic-batching credential
verification — module for module after `coconut_tpu/serve/`:

  queue.py    bounded two-lane request queue, per-request futures, loud
              typed admission control (ServiceOverloadedError)
  batcher.py  deadline-driven coalescer: flush at max_batch or at the
              oldest request's max_wait_ms deadline; identity-lane pad
              partial batches; demux verdict bits back onto the
              originating futures
  service.py  CredentialService: the verify program on the execution
              engine (engine/), each batch under the retry / fallback /
              bisection ladder (one forged credential fails ITS future and
              is dead-lettered, cohabitants pass), start/drain/shutdown
  health.py   the self-healing layer: per-executor circuit breaker
              (HEALTHY -> SUSPECT -> QUARANTINED -> PROBATION), the
              hung-dispatch Watchdog (k x EMA deadline budgets) and the
              BrownoutPolicy (bulk lane sheds first, typed retriable
              ServiceBrownoutError)
  loadgen.py  closed- and open-loop (Poisson) load generation with the
              p50/p95/p99 latency, goodput, occupancy and rejection/shed
              report, and the mixed verify + issue workload

`CredentialService(None, vk, params)` serves on a TorchBackend on `cuda`.
"""

from .health import (
    HEALTHY,
    PROBATION,
    QUARANTINED,
    SUSPECT,
    BrownoutPolicy,
    ExecutorHealth,
    HealthPolicy,
    Watchdog,
)
from .loadgen import run_loadgen, run_session_loadgen
from .queue import DEFAULT_MAX_WAIT_MS, LANES, RequestQueue, ServeFuture


def __getattr__(name):
    # service.py imports the engine, which imports this package's
    # health/queue/batcher modules — resolve CredentialService lazily so
    # the package can finish initializing mid-cycle
    if name == "CredentialService":
        from .service import CredentialService

        return CredentialService
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


__all__ = [
    "CredentialService",
    "RequestQueue",
    "ServeFuture",
    "run_loadgen",
    "run_session_loadgen",
    "LANES",
    "DEFAULT_MAX_WAIT_MS",
    "HealthPolicy",
    "ExecutorHealth",
    "Watchdog",
    "BrownoutPolicy",
    "HEALTHY",
    "SUSPECT",
    "QUARANTINED",
    "PROBATION",
]
