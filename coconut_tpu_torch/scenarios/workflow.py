"""The scenario state-machine runtime — the port's copy of
`coconut_tpu/scenarios/workflow.py`.

A WORKFLOW is a typed multi-phase script over the engine/gateway future
surface: a generator that yields `Step`s (each step submits ONE
request and receives its result back through the yield), plus two
classification hooks. The runtime — `WorkflowRun` — advances the
script entirely through `ServeFuture.add_done_callback`, the same
no-parked-thread seam net/rpc.py resolves response frames with, so a
million concurrent workflows cost a few hundred bytes of generator
state each, never a thread.

Outcome taxonomy (every started workflow reaches EXACTLY one):

  completed        the script ran to StopIteration
  rejected         a TYPED terminal error the scenario EXPECTED — the
                   protection fired (petition re-sign caught, e-cash
                   double-spend caught). Success of the system, not an
                   error of the run.
  retry_exhausted  retryable refusals (ServiceRetryableError /
                   TransientBackendError) beyond the step's budget
  deadline         the per-workflow deadline expired
  failed           an UNATTRIBUTED error — a typed terminal the
                   scenario did not expect, or a script bug. The
                   acceptance drills assert this count is zero.
  cancelled        the driver drained before the workflow finished

Retry classification reuses the serve taxonomy verbatim: an exception
is retryable iff `isinstance(e, (ServiceRetryableError,
TransientBackendError))`; the retry delay honors the refusal's own
`retry_after_s` hint, floored by exponential backoff with
deterministic per-run jitter (seeded — the fake-clock unit tests are
bit-stable). Everything else consults `Workflow.classify(step, exc)`:
a non-None label means the scenario expected that terminal (→
rejected); None means failed.

Thread-safety: `ServeFuture` callbacks fire on engine executor
threads (or transport reader threads over RPC), so every transition
runs under the run's own lock, and a late callback against an
already-terminal run is a no-op — that is the "no dangling futures on
drain" invariant the unit suite pins.
"""

import random
import threading
import time

from .. import metrics
from ..errors import ServiceRetryableError, TransientBackendError

COMPLETED = "completed"
REJECTED = "rejected"
RETRY_EXHAUSTED = "retry_exhausted"
DEADLINE = "deadline"
FAILED = "failed"
CANCELLED = "cancelled"

TERMINAL_OUTCOMES = (
    COMPLETED, REJECTED, RETRY_EXHAUSTED, DEADLINE, FAILED, CANCELLED,
)

#: floor between retries; doubles per attempt (jittered)
DEFAULT_BACKOFF_S = 0.05
DEFAULT_MAX_RETRIES = 4


class WorkflowCheckError(Exception):
    """A script-level invariant failed (e.g. a show verdict came back
    False for an honest credential). Terminal and UNEXPECTED — the run
    finishes `failed`, which the drills assert never happens."""


class Step:
    """One protocol-phase submission inside a script: `submit()` must
    return a future with `.result()`/`.add_done_callback()` (every
    engine/gateway submit_* does)."""

    __slots__ = ("name", "submit", "max_retries")

    def __init__(self, name, submit, max_retries=DEFAULT_MAX_RETRIES):
        self.name = name
        self.submit = submit
        self.max_retries = max_retries


class Workflow:
    """Base scenario script. Subclasses set `name`, implement
    `script()` (a generator yielding Steps; each yield evaluates to
    that step's result), optionally `classify(step, exc)` (return a
    short label for an EXPECTED typed terminal — the run finishes
    `rejected` with that label — or None), and optionally
    `on_terminal(run)` (update scenario/user state; called exactly
    once, after the outcome is sealed, still under the run's lock)."""

    name = "workflow"
    deadline_s = 30.0

    def script(self):
        raise NotImplementedError

    def classify(self, step, exc):
        return None

    def on_terminal(self, run):
        pass


class WorkflowRun:
    """Drives one Workflow instance to a terminal outcome.

    `on_terminal(run)` fires exactly once (report/driver hook);
    `on_park(run, ready_at)` hands a retry wake-up time to the owner
    (the PopulationDriver's heap, or run_workflow's local loop) —
    without an owner the run sleeps inline via `sleep`."""

    __slots__ = (
        "wf", "clock", "sleep", "rng", "on_terminal", "on_park",
        "backoff_s", "deadline_at", "outcome", "outcome_label",
        "error_code", "retries", "steps_done", "t_start", "t_end",
        "_lock", "_gen", "_step", "_retries_left", "_done_evt",
    )

    def __init__(self, wf, clock=time.monotonic, sleep=time.sleep,
                 seed=0, on_terminal=None, on_park=None,
                 backoff_s=DEFAULT_BACKOFF_S):
        self.wf = wf
        self.clock = clock
        self.sleep = sleep
        self.rng = random.Random(seed)
        self.on_terminal = on_terminal
        self.on_park = on_park
        self.backoff_s = backoff_s
        self.deadline_at = None
        self.outcome = None
        self.outcome_label = None
        self.error_code = None
        self.retries = 0
        self.steps_done = 0
        self.t_start = None
        self.t_end = None
        # re-entrant: ServeFuture.add_done_callback fires the hook
        # INLINE on the registering thread when the future is already
        # resolved, which re-enters the transition path under this lock
        self._lock = threading.RLock()
        self._gen = None
        self._step = None
        self._retries_left = 0
        self._done_evt = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        now = self.clock()
        self.t_start = now
        if self.wf.deadline_s is not None:
            self.deadline_at = now + self.wf.deadline_s
        metrics.count("scenario_started")
        with self._lock:
            self._gen = self.wf.script()
            self._advance_locked(None, first=True)
        return self

    def done(self):
        return self.outcome is not None

    def wait(self, timeout=None):
        """Block until terminal (run_workflow / tests)."""
        self._done_evt.wait(timeout)
        return self.outcome

    def cancel(self, outcome=CANCELLED):
        """Force-finish a non-terminal run (driver drain). A late
        future callback after this is a no-op."""
        with self._lock:
            if self.outcome is None:
                self._finish_locked(outcome)

    def expire_if_past_deadline(self, now):
        """Driver pump hook: seals `deadline` on a run whose clock ran
        out while parked or waiting on a future."""
        with self._lock:
            if self.outcome is None and self.deadline_at is not None \
                    and now >= self.deadline_at:
                self._finish_locked(DEADLINE)

    # -- transitions (all under self._lock) ---------------------------------

    def _advance_locked(self, value, first=False):
        try:
            step = self._gen.send(None if first else value)
        except StopIteration:
            self._finish_locked(COMPLETED)
            return
        except Exception as e:
            self.error_code = _code_of(e)
            self._finish_locked(FAILED)
            return
        self._step = step
        self._retries_left = step.max_retries
        self._submit_locked()

    def _submit_locked(self):
        now = self.clock()
        if self.deadline_at is not None and now >= self.deadline_at:
            self._finish_locked(DEADLINE)
            return
        try:
            fut = self._step.submit()
        except Exception as e:
            self._on_error_locked(e)
            return
        # an already-resolved future fires the hook inline on this
        # thread (RLock re-entry); a pending one fires it later on the
        # settling engine/transport thread
        fut.add_done_callback(self._on_future)

    def _on_future(self, fut):
        with self._lock:
            if self.outcome is not None:
                return  # late settle against a cancelled/expired run
            try:
                value = fut.result(0)
            except Exception as e:
                self._on_error_locked(e)
                return
            self.steps_done += 1
            self._advance_locked(value)

    def _on_error_locked(self, exc):
        step = self._step
        label = None
        try:
            label = self.wf.classify(step, exc)
        except Exception:
            label = None
        if label is not None:
            self.error_code = _code_of(exc)
            self.outcome_label = label
            self._finish_locked(REJECTED)
            return
        if isinstance(exc, (ServiceRetryableError, TransientBackendError)):
            now = self.clock()
            if self._retries_left <= 0:
                self.error_code = _code_of(exc)
                self._finish_locked(RETRY_EXHAUSTED)
                return
            attempt = step.max_retries - self._retries_left
            self._retries_left -= 1
            self.retries += 1
            metrics.count("scenario_retries")
            hint = getattr(exc, "retry_after_s", None) or 0.0
            backoff = self.backoff_s * (2 ** attempt)
            delay = max(float(hint), backoff * (0.5 + self.rng.random()))
            ready_at = now + delay
            if self.deadline_at is not None and ready_at >= self.deadline_at:
                self.error_code = _code_of(exc)
                self._finish_locked(DEADLINE)
                return
            if self.on_park is not None:
                self.on_park(self, ready_at)
                return
            # ownerless (synchronous) mode: sleep inline and resubmit
            self.sleep(max(0.0, ready_at - self.clock()))
            self._submit_locked()
            return
        self.error_code = _code_of(exc)
        self._finish_locked(FAILED)

    def resubmit(self):
        """Driver wake-up after a park: resubmit the current step."""
        with self._lock:
            if self.outcome is None:
                self._submit_locked()

    def _finish_locked(self, outcome):
        self.outcome = outcome
        self.t_end = self.clock()
        self._gen = None  # drop generator frame (and its closures) now
        self._step = None
        metrics.count("scenario_%s" % outcome)
        try:
            self.wf.on_terminal(self)
        except Exception:
            metrics.count("scenario_hook_errors")
        if self.on_terminal is not None:
            try:
                self.on_terminal(self)
            except Exception:
                metrics.count("scenario_hook_errors")
        self._done_evt.set()


def _code_of(exc):
    """Stable short attribution for an exception: the wire error code
    when it has one, else the class name."""
    return getattr(exc, "code", None) or type(exc).__name__


def run_workflow(wf, clock=time.monotonic, sleep=time.sleep, seed=0,
                 timeout=120.0):
    """Synchronously drive one workflow to its terminal outcome and
    return the finished WorkflowRun — the unit-test / probe harness
    (the population driver runs thousands concurrently instead)."""
    run = WorkflowRun(wf, clock=clock, sleep=sleep, seed=seed)
    run.start()
    if run.wait(timeout) is None:
        run.cancel()
    return run
