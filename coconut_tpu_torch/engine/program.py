"""The engine's program contract — the port's copy of
`coconut_tpu/engine/program.py`: what a workload registers to be served by
the executor fabric (engine/core.ExecutionEngine).

A *program* is a bundle of
  - an ENCODE step (`assemble`: coalesced requests -> device payload,
    including the program's pad-lane convention),
  - a DISPATCH closure (`run_dispatch`: payload -> finalizer, resolved
    per executor so device pinning works),
  - a DEMUX step (`demux`: device result -> per-request futures),
  - a PAD-LANE CONVENTION (`pad_convention`, documentation + the shape
    the shape key counts),
  - an SLO CLASS (`slo_class`, how the brownout policy treats the
    program's traffic), and
  - a SHAPE KEY (`shape_key`, fed to the engine's per-program
    "%ns_jit_shapes" counter),

plus queue sizing (max_batch / max_wait_ms / max_depth), a retry policy,
and lifecycle/health hooks for programs that bring their own workers
instead of using the shared device pool. Every hook has the
single-program default, so VerifyProgram overrides only the crypto."""

from ..retry import RetryPolicy
from ..serve.batcher import fail_all

#: SLO classes — how the brownout policy sees a program's submissions:
#:   "interactive"  never shed by brownout (hard admission bound only)
#:   "bulk"         always sheddable, whatever lane the caller named
#:   "standard"     the caller's lane decides (bulk sheds, interactive not)
SLO_CLASSES = ("interactive", "bulk", "standard")


class Program:
    """Base program: subclass and override the crypto seams. One instance
    registers on ONE engine (`engine.register(program)` calls `bind`)."""

    #: registry key; also stamped on requests, batch spans, dead letters
    name = "program"
    #: metric namespace ("serve", "issue", "prep", "prove", "showv")
    metric_ns = "serve"
    #: brownout SLO class (see SLO_CLASSES)
    slo_class = "standard"
    #: documentation string for the pad-lane convention
    pad_convention = "none"
    #: does this program ride the shared device pool? (False: the program
    #: brings its own workers)
    uses_pool = True
    #: may the engine route this program's batches to the mesh executor?
    supports_mesh = False

    max_batch = 64
    max_wait_ms = 20.0
    max_depth = 1024
    retry_policy = None

    def bind(self, engine):
        self.engine = engine
        if self.retry_policy is None:
            self.retry_policy = RetryPolicy(
                max_attempts=1, base_delay=0.0, retryable=()
            )

    # -- pool seeding --------------------------------------------------------

    def make_dispatch(self, device=None):
        """(dispatch, is_async) for one pool executor, or None to reuse
        the executor's primary dispatch closure."""
        return None

    # -- admission (engine.submit_request) -----------------------------------

    def shed_lane(self, lane):
        """The lane the brownout policy evaluates for a submission on
        `lane` — the program's SLO class applied (see SLO_CLASSES)."""
        if self.slo_class == "bulk":
            return "bulk"
        if self.slo_class == "interactive":
            return "interactive"
        return lane

    def capacity_fraction(self):
        """Degradation signal for brownout — pool programs inherit the
        engine's executor-pool fraction; own-worker programs override."""
        return self.engine._capacity_fraction()

    # -- placement (engine placer thread) ------------------------------------

    def capacity_ready(self):
        """ready() gate for this program's batcher."""
        return self.engine._has_capacity()

    def place(self, batch):
        """Route one coalesced batch; pool programs use the engine's
        adaptive placer, own-worker programs override."""
        self.engine._place(batch).submit_batch(batch)

    # -- batch work (engine._launch / _settle on executor threads) -----------

    def backend_label(self):
        """Stamped on the "dispatch" span (backend=...)."""
        return type(getattr(self, "backend", None)).__name__

    def assemble(self, requests, bspan):
        """Coalesced requests -> (payload_a, payload_b), the program's
        encode + pad step. Runs under the batch's "coalesce" span."""
        raise NotImplementedError

    def shape_key(self, requests, payload_a, payload_b):
        """The jit-shape cache key for this assembled batch (counted per
        program under "%ns_jit_shapes"). Default: the padded lane
        count."""
        try:
            return (len(payload_a),)
        except TypeError:
            return (len(requests),)

    def warm(self, shape_key):
        """Best-effort ahead-of-time priming of ONE shape — the lifecycle
        warmup's manifest-replay seam (engine/lifecycle.py). Return True
        when the shape was actually primed, so the engine may pre-count
        it under "%ns_jit_shapes". The default returns False, as the
        reference's does: the port has no jit, and a program whose
        dispatch cannot run without live request payloads leaves the
        shape's first-batch costs (the comb tables, the static operands)
        to its first dispatch."""
        return False

    def run_dispatch(self, executor, payload_a, payload_b):
        """Dispatch the assembled batch on `executor`; returns the
        finalizer the engine blocks on in _settle."""
        return executor.dispatch_for(self.name)(payload_a, payload_b)

    def make_fallback(self, payload_a, payload_b):
        """Zero-arg degraded-path callable for the retry ladder, or None."""
        return None

    def demux(self, requests, result, payload_a, payload_b, seq, attempts,
              bspan):
        """Device result -> per-request futures; must end `bspan`."""
        raise NotImplementedError

    def fail_batch(self, requests, exc):
        """Batch-level failure past retry+fallback: resolve every future
        with the exception (never a silent hang)."""
        fail_all(
            requests, exc, counter="%s_failed_requests" % self.metric_ns
        )

    # -- lifecycle / health hooks (own-worker programs) ----------------------

    def refresh_health_gauges(self):
        pass

    def start_workers(self):
        pass

    def close_workers(self):
        pass

    def join_workers(self, deadline):
        return True

    def on_drain(self):
        """After workers joined: settle whatever could not complete."""

    def on_crash(self, exc):
        """Engine-wide crash: fail anything this program still holds."""

    def owns_expiry(self, entry):
        """Does this program claim a watchdog expiry `entry`
        ((label, seq, payload, span, overdue_s))? Pool dispatches are
        handled by the engine; own-worker programs claim their own."""
        return False

    def handle_expired(self, entry, now):
        pass

    def tick(self, now):
        """Per-health-tick hook (hedge timers, own-worker probation)."""
