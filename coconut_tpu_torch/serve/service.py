"""The online credential-verify service — the port's copy of
`coconut_tpu/serve/service.py`: a thin *program* registered on the
execution engine (engine/core.py), which owns the executor pool, the
placer, the health registry (circuit breakers, hung-dispatch watchdog,
probation revival, redistribution with hop caps), brownout admission and
the generic launch/settle path. What remains here is the verify phase's
crypto and policy:

  VerifyProgram     the engine program: encode (identity-lane padding in
                    per_credential mode), dispatch (stream._dispatchers
                    through the backends' *_async seams, pinned to the
                    executor's card), demux (per-credential bits, or the
                    grouped accept/bisect ladder with dead-lettered
                    culprits), and the retry/fallback policy.
  CredentialService an ExecutionEngine subclass that registers ONE
                    VerifyProgram, builds the device pool from its
                    constructor knobs, and keeps the reference's public
                    API (`submit`, `drain`, `shutdown`, `health_tick`,
                    context manager) and metric and span names.

Request path: `submit()` -> brownout check -> admission control ->
coalesce -> place -> identity-pad -> dispatch under retry/fallback ->
demux -> future resolves. Metrics: "serve_latency_s", "serve_dev*",
"serve_placed_*", the health gauges, the shed counters; batch spans carry
`program="verify"`.

Differences from the reference, by the port's rules: `backend=None` is a
TorchBackend on `cuda` (raises without a card; the reference's None is its
host spec backend), `devices` is an int or a list of `torch.device`, and
`mesh=` takes a gpu/shard.py Mesh. `CredentialService`
also takes `keychain=` (a keylife.EpochRegistry), which the reference's
passes to its VerifyProgram only through ProtocolEngine: credentials then
verify under their mint epoch's verkey, and `submit` refuses an unknown or
retired epoch typed before admission, as ProtocolEngine.submit_verify does.
"""

import time

from ..engine.core import ExecutionEngine, _next_pow2
from ..engine.program import Program
from ..retry import RetryPolicy
from ..stream import _dispatchers, _fallback_dispatcher, _make_bisector
from .batcher import demux, fail_all, pad_batch


class VerifyProgram(Program):
    """The show-verify-credential phase as an engine program: coalesced
    credential batches, identity-lane padding, grouped bisection."""

    name = "verify"
    metric_ns = "serve"
    slo_class = "standard"  # the caller's lane decides shedding
    pad_convention = "identity-credential"
    supports_mesh = True

    def __init__(
        self,
        backend,
        vk,
        params,
        mode,
        max_batch,
        max_wait_ms,
        max_depth,
        pad_partial,
        retry_policy,
        fallback_dispatch,
        bisector,
        keychain=None,
    ):
        if keychain is not None and mode in ("grouped", "batched"):
            # grouped/batched modes fold the whole batch into one device
            # bool; per-epoch verkeys need per-group dispatch, which
            # defeats it
            raise ValueError("keychain requires per_credential mode")
        self.backend = backend
        self.vk = vk
        self.params = params
        self.mode = mode
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self.pad_partial = pad_partial
        self.retry_policy = retry_policy
        self._fallback_dispatch = fallback_dispatch
        self._bisector = bisector
        #: keylife.EpochRegistry: when set, each credential's `epoch`
        #: attribute resolves the verkey it verifies under (TorchBackend's
        #: static-operand LRU keys on the verkey, so per-epoch tables
        #: coexist); credentials without one fall back to the boot `vk`
        self.keychain = keychain

    # -- epoch resolution ----------------------------------------------------

    def vk_for_epoch(self, epoch):
        """The verkey a credential minted under `epoch` verifies against.
        Raises the typed EpochUnknownError / EpochRetiredError — at submit
        time via the engine's pre-validation, or from inside a dispatch
        when an epoch retires mid-flight (the batch then fails typed)."""
        if epoch is None or self.keychain is None:
            return self.vk
        return self.keychain.resolve(epoch).vk

    def _dispatch_by_epoch(self, fn, sigs, messages_list):
        """Split one coalesced batch by mint epoch and dispatch each group
        under its epoch's verkey, launching every group before finalizing
        any; the returned finalize thunk reassembles the verdicts by
        index. One epoch per steady-state batch, so the common case is one
        full-width dispatch."""
        groups = {}
        for i, s in enumerate(sigs):
            groups.setdefault(getattr(s, "epoch", None), []).append(i)
        launched = []
        for epoch, idxs in sorted(
            groups.items(), key=lambda kv: (kv[0] is not None, kv[0] or 0)
        ):
            vk = self.vk_for_epoch(epoch)
            launched.append(
                (
                    idxs,
                    fn(
                        [sigs[i] for i in idxs],
                        [messages_list[i] for i in idxs],
                        vk,
                    ),
                )
            )

        def finalize():
            out = [False] * len(sigs)
            for idxs, thunk in launched:
                for i, v in zip(idxs, thunk()):
                    out[i] = bool(v)
            return out

        return finalize

    # -- engine hooks --------------------------------------------------------

    def make_dispatch(self, device=None):
        dispatch, _, is_async = _dispatchers(
            self.backend, self.mode, device=device
        )
        return dispatch, is_async

    def shape_key(self, requests, payload_a, payload_b):
        if self.mode == "batched":
            # the combined program pads lanes to a power of two
            # internally — key on THAT shape
            return ("batched", _next_pow2(max(1, len(payload_a))))
        return super().shape_key(requests, payload_a, payload_b)

    def assemble(self, requests, bspan):
        if self.pad_partial:
            sigs, messages_list, n_pad = pad_batch(requests, self.max_batch)
            bspan.set(n_pad=n_pad)
        else:
            sigs = [r.sig for r in requests]
            messages_list = [r.messages for r in requests]
        return sigs, messages_list

    def run_dispatch(self, executor, sigs, messages_list):
        # the bare `.dispatch` attribute, not the program registry: the
        # verify program is every pool executor's primary dispatch (and
        # tests stub `ex.dispatch` directly)
        if self.keychain is None:
            return executor.dispatch(sigs, messages_list, self.vk, self.params)
        return self._dispatch_by_epoch(
            lambda s, m, vk: executor.dispatch(s, m, vk, self.params),
            sigs,
            messages_list,
        )

    def make_fallback(self, sigs, messages_list):
        if self._fallback_dispatch is None:
            return None
        if self.keychain is None:
            return lambda: self._fallback_dispatch(
                sigs, messages_list, self.vk, self.params
            )()
        return lambda: self._dispatch_by_epoch(
            lambda s, m, vk: self._fallback_dispatch(s, m, vk, self.params)(),
            sigs,
            messages_list,
        )

    def demux(self, requests, result, sigs, messages_list, seq, attempts,
              bspan):
        clock = self.engine.clock
        if self.mode == "per_credential":
            demux(requests, result[: len(requests)], clock=clock)
            bspan.end(result="demuxed")
            return
        if result:
            demux(requests, [True] * len(requests), clock=clock)
            bspan.end(result="accepted")
            return
        # grouped rejection: recover per-request verdicts by bisection so
        # one forged credential fails only its own future; culprit
        # dead-letter lines carry the CULPRIT request's trace_id (not the
        # batch's), so an operator greps straight from a JSONL line to
        # the request's span tree — which names the device via its batch
        # span
        culprits = (
            set(
                self._bisector(
                    sigs,
                    messages_list,
                    seq,
                    attempts,
                    trace_ids=[r.future.trace_id for r in requests],
                )
            )
            if self._bisector is not None
            else set(range(len(requests)))
        )
        for i in culprits:
            if i < len(requests):
                requests[i].span.event("dead_letter", batch_seq=seq)
        demux(
            requests,
            [i not in culprits for i in range(len(requests))],
            clock=clock,
        )
        bspan.end(result="bisected", n_culprits=len(culprits))

    def fail_batch(self, requests, exc):
        fail_all(requests, exc)


class CredentialService(ExecutionEngine):
    """Dynamic-batching verify service over any verify-capable backend.

    backend / fallback_backend: instances or registry names ("torch",
    "spec", ...); backend=None is a TorchBackend on `cuda`, which raises
    where no card is present (pass TorchBackend(device="cpu") or "spec"
    to run on the CPU). mode: "per_credential" (bits demux directly), "grouped"
    (one device bool per batch; a rejection bisects to per-request
    verdicts, culprits dead-lettered), or "batched" (ONE
    RLC-combined pairing product + shared final exponentiation per batch,
    same accept/bisect ladder as grouped but the bisection probes re-draw
    combiners per sub-slice). mode=None resolves via COCONUT_BATCH_VERIFY
    ("1"/"batched" -> "batched", else "per_credential").
    max_batch: the coalesced device
    shape. max_wait_ms: default per-request coalescing deadline.
    max_depth: admission bound. pad_partial: identity-pad partial batches
    to max_batch (per_credential mode), the reference's default — grouped
    mode never pads, its encode pads internally to a power of two.
    clock: injectable time source for deadline tests.

    Pool shape: `devices` is None (one executor), an int N (N executors —
    worker-thread parallelism without placement), or a list of
    `torch.device` (one executor pinned to each card through
    stream._pin_to_device; one backend serves them all, its caches keyed
    by card). `mesh` (a gpu/shard.py Mesh) adds the sharded executor: the
    engine places bulk batches of at least `sharded_min_lanes` (default
    max_batch) on it (stream._dispatchers' mesh branch).

    Self-healing knobs (serve/health.py): `health_policy` configures the
    per-executor circuit breaker, `watchdog` the hung-dispatch deadline
    tracker (pass one with a fake clock for deterministic tests),
    `watchdog_interval_s` the background health-tick period (None
    disables the thread — tests then drive `health_tick()` by hand),
    `brownout` the graded load-shedding policy, `max_redispatch` the hop
    cap for redistributed batches (default: pool size - 1, so a poisonous
    batch can visit each survivor at most once before failing loudly).
    `keychain`: a keylife.EpochRegistry resolving each credential's mint
    epoch to its verkey (per_credential mode only; `vk` stays the verkey
    of credentials without an epoch and of pad lanes). `state_store`: a
    state.StateStore the service keeps, as the reference's does; a
    verify-only service carries no nullifier guard (double spends live
    on the show-verify lane, engine/phases.py)."""

    def __init__(
        self,
        backend,
        vk,
        params,
        mode=None,
        max_batch=64,
        max_wait_ms=20.0,
        max_depth=1024,
        retry_policy=None,
        fallback_backend=None,
        dead_letter_path=None,
        pad_partial=True,
        clock=time.monotonic,
        devices=None,
        mesh=None,
        sharded_min_lanes=None,
        health_policy=None,
        watchdog=None,
        watchdog_interval_s=0.25,
        brownout=None,
        max_redispatch=None,
        state_store=None,
        keychain=None,
    ):
        from ..backend import get_backend
        from ..errors import TransientBackendError

        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch")
        if isinstance(fallback_backend, str):
            fallback_backend = get_backend(fallback_backend)
        if mode is None:
            # COCONUT_BATCH_VERIFY=1 defaults new services onto the
            # RLC-combined path; unset keeps per_credential
            from ..batchverify import env_batched_default

            mode = "batched" if env_batched_default() else "per_credential"
        if mode not in ("per_credential", "grouped", "batched"):
            raise ValueError("unknown serve mode %r" % (mode,))

        super().__init__(
            name="coconut-serve",
            metric_ns="serve",
            clock=clock,
            mesh=mesh,
            sharded_min_lanes=(
                max_batch if sharded_min_lanes is None else sharded_min_lanes
            ),
            health_policy=health_policy,
            watchdog=watchdog,
            watchdog_interval_s=watchdog_interval_s,
            brownout=brownout,
        )

        self.backend = backend
        self.vk = vk
        self.params = params
        self.mode = mode
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.pad_partial = pad_partial and mode == "per_credential"
        self.state_store = state_store

        self._fallback_dispatch = (
            _fallback_dispatcher(fallback_backend, mode)
            if fallback_backend is not None
            else None
        )
        if retry_policy is None:
            # mirror verify_stream: no ladder means transient errors go
            # straight to the fallback when one exists, else propagate
            retry_policy = RetryPolicy(
                max_attempts=1,
                base_delay=0.0,
                retryable=(
                    (TransientBackendError,)
                    if self._fallback_dispatch is not None
                    else ()
                ),
            )
        self._bisector = (
            _make_bisector(
                backend,
                fallback_backend,
                vk,
                params,
                retry_policy,
                dead_letter_path,
                program="verify",
                predicate="combined" if mode == "batched" else "grouped",
            )
            if mode in ("grouped", "batched")
            else None
        )

        self._program = VerifyProgram(
            backend,
            vk,
            params,
            mode,
            max_batch,
            max_wait_ms,
            max_depth,
            self.pad_partial,
            retry_policy,
            self._fallback_dispatch,
            self._bisector,
            keychain=keychain,
        )
        self.keychain = keychain
        self.register(self._program)

        # the device pool: one executor per device, the verify program's
        # device-pinned dispatch as each executor's primary closure
        if devices is None:
            device_list = [None]
        elif isinstance(devices, int):
            if devices < 1:
                raise ValueError("devices must be >= 1 (got %r)" % (devices,))
            device_list = [None] * devices
        else:
            device_list = list(devices)
            if not device_list:
                raise ValueError("devices list must be non-empty")
        for dev in device_list:
            dispatch, is_async = self._program.make_dispatch(device=dev)
            self._add_executor(device=dev, dispatch=dispatch,
                               is_async=is_async)

        if mesh is not None:
            pad_to = None
            if mode == "grouped" and "dp" in mesh.shape:
                # ONE grouped shape whatever the occupancy: the sharded
                # encode's own floor (2*ndp) or the service's max batch
                # rounded to the program's power of two, whichever is larger
                pad_to = max(2 * mesh.shape["dp"], _next_pow2(max_batch))
            mesh_dispatch, _, _ = _dispatchers(
                backend, mode, mesh=mesh, mesh_pad_to=pad_to
            )
            self._set_mesh_executor(mesh_dispatch)

        self._finalize_pool(max_redispatch)

    # -- client side ---------------------------------------------------------

    def submit(self, sig, messages, lane="interactive", max_wait_ms=None):
        """Admit one verify request; returns its ServeFuture (resolves to
        the request's own verdict bool). Raises ServiceBrownoutError when
        graded load-shedding refuses this lane (retriable, carries a
        retry-after hint), ServiceOverloadedError at the admission bound,
        ServiceClosedError after drain/shutdown; with a keychain,
        EpochUnknownError / EpochRetiredError for a credential whose mint
        epoch does not resolve."""
        epoch = getattr(sig, "epoch", None)
        if self.keychain is not None and epoch is not None:
            self.keychain.resolve(epoch)
        return self.submit_request(
            "verify", sig, messages, lane=lane, max_wait_ms=max_wait_ms
        )
