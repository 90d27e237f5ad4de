"""ProtocolEngine: every online Coconut phase on ONE engine — the port's
copy of `coconut_tpu/engine/session.py`.

One ExecutionEngine instance, five registered programs, one device pool:

  verify        (serve.VerifyProgram, primary)   pool
  prepare       (phases.PrepareProgram)          pool
  show_prove    (phases.ShowProveProgram)        pool
  show_verify   (phases.ShowVerifyProgram)       pool
  mint          (issue.MintProgram)              own workers (authorities)

The pool programs multiplex heterogeneous batches over the same executors:
each executor carries a per-program dispatch registry and each program its
own shape key ("%ns_jit_shapes" counters). The mint program brings the
authority pool; its labels take an "m" prefix ("m1", "m2", ...) so
authority health keys never collide with pool executor labels ("0", "1",
...).

A full protocol session walks one credential through four online hops:

    prepare     -> (SignatureRequest, randomness)
    mint        -> credential (threshold blind-sign, verified release)
    show_prove  -> (proof, challenge, revealed_msgs)
    show_verify -> verdict bool

serve/loadgen.run_session_loadgen drives that pipeline and reports session
latency percentiles beside per-program goodput.

Differences from the reference, by the port's rules: `backend=None` is a
TorchBackend on `cuda` shared by every program and authority (raises
without a card; the reference's None is its host spec backend), and
`state_store=` (the replicated nullifier plane) raises ValueError until the
port has `state/`.
"""

import time

from ..issue.service import IssuanceOrder, MintProgram
from ..serve.service import VerifyProgram
from ..signature import Verkey
from .core import ExecutionEngine
from .phases import (
    PrepareProgram,
    ShowOrder,
    ShowProveProgram,
    ShowVerifyProgram,
)


class ProtocolEngine(ExecutionEngine):
    """One engine serving every online Coconut phase.

    signers/threshold: the issuing authority set (keygen.Signer list), also
    the source of the aggregated verkey when `vk` is None. count_hidden:
    the prepare lane's hidden-attribute count; revealed_msg_indices: the
    show lanes' shared disclosure set. backend: one backend (instance or
    registry name: "torch", "spec", "python") shared by every pool program
    and the authorities. devices: the pool shape, as CredentialService.
    keychain: a keylife.EpochRegistry; epoch-stamped credentials resolve
    their verkey by mint epoch on every phase. Self-healing knobs are the
    engine's (see serve/service.py)."""

    def __init__(
        self,
        signers,
        params,
        threshold,
        count_hidden,
        revealed_msg_indices,
        vk=None,
        backend=None,
        minter=None,
        devices=None,
        max_batch=32,
        max_wait_ms=20.0,
        max_depth=1024,
        pad_partial=True,
        clock=time.monotonic,
        health_policy=None,
        watchdog=None,
        watchdog_interval_s=0.25,
        brownout=None,
        hedge=None,
        max_redispatch=None,
        keychain=None,
        showv_mode=None,
        state_store=None,
        dead_letter_path=None,
    ):
        from ..backend import get_backend
        from ..batchverify import env_batched_default

        if state_store is not None:
            raise ValueError(
                "ProtocolEngine(state_store=...) needs state.StateStore and "
                "the nullifier guard, which are not ported to the PyTorch "
                "package yet"
            )
        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch")
        if showv_mode is None:
            # COCONUT_BATCH_VERIFY=1 defaults the show-verify lane onto
            # the combined pairing path
            showv_mode = "batched" if env_batched_default() else "exact"
        signers = list(signers)
        if vk is None:
            vk = Verkey.aggregate(
                threshold,
                [(s.id, s.verkey) for s in signers],
                ctx=params.ctx,
            )

        super().__init__(
            name="coconut-protocol",
            metric_ns="serve",
            clock=clock,
            health_policy=health_policy,
            watchdog=watchdog,
            watchdog_interval_s=watchdog_interval_s,
            brownout=brownout,
        )
        self.backend = backend
        self.vk = vk
        self.params = params
        self.threshold = threshold
        self.count_hidden = count_hidden
        self.revealed_msg_indices = list(revealed_msg_indices)
        #: keylife.EpochRegistry: epoch-stamped credentials resolve their
        #: verkey by mint epoch on every phase; None = one boot verkey
        self.keychain = keychain
        self.state_store = None

        common = dict(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_depth=max_depth,
        )
        self._verify = VerifyProgram(
            backend,
            vk,
            params,
            "per_credential",
            max_batch,
            max_wait_ms,
            max_depth,
            pad_partial,
            None,  # retry_policy: bind() installs the no-ladder default
            None,  # fallback_dispatch
            None,  # bisector (grouped-mode only)
            keychain=keychain,
        )
        self.register(self._verify)  # primary: the pool's seed dispatch
        self._prepare = PrepareProgram(
            params, count_hidden, backend=backend,
            pad_partial=pad_partial, **common
        )
        self._prove = ShowProveProgram(
            vk, params, self.revealed_msg_indices, backend=backend,
            pad_partial=pad_partial, keychain=keychain, **common
        )
        self._showv = ShowVerifyProgram(
            vk, params, backend=backend, pad_partial=pad_partial,
            keychain=keychain, mode=showv_mode, **common
        )
        for prog in (self._prepare, self._prove, self._showv):
            self.register(prog)

        # the shared pool: verify's device-pinned dispatch is each
        # executor's primary closure; the other pool programs seed their
        # own per-program closures on every executor
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
            dispatch, is_async = self._verify.make_dispatch(device=dev)
            self._add_executor(device=dev, dispatch=dispatch,
                               is_async=is_async)
        for prog in (self._prepare, self._prove, self._showv):
            self._seed_pool_program(prog)

        self._mint = MintProgram(
            signers,
            params,
            threshold,
            backend=backend,
            minter=minter,
            hedge=hedge,
            # non-numeric labels keep authority health keys disjoint from
            # pool executor labels; metrics read "issue_authm1_*"
            label_prefix="m",
            keychain=keychain,
            **common
        )
        self.register(self._mint)

        self._finalize_pool(max_redispatch)

    # -- key lifecycle -------------------------------------------------------

    def install_keyset(self, keyset):
        """KeyLifecycleManager hook: new share sets go to the mint
        program's authorities; verify and show resolve epochs straight off
        the shared keychain."""
        self._mint.install_keyset(keyset)
        self.threshold = self._mint.threshold

    def _check_epoch(self, epoch):
        """Submit-time pre-validation: an unknown or retired mint epoch
        refuses typed (EpochUnknownError / EpochRetiredError) before
        admission instead of failing a batch."""
        if self.keychain is not None and epoch is not None:
            self.keychain.resolve(epoch)

    # -- per-phase submission ------------------------------------------------

    def submit_verify(self, sig, messages, lane="interactive",
                      max_wait_ms=None):
        self._check_epoch(getattr(sig, "epoch", None))
        return self.submit_request(
            "verify", sig, messages, lane=lane, max_wait_ms=max_wait_ms
        )

    def submit_prepare(self, messages, elgamal_pk, lane="bulk",
                       max_wait_ms=None):
        """Future resolves to (SignatureRequest, randomness): the request
        goes to mint, the randomness is the caller's PoK witness. Bulk
        lane by default: prepare is throughput work."""
        return self.submit_request(
            "prepare", elgamal_pk, messages, lane=lane,
            max_wait_ms=max_wait_ms,
        )

    def submit_mint(self, sig_request, messages, elgamal_sk,
                    lane="interactive", max_wait_ms=None):
        """Future resolves to the minted (verified, aggregated)
        credential; `messages` is the full vector (the mint program's
        verify-before-release gate needs it)."""
        return self.submit_request(
            "mint",
            IssuanceOrder(sig_request, elgamal_sk),
            messages,
            lane=lane,
            max_wait_ms=max_wait_ms,
        )

    def submit_show_prove(self, sig, messages, lane="interactive",
                          max_wait_ms=None):
        """Future resolves to (proof, challenge, revealed_msgs)."""
        self._check_epoch(getattr(sig, "epoch", None))
        return self.submit_request(
            "show_prove", sig, messages, lane=lane, max_wait_ms=max_wait_ms
        )

    def submit_show_verify(self, proof, revealed_msgs, challenge=None,
                           epoch=None, domain=None, tag=None,
                           lane="interactive", max_wait_ms=None):
        """Future resolves to the show verdict bool. Pass the prover's
        `challenge` to skip the transcript re-hash; None recomputes it (the
        stranger-verifier path). `epoch` is the shown credential's mint
        epoch (None = the boot verkey); `domain` / `tag` are carried on
        the order as in the reference (they scope a nullifier, which needs
        a state store)."""
        self._check_epoch(epoch)
        return self.submit_request(
            "show_verify",
            ShowOrder(proof, challenge, epoch=epoch, domain=domain,
                      tag=tag),
            revealed_msgs,
            lane=lane,
            max_wait_ms=max_wait_ms,
        )
