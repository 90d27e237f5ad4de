"""Key lifecycle manager — the port's copy of
`coconut_tpu/keylife/manager.py`: DKG bootstrap, proactive refresh and t/n
reshare, rolled into the EpochRegistry and every attached service
(anything with `install_keyset(keyset)`: IssuanceService, ProtocolEngine).

  reshare   install keys on every authority first (epoch PENDING), only
            then activate(): the instant new mints pin the new epoch every
            authority can sign under it, and fan-outs pinned to the old
            epoch drain undisturbed.

  refresh   the aggregated verkey of the refreshed share set must be
            byte-identical (Verkey.to_bytes) to the current one before the
            new gen is installed; a refresh that moves it is a corrupt
            round and is never installed.

Neither path forms a master secret: rounds return per-signer shares, and
the aggregation here is of public verkeys.
"""

from .. import metrics
from ..errors import GeneralError
from ..signature import Verkey
from ..sss import PedersenVSS
from .dkg import run_dkg, run_refresh
from .epoch import EpochRegistry, KeySet


def aggregate_vk(keyset_or_signers, threshold=None, ctx=None):
    """Aggregated (epoch) verkey from any `threshold` of the signers'
    public verkeys — the key credentials minted from this set verify
    under."""
    if isinstance(keyset_or_signers, KeySet):
        signers = keyset_or_signers.signers
        threshold = keyset_or_signers.threshold
    else:
        signers = keyset_or_signers
        if threshold is None:
            raise GeneralError("threshold required when passing raw signers")
    return Verkey.aggregate(
        threshold, [(s.id, s.verkey) for s in signers], ctx=ctx
    )


class KeyLifecycleManager:
    """Drives DKG/refresh/reshare rounds and rolls the results into the
    registry and every attached service."""

    def __init__(self, params, label=b"coconut-tpu keylife", window=3,
                 registry=None):
        self.params = params
        self.registry = registry if registry is not None else EpochRegistry(
            window=window
        )
        self.g, self.h = PedersenVSS.gens(label)
        self._services = []
        self.last_round = None  # audit trail of the most recent round

    # -- wiring ---------------------------------------------------------------

    def attach(self, service):
        """Register a service to receive keysets. Replays already-live
        epochs so late-attached services can serve them immediately."""
        self._services.append(service)
        for epoch, state in self.registry.live_epochs():
            if state in ("active", "retiring"):
                service.install_keyset(self.registry.resolve(epoch))

    def _install(self, keyset):
        for svc in self._services:
            svc.install_keyset(keyset)

    # -- rounds ---------------------------------------------------------------

    def bootstrap(self, threshold, total, unreachable=(), tamper=None):
        """First DKG: mint epoch 1 (or the next free id) and activate it.
        Raises DkgAbortedError if fewer than `threshold` honest dealers
        participate."""
        result = run_dkg(
            threshold, total, self.params, self.g, self.h,
            round="dkg", unreachable=unreachable, tamper=tamper,
        )
        keyset = self._keyset_from(result, gen=0)
        self.registry.register(keyset)
        self._install(keyset)
        self.registry.activate(keyset.epoch)
        self.last_round = result
        return keyset

    def refresh(self, unreachable=(), tamper=None):
        """Proactive share refresh of the ACTIVE epoch: same epoch, same
        verkey (asserted bit-identical), gen+1, every share changed."""
        current = self.registry.active()
        result = run_refresh(
            current.signers, current.threshold, self.params, self.g, self.h,
            round="refresh", unreachable=unreachable, tamper=tamper,
        )
        ctx = self.params.ctx
        new_vk = aggregate_vk(result.signers, current.threshold, ctx=ctx)
        if new_vk.to_bytes(ctx) != current.vk.to_bytes(ctx):
            raise GeneralError(
                "refresh round moved the verkey for epoch %d — corrupt "
                "round, not installing" % current.epoch
            )
        keyset = KeySet(
            epoch=current.epoch,
            gen=current.gen + 1,
            threshold=current.threshold,
            signers=result.signers,
            vk=current.vk,  # unchanged by construction, asserted above
            qual=result.qual,
            excluded=result.excluded,
        )
        self.registry.install_gen(keyset)
        self._install(keyset)
        self.last_round = result
        metrics.count("keylife_refreshes")
        return keyset

    def reshare(self, threshold=None, total=None, unreachable=(),
                tamper=None):
        """t/n-changing reshare: a fresh DKG under the new parameters,
        rolled out as a NEW epoch (new verkey) via the two-phase
        install-then-activate handoff. In-flight mints complete under
        the epoch they pinned; its credentials keep verifying until the
        old epoch retires out of the window."""
        current = self.registry.active()
        threshold = threshold if threshold is not None else current.threshold
        total = total if total is not None else current.total
        result = run_dkg(
            threshold, total, self.params, self.g, self.h,
            round="reshare", unreachable=unreachable, tamper=tamper,
        )
        keyset = self._keyset_from(result, gen=0)
        self.registry.register(keyset)  # PENDING: nothing serves it yet
        self._install(keyset)  # every authority can sign under it...
        self.registry.activate(keyset.epoch)  # ...before mints pin it
        self.last_round = result
        metrics.count("keylife_reshares")
        return keyset

    def _keyset_from(self, result, gen):
        return KeySet(
            epoch=self.registry.next_epoch(),
            gen=gen,
            threshold=result.threshold,
            signers=result.signers,
            vk=aggregate_vk(
                result.signers, result.threshold, ctx=self.params.ctx
            ),
            qual=result.qual,
            excluded=result.excluded,
        )
