"""First-t-of-n quorum tracking and credential minting — the port's copy
of `coconut_tpu/issue/quorum.py`.

The core threshold-issuance fact this module exploits: an aggregated
Coconut credential needs partial signatures from ANY t of the n
authorities, and every valid t-subset interpolates to the SAME signature
(Lagrange at 0 is subset-independent for a degree-(t-1) sharing). So the
service fans a coalesced batch to all live authorities and resolves the
moment the FIRST t partials land — the slowest n-t authorities are off
the latency path entirely, which is what makes hedging (hedge.py) a
latency optimization instead of a correctness requirement.

Three pieces:

  Fanout — one coalesced batch's fan-out record: the queue requests, the
    per-request SignatureRequests/messages/ElGamal secrets, which
    authorities were targeted, and the partial-signature rows that have
    landed so far, each attributed to ITS authority (per-partial
    PROVENANCE — when a minted credential fails verification, the minter
    re-checks each contributing partial under its authority's OWN verkey
    and the quorum drops exactly the culprit's row, never a bystander's).

  QuorumTracker — the arrival bookkeeping: `record()` files one
    authority's partial row and returns the first-t subset exactly once,
    when the t-th distinct row lands; late rows (straggler or hedge
    loser) and rows from abandoned workers are DISCARDED by the stale
    guard ("issue_partials_discarded") — same shape as serve/service.py's
    `_settle` stale check, keyed here on fan-out resolution instead of
    future.done().

  CryptoMinter — the crypto on the resolution path: batch-unblind the
    winning rows (per-request ElGamal secrets), Lagrange-aggregate via
    `signature.batch_aggregate` (ONE [B, t] distinct MSM), and verify
    every minted credential under the subset's aggregated verkey BEFORE
    release — a corrupt partial can waste a mint round, but a credential
    that doesn't verify is never handed to a client. A stub minter
    swaps this out so quorum/hedge logic tests run fake-clock,
    crypto-free. Its `backend=None` is a TorchBackend on `cuda` (raises
    without a card; the reference's None is its host spec backend).
"""

import threading
import time

from .. import metrics
from ..signature import (
    Verkey,
    batch_aggregate,
    batch_unblind,
)
from ..ps import batch_verify


class Fanout:
    """One coalesced batch's quorum state. Quorum-arrival fields
    (partials/order/dropped/pending/resolved/minting) mutate under the
    owning QuorumTracker's lock; dispatch bookkeeping (targets/failed)
    under the service's fan-out lock (issue/service.py `_flock`)."""

    __slots__ = (
        "fid",
        "requests",
        "sig_reqs",
        "messages_list",
        "sks",
        "bspan",
        "t_dispatch",
        "partials",
        "order",
        "dropped",
        "pending",
        "targets",
        "failed",
        "resolved",
        "minting",
        "quorum_at",
        "keyset",
        "threshold",
    )

    def __init__(self, fid, requests, sig_reqs, messages_list, sks, bspan, now,
                 keyset=None, threshold=None):
        self.fid = fid
        self.requests = requests
        self.sig_reqs = sig_reqs
        self.messages_list = messages_list
        self.sks = sks  # per-request ElGamal secrets, aligned with requests
        self.bspan = bspan
        self.t_dispatch = now
        #: signer_id -> [BlindSignature] * B, one row per contributing
        #: authority — the provenance record attribution reads from
        self.partials = {}
        self.order = []  # signer ids in row-arrival order (first-t basis)
        self.dropped = set()  # signer ids whose rows were attributed corrupt
        self.pending = set(range(len(requests)))  # unresolved request indices
        self.targets = {}  # label -> SigningAuthority currently signing this
        self.failed = set()  # labels that crashed/hung/failed on this fan-out
        self.resolved = False  # every request settled; late rows are stale
        self.minting = False  # a thread is inside the mint path right now
        self.quorum_at = None
        #: key-lifecycle pin (keylife.KeySet) this fan-out mints under —
        #: fixed at open so a mid-flight refresh/reshare never mixes
        #: partials from different sharings; None on the boot-keys path
        self.keyset = keyset
        #: quorum size for THIS fan-out (a reshare may change t for
        #: later fan-outs; in-flight ones keep the t they opened with)
        self.threshold = threshold

    def available_ids(self):
        """Contributing signer ids still usable for aggregation, in
        arrival order (dropped == attributed-corrupt rows excluded)."""
        return [i for i in self.order if i not in self.dropped]


class QuorumTracker:
    """Arrival bookkeeping for open fan-outs: exactly-once quorum
    resolution, stale/duplicate discard, and corrupt-row drops."""

    def __init__(self, threshold, clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1 (got %r)" % (threshold,))
        self.threshold = threshold
        self.clock = clock
        self._lock = threading.Lock()
        self._open = {}  # fid -> Fanout

    def open(self, fanout):
        with self._lock:
            self._open[fanout.fid] = fanout

    def record(self, fanout, signer_id, partials, now=None):
        """File one authority's partial row. Returns the first-t subset
        (signer ids, arrival order) exactly once — on the call that makes
        the quorum — else None. Stale rows (fan-out already resolved) and
        duplicate rows (a hedge racing the original of the SAME authority,
        or a redispatch overlap) are discarded, not filed: counted under
        "issue_partials_discarded"."""
        now = self.clock() if now is None else now
        with self._lock:
            if fanout.resolved or signer_id in fanout.partials:
                metrics.count("issue_partials_discarded", len(partials))
                return None
            fanout.partials[signer_id] = partials
            fanout.order.append(signer_id)
            t = fanout.threshold or self.threshold
            usable = len(fanout.available_ids())
            if usable < t or fanout.minting:
                return None
            fanout.minting = True
            if fanout.quorum_at is None:
                fanout.quorum_at = now
                metrics.observe("issue_quorum_wait_s", now - fanout.t_dispatch)
            return fanout.available_ids()[:t]

    def drop_partials(self, fanout, signer_ids):
        """Attribution verdict: these authorities' rows are corrupt —
        remove them from every future subset ("issue_corrupt_partials"
        is counted by the service, which also quarantines)."""
        with self._lock:
            fanout.dropped.update(signer_ids)

    def next_subset(self, fanout):
        """After a failed mint round (corrupt rows dropped): the next
        usable first-t subset, or None if the remaining rows can't make
        quorum yet. Caller must still hold the minting claim."""
        with self._lock:
            if fanout.resolved:
                return None
            t = fanout.threshold or self.threshold
            ids = fanout.available_ids()
            if len(ids) >= t:
                return ids[:t]
            fanout.minting = False  # wait for more rows to land
            return None

    def release_minting(self, fanout):
        """Give up the minting claim without resolving (mint-path crash
        containment) so a later row can retry the mint."""
        with self._lock:
            fanout.minting = False

    def settle(self, fanout, indices):
        """Mark request indices resolved; returns True when the fan-out
        is fully settled (caller then closes it everywhere: authority
        inboxes, hedge timers, watchdog labels)."""
        with self._lock:
            fanout.pending.difference_update(indices)
            done = not fanout.pending
            if done:
                fanout.resolved = True
                fanout.minting = False
            return done

    def close_fanout(self, fanout):
        """Drop a fully-settled (or force-failed) fan-out. Idempotent.
        Marks it resolved so any in-flight sign's row hits the stale
        guard instead of resurrecting the record."""
        with self._lock:
            fanout.resolved = True
            fanout.minting = False
            self._open.pop(fanout.fid, None)

    def outstanding(self):
        """Snapshot of still-open fan-outs (drain's final sweep)."""
        with self._lock:
            return list(self._open.values())


class CryptoMinter:
    """The resolution-path crypto: unblind -> Lagrange-aggregate ->
    verify-before-release, plus per-partial attribution when a mint
    fails. Pluggable (tests swap in a StubMinter) so quorum mechanics
    are testable without pairings."""

    def __init__(self, threshold, verkeys_by_id, params, backend=None):
        from ..backend import get_backend

        if backend is None or isinstance(backend, str):
            backend = get_backend(backend or "torch")
        self.threshold = threshold
        self.verkeys = dict(verkeys_by_id)  # signer_id -> per-signer Verkey
        self.params = params
        self.backend = backend
        self._agg_cache = {}  # sorted id tuple -> aggregated Verkey

    def _agg_verkey(self, subset):
        key = tuple(sorted(subset))
        vk = self._agg_cache.get(key)
        if vk is None:
            vk = Verkey.aggregate(
                self.threshold,
                [(i, self.verkeys[i]) for i in subset],
                ctx=self.params.ctx,
            )
            self._agg_cache[key] = vk
        return vk

    def unblind(self, blind_rows, sks):
        """blind_rows: per-request list of the subset's BlindSignatures;
        sks: per-request ElGamal secrets. One flattened batch_unblind
        call; returns per-request rows of partial Signatures."""
        flat, flat_sks, widths = [], [], []
        for row, sk in zip(blind_rows, sks):
            widths.append(len(row))
            flat.extend(row)
            flat_sks.extend([sk] * len(row))
        out = batch_unblind(
            flat, flat_sks, self.params.ctx, backend=self.backend
        )
        rows, at = [], 0
        for w in widths:
            rows.append(out[at : at + w])
            at += w
        return rows

    def aggregate(self, subset, sig_rows):
        """Lagrange-aggregate each request's subset row — one [B, t]
        distinct MSM via signature.batch_aggregate."""
        partials_list = [
            list(zip(subset, row)) for row in sig_rows
        ]
        return batch_aggregate(
            self.threshold,
            partials_list,
            ctx=self.params.ctx,
            backend=self.backend,
        )

    def verify(self, creds, messages_list, subset):
        """Per-credential verdicts under the subset's aggregated verkey —
        the release gate: only True lanes leave the service."""
        vk = self._agg_verkey(subset)
        return batch_verify(
            creds, messages_list, vk, self.params, backend=self.backend
        )

    def verify_partial(self, signer_id, sig, messages):
        """Attribution check: a partial Signature is itself a valid PS
        signature under ITS authority's own verkey — so when a mint
        fails, re-checking each contributing partial names the culprit
        authority exactly."""
        return sig.verify(messages, self.verkeys[signer_id], self.params)
