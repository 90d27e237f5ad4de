"""The threshold-issuance service — the port's copy of
`coconut_tpu/issue/service.py`: quorum fan-out over a pool of signing
authorities, first-t-of-n aggregation, and straggler-hedged minting,
packaged as a *program* on the execution engine (engine/core.py).

Where serve/service.py answers "is this credential valid?" against ONE
verkey, this service MINTS credentials against a t-of-n authority pool:
each request's SignatureRequest is blind-signed by every live authority
(quorum fan-out), the first t partial signatures to land are unblinded,
Lagrange-aggregated, and verified under the subset's aggregated verkey,
and only a credential that VERIFIES is released to its future.

The generic serving machinery — bounded admission, coalescing, the
placer thread, the watchdog loop, brownout, lifecycle — is the engine's
(engine/). What lives HERE is the mint phase itself:

  MintProgram      an own-worker engine program (uses_pool=False): it
                   brings the SigningAuthority pool instead of riding
                   the shared device pool, replaces least-loaded
                   placement with quorum fan-out, keeps its own
                   authority health registry in the "issue_auth*"
                   namespace, claims ITS watchdog expiries (hung signs)
                   via `owns_expiry`, and runs hedge timers + authority
                   probation in the engine's health tick.
  IssuanceService  an ExecutionEngine subclass registering ONE
                   MintProgram, with the historical public API and
                   every historical metric/span name.

What is NEW versus the verify pool: quorum.py (QuorumTracker:
first-t-wins, per-partial provenance, drop-and-retry attribution),
hedge.py (straggler hedging: hedge early, quarantine late), authority.py
(per-share signing executors). Failure ladder, per fan-out: a sign FAULT
marks the target
failed and re-covers from spares; a sign HANG is expired by the
watchdog (worker abandoned, authority quarantined, coverage restored);
an authority-loop CRASH quarantines only that authority. When live +
landed contributors can no longer reach t, the fan-out's remaining
futures fail with the typed, retriable QuorumUnreachableError — loud,
attributable, and never a dangling future. Drain settles everything in
flight under one shared deadline and sweeps whatever could not reach
quorum.

Differences from the reference, by the port's rules: `backend=None` is ONE
TorchBackend on `cuda` shared by every authority and the minter (raises
without a card; the reference's None is its host spec backend), `devices`
is a list of `torch.device`.
"""

import threading
import time

from .. import metrics
from ..engine.core import ExecutionEngine, _remaining
from ..engine.program import Program
from ..errors import (
    GeneralError,
    QuorumUnreachableError,
)
from ..obs import trace as otrace
from ..serve import health as _health
from ..serve.batcher import fail_all
from .authority import SigningAuthority
from .hedge import HedgePolicy, HedgeScheduler
from .quorum import CryptoMinter, Fanout, QuorumTracker


class IssuanceOrder:
    """One request's issuance payload, carried in the queue Request's
    `sig` slot (the queue is payload-agnostic): the blind-sign request
    plus the user's ElGamal secret the service unblinds with."""

    __slots__ = ("sig_request", "elgamal_sk")

    def __init__(self, sig_request, elgamal_sk):
        self.sig_request = sig_request
        self.elgamal_sk = elgamal_sk


class MintProgram(Program):
    """The blind-sign/mint phase as an own-worker engine program: quorum
    fan-out over the authority pool, first-t-of-n aggregation, hedging.

    `label_prefix` namespaces authority labels (and their watchdog/
    health keys) when the program shares an engine with pool executors
    whose labels are bare indices — the standalone IssuanceService keeps
    the historical bare str(signer.id) labels."""

    name = "mint"
    metric_ns = "issue"
    slo_class = "standard"
    pad_convention = "none"
    uses_pool = False

    def __init__(
        self,
        signers,
        params,
        threshold,
        backend=None,
        backends=None,
        devices=None,
        minter=None,
        hedge=None,
        max_batch=32,
        max_wait_ms=20.0,
        max_depth=1024,
        label_prefix="",
        keychain=None,
    ):
        signers = list(signers)
        if not signers:
            raise ValueError("need at least one signer")
        if threshold < 1 or threshold > len(signers):
            raise ValueError(
                "threshold %r out of range for %d signers"
                % (threshold, len(signers))
            )
        if backends is not None and len(backends) != len(signers):
            raise ValueError(
                "backends list length %d != %d signers"
                % (len(backends), len(signers))
            )
        if devices is not None and len(devices) != len(signers):
            raise ValueError(
                "devices list length %d != %d signers"
                % (len(devices), len(signers))
            )
        self.signers = signers
        self.params = params
        self.threshold = threshold
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self._backend = backend
        self._backends = backends
        self._devices = devices
        self._minter = minter
        self._hedge = hedge
        self._label_prefix = label_prefix
        #: keylife.EpochRegistry: when set, every fan-out pins the active
        #: KeySet at open and mints under it start to finish, minted
        #: credentials carry their epoch, and a refresh or reshare landing
        #: mid-flight never disturbs in-flight work. None = every fan-out
        #: mints under the boot keys.
        self.keychain = keychain

    def bind(self, engine):
        super().bind(engine)
        if (
            self._backends is None or self._minter is None
        ) and (self._backend is None or isinstance(self._backend, str)):
            # one backend instance (one set of comb caches) for every
            # authority and the minter; a stub pool with its own minter
            # never builds one
            from ..backend import get_backend

            self._backend = get_backend(self._backend or "torch")
        self._authorities = [
            SigningAuthority(
                self,
                s,
                backend=(
                    self._backends[i]
                    if self._backends is not None
                    else self._backend
                ),
                device=(
                    self._devices[i] if self._devices is not None else None
                ),
                label=(
                    self._label_prefix + str(s.id)
                    if self._label_prefix
                    else None
                ),
            )
            for i, s in enumerate(self.signers)
        ]
        self.minter = (
            self._minter
            if self._minter is not None
            else CryptoMinter(
                self.threshold,
                {s.id: s.verkey for s in self.signers},
                self.params,
                backend=self._backend,
            )
        )
        self._tracker = QuorumTracker(self.threshold, clock=engine.clock)
        self._minters = {}  # (epoch, gen) -> CryptoMinter for that KeySet
        self.hedge_policy = (
            self._hedge if self._hedge is not None else HedgePolicy()
        )
        self._hedges = HedgeScheduler(clock=engine.clock)
        #: dispatch bookkeeping lock: Fanout.targets / Fanout.failed and
        #: spare-selection decisions (quorum-arrival state is under the
        #: tracker's own lock; never take _flock while holding it)
        self._flock = threading.Lock()
        self._healths = {}
        for auth in self._authorities:
            self._health_of(auth.label)
        for auth in self._authorities:
            metrics.set_gauge(
                "issue_auth%s_health" % auth.label, _health.HEALTHY
            )
        self.refresh_health_gauges()

    # -- engine hooks --------------------------------------------------------

    @property
    def _queue(self):
        return self.engine._runtimes[self.name].queue

    def capacity_fraction(self):
        ok = sum(
            1
            for a in self._authorities
            if self._health_of(a.label).admissible()
        )
        return ok / len(self._authorities)

    def capacity_ready(self):
        return self._has_quorum_capacity()

    def place(self, batch):
        self._fan_out(batch)

    def refresh_health_gauges(self):
        metrics.set_gauge(
            "issue_healthy_authorities",
            sum(
                1
                for a in self._authorities
                if self._health_of(a.label).admissible()
            ),
        )

    # -- key lifecycle -------------------------------------------------------

    def install_keyset(self, keyset):
        """Install one keylife.KeySet: each authority gets its share from
        the set's signers, and a per-set CryptoMinter (per-signer verkeys
        for attribution, aggregated-verkey cache for the release gate) is
        readied. KeyLifecycleManager calls this before the epoch activates,
        so every authority can sign under it the instant fan-outs pin it.
        A reshare's new quorum size takes effect for fan-outs opened from
        then on; in-flight ones carry the threshold they pinned."""
        for auth in self._authorities:
            s = keyset.signer(auth.id)
            if s is not None:
                auth.install_keys(keyset.key, s.sigkey, s.verkey)
        self._minters[keyset.key] = CryptoMinter(
            keyset.threshold,
            keyset.verkeys_by_id(),
            self.params,
            backend=self._backend,
        )
        self.threshold = keyset.threshold

    def _minter_for(self, keyset):
        if keyset is None:
            return self.minter
        m = self._minters.get(keyset.key)
        if m is None:
            raise GeneralError(
                "no minter installed for epoch %d gen %d"
                % (keyset.epoch, keyset.gen)
            )
        return m

    def start_workers(self):
        for auth in self._authorities:
            auth.start()

    def close_workers(self):
        for auth in self._authorities:
            auth.close()

    def join_workers(self, deadline):
        ok = True
        for auth in self._authorities:
            ok = auth.join(_remaining(deadline)) and ok
        return ok

    def on_drain(self):
        self._sweep_unreachable()

    def on_crash(self, e):
        """Engine crash sweep: fail every open fan-out's unresolved
        futures with the crash exception, close the authority pool."""
        for f in self._tracker.outstanding():
            pending = [
                i for i in f.pending if not f.requests[i].future.done()
            ]
            if pending:
                self._fail_requests(f, pending, e)
            self._close_fanout(f, result="crashed")
        for auth in self._authorities:
            auth.close()

    def owns_expiry(self, entry):
        # watchdog entries this program began carry a Fanout payload;
        # pool dispatches carry a request list
        return isinstance(entry[2], Fanout)

    def handle_expired(self, entry, now):
        """One hung sign: abandon the stuck worker, quarantine its
        authority, restore the fan-out's quorum coverage."""
        label, fid, fanout, span, overdue_s = entry
        metrics.count("issue_watchdog_timeouts")
        if span is not None:
            span.event(
                "watchdog_timeout",
                authority=label,
                overdue_s=round(overdue_s, 6),
            )
        auth = self._auth_by_label(label)
        if auth is None:
            return
        self._health_of(label).on_crash("hung sign: watchdog timeout")
        swept = auth.abandon()
        self.engine._watchdog.forget_label(label)
        self.refresh_health_gauges()
        self._hedges.end(fid, label)
        for f in [fanout] + swept:
            self._mark_failed(f, label)
            self._ensure_coverage(f)
        self.engine._kick_all()

    def tick(self, now):
        """Per-health-tick: fire due hedges (dispatch a spare for each
        straggling sign) and promote cooled-down authorities into
        half-open probation."""
        for fanout, label, overdue_s in self._hedges.due(now):
            if fanout.resolved:
                continue
            spare = self._pick_spare(fanout)
            if spare is None:
                metrics.count("issue_hedge_no_spare")
                continue
            metrics.count("issue_hedges")
            fanout.bspan.event(
                "hedge",
                straggler=label,
                spare=spare.label,
                overdue_s=round(overdue_s, 6),
            )
            self._dispatch_to(fanout, spare, now=now)
        for auth in self._authorities:
            if self._health_of(auth.label).try_probation(now):
                auth.start()  # respawn an abandoned worker; no-op otherwise
                self.refresh_health_gauges()
                self.engine._kick_all()

    # -- health --------------------------------------------------------------

    def _health_of(self, label):
        h = self._healths.get(label)
        if h is None:
            h = self._healths[label] = _health.ExecutorHealth(
                label,
                self.engine.health_policy,
                clock=self.engine.clock,
                metric_ns="issue",
                gauge_prefix="issue_auth",
            )
        return h

    def _admits(self, auth):
        """May NEW fan-out work target `auth`? Same half-open discipline
        as the verify pool: PROBATION gets one probe dispatch at a time."""
        h = self._health_of(auth.label)
        if not h.admissible():
            return False
        if h.state == _health.PROBATION and auth.queued() > 0:
            return False
        return True

    def _note_success(self, auth):
        change = self._health_of(auth.label).on_success()
        if change:
            self.refresh_health_gauges()
            self.engine._kick_all()

    def _note_failure(self, auth, reason):
        """A sign dispatch (or a partial-signature attribution) failed ON
        this authority: feed its breaker; on quarantine, move its queued
        fan-outs' coverage to spares (soft — the worker stays alive)."""
        change = self._health_of(auth.label).on_failure(reason)
        if change:
            self.refresh_health_gauges()
            self.engine._kick_all()
            if change[1] == _health.QUARANTINED:
                for f in auth.sweep_inbox():
                    self._mark_failed(f, auth.label)
                    self._ensure_coverage(f)

    def _authority_failed(self, auth, exc, inflight, gen):
        """Authority-loop crash containment (runs ON the dying worker's
        thread): quarantine ONLY this authority, re-cover its fan-outs
        from spares. Stale generations (already abandoned by the
        watchdog) do nothing."""
        if not auth.is_current(gen):
            return
        metrics.count("issue_authority_crashes")
        self._health_of(auth.label).on_crash(
            "authority loop crash: %s" % type(exc).__name__
        )
        swept = auth.abandon()
        self.engine._watchdog.forget_label(auth.label)
        self.refresh_health_gauges()
        affected = ([inflight] if inflight is not None else []) + swept
        for f in affected:
            self._mark_failed(f, auth.label)
            self._ensure_coverage(f)
        self.engine._kick_all()

    def _auth_by_label(self, label):
        for a in self._authorities:
            if a.label == label:
                return a
        return None

    def _sweep_unreachable(self):
        """Drain's last act: any fan-out still open could not assemble a
        quorum in time — fail its unresolved futures loudly (typed,
        retriable) so no caller ever hangs on a dropped future."""
        for f in self._tracker.outstanding():
            with self._flock:
                have = len(f.available_ids())
            pending = [
                i for i in f.pending if not f.requests[i].future.done()
            ]
            if pending:
                metrics.count("issue_quorum_unreachable")
                self._fail_requests(
                    f,
                    pending,
                    QuorumUnreachableError(
                        f.threshold or self.threshold,
                        have,
                        live=0,
                        program=self.name,
                    ),
                )
            self._close_fanout(f, result="swept")

    # -- fan-out -------------------------------------------------------------

    def _has_quorum_capacity(self):
        """ready() gate for the batcher: pop a batch only when at least
        `threshold` admissible authorities can accept it — otherwise the
        backlog stays in the bounded queue where admission control and
        the brownout policy see it."""
        return (
            sum(
                1
                for a in self._authorities
                if self._admits(a) and a.can_accept()
            )
            >= self.threshold
        )

    def _fan_out(self, requests):
        """Open one fan-out for a coalesced batch and dispatch it to
        every live authority at once (first-t-wins makes over-dispatch
        the latency strategy)."""
        fid = self.engine._next_seq()
        now = self.engine.clock()
        targets = [
            a for a in self._authorities if self._admits(a) and a.can_accept()
        ]
        if len(targets) < self.threshold:
            # the ready gate normally prevents this; a drain-time flush
            # (closed queue bypasses the gate) widens to anything alive
            targets = [
                a
                for a in self._authorities
                if self._health_of(a.label).admissible() or a.has_worker()
            ]
        if len(targets) < self.threshold:
            metrics.count("issue_quorum_unreachable")
            fail_all(
                requests,
                QuorumUnreachableError(
                    self.threshold, 0, live=len(targets), program=self.name
                ),
                counter="issue_failed_requests",
            )
            return
        keyset = None
        if self.keychain is not None:
            # pin AFTER the early-fail paths so every pin has a matching
            # unpin in _close_fanout; the pin holds this KeySet's epoch
            # out of retirement until the fan-out closes
            try:
                keyset = self.keychain.pin_active()
            except GeneralError as e:
                fail_all(requests, e, counter="issue_failed_requests")
                return
        bspan = otrace.start_span(
            "issue_batch",
            root=True,
            seq=fid,
            n=len(requests),
            quorum=self.threshold,
            fanout_width=len(targets),
            members=[r.future.trace_id for r in requests]
            if otrace.enabled()
            else None,
        )
        for r in requests:
            r.span.set(batch_trace=bspan.trace_id, batch_seq=fid)
        f = Fanout(
            fid,
            requests,
            [r.sig.sig_request for r in requests],
            [r.messages for r in requests],
            [r.sig.elgamal_sk for r in requests],
            bspan,
            now,
            keyset=keyset,
            threshold=keyset.threshold if keyset is not None else None,
        )
        self._tracker.open(f)
        metrics.observe(
            "issue_batch_wait_s", now - min(r.t_submit for r in requests)
        )
        metrics.set_gauge("issue_queue_depth", self._queue.depth())
        for auth in targets:
            self._dispatch_to(f, auth, now=now)

    def _dispatch_to(self, fanout, auth, now=None):
        """Dispatch one fan-out to one authority: deadline-track the sign
        (watchdog from BEFORE the dispatch — a hung sign never returns),
        arm its hedge timer, enqueue."""
        now = self.engine.clock() if now is None else now
        with self._flock:
            if fanout.resolved or auth.label in fanout.targets:
                return False
            fanout.targets[auth.label] = auth
        if self._health_of(auth.label).state == _health.PROBATION:
            metrics.count("issue_probes")
        self.engine._watchdog.begin(
            auth.label, fanout.fid, fanout, span=fanout.bspan, now=now
        )
        self._hedges.begin(
            fanout, auth.label, self.hedge_policy.budget(auth.label), now=now
        )
        auth.submit(fanout)
        return True

    def _mark_failed(self, fanout, label):
        with self._flock:
            fanout.failed.add(label)
        self._hedges.end(fanout.fid, label)

    def _pick_spare(self, fanout):
        """An admissible authority this fan-out has not targeted yet (and
        whose rows were not attributed corrupt), least-queued first."""
        with self._flock:
            targeted = set(fanout.targets)
        spares = [
            a
            for a in self._authorities
            if a.label not in targeted
            and a.id not in fanout.dropped
            and self._admits(a)
            and a.has_worker()
        ]
        if not spares:
            return None
        return min(spares, key=lambda a: (a.queued(), a.id))

    def _ensure_coverage(self, fanout):
        """Re-check that landed + still-signing contributors can reach t;
        dispatch spares to close any gap ("issue_redispatched"), and when
        no spare can close it, fail the fan-out's unresolved requests
        with the typed, retriable QuorumUnreachableError."""
        t = fanout.threshold or self.threshold
        while True:
            if fanout.resolved:
                return
            with self._flock:
                have = len(fanout.available_ids())
                inflight = sum(
                    1
                    for label, a in fanout.targets.items()
                    if label not in fanout.failed
                    and a.id not in fanout.partials
                    and a.id not in fanout.dropped
                )
            if have + inflight >= t:
                return
            spare = self._pick_spare(fanout)
            if spare is None:
                break
            if self._dispatch_to(fanout, spare):
                metrics.count("issue_redispatched")
        pending = [
            i for i in fanout.pending if not fanout.requests[i].future.done()
        ]
        if not pending:
            return
        with self._flock:
            have = len(fanout.available_ids())
        metrics.count("issue_quorum_unreachable")
        self._fail_requests(
            fanout,
            pending,
            QuorumUnreachableError(t, have, live=have, program=self.name),
        )
        if self._tracker.settle(fanout, pending):
            self._close_fanout(fanout, result="unreachable")

    # -- sign + mint (run on authority threads) ------------------------------

    def _sign_fanout(self, auth, fanout, gen):
        """One authority's turn on one fan-out: sign the coalesced batch
        under its share, file the row, and — on the call that completes
        the quorum — mint."""
        if fanout.resolved:
            # first-t-wins already resolved this fan-out (cancel raced
            # the pop): skip the sign, settle the trackers
            metrics.count("issue_sign_skips")
            self.engine._watchdog.end(
                auth.label, fanout.fid, now=self.engine.clock()
            )
            self._hedges.end(fanout.fid, auth.label)
            return
        t0 = self.engine.clock()
        try:
            with metrics.timer(auth.busy_timer):
                partials = auth.sign(
                    fanout.sig_reqs, self.params, keyset=fanout.keyset
                )
        except Exception as e:
            # sign FAULT (not a crash — the worker survives): mark this
            # target failed, breaker the authority, restore coverage
            self.engine._watchdog.end(
                auth.label, fanout.fid, ok=False, now=self.engine.clock()
            )
            self._mark_failed(fanout, auth.label)
            self._note_failure(
                auth, "sign dispatch failed: %s" % type(e).__name__
            )
            self._ensure_coverage(fanout)
            return
        now = self.engine.clock()
        if not auth.is_current(gen):
            # stale worker: the watchdog expired this sign and the
            # fan-out was re-covered — the late row is nobody's news
            metrics.count("issue_partials_discarded", len(partials))
            return
        self.engine._watchdog.end(auth.label, fanout.fid, now=now)
        self._hedges.end(fanout.fid, auth.label)
        self.hedge_policy.observe(auth.label, now - t0)
        self._note_success(auth)
        subset = self._tracker.record(fanout, auth.id, partials, now=now)
        while subset is not None:
            subset = self._mint(fanout, subset)

    def _mint(self, fanout, subset):
        """One mint round over `subset` (the caller holds the tracker's
        minting claim): unblind -> batch-aggregate -> verify under the
        aggregated verkey. Passing lanes release; failing lanes trigger
        per-partial attribution, the culprit's rows drop, and the round
        retries from the next subset (returned; None = done or waiting
        for more rows)."""
        indices = sorted(fanout.pending)
        if not indices:
            self._tracker.settle(fanout, [])
            self._close_fanout(fanout, result="minted")
            return None
        blind_rows = [
            [fanout.partials[i][idx] for i in subset] for idx in indices
        ]
        sks = [fanout.sks[idx] for idx in indices]
        messages_list = [fanout.messages_list[idx] for idx in indices]
        minter = self._minter_for(fanout.keyset)
        try:
            with otrace.use(fanout.bspan):
                with otrace.span("unblind", n=len(indices), t=len(subset)):
                    sig_rows = minter.unblind(blind_rows, sks)
                with otrace.span("aggregate", subset=list(subset)):
                    creds = minter.aggregate(subset, sig_rows)
                with otrace.span("verify", n=len(indices)):
                    verdicts = minter.verify(
                        creds, messages_list, subset
                    )
        except Exception as e:
            # the mint crypto itself failed (malformed subset row, code
            # bug): fail THIS fan-out's unresolved lanes loudly — the
            # authorities are fine, the partials were not
            metrics.count("issue_mint_failures")
            self._fail_requests(fanout, indices, e)
            if self._tracker.settle(fanout, indices):
                self._close_fanout(fanout, result="mint_failed")
            return None
        ok_idx = [i for i, v in zip(indices, verdicts) if v]
        bad_pos = [p for p, v in enumerate(verdicts) if not v]
        if ok_idx:
            self._release(
                fanout,
                ok_idx,
                {
                    idx: cred
                    for idx, cred, v in zip(indices, creds, verdicts)
                    if v
                },
            )
        if not bad_pos:
            if self._tracker.settle(fanout, ok_idx):
                self._close_fanout(fanout, result="minted")
                return None
            return self._tracker.next_subset(fanout)
        if ok_idx:
            self._tracker.settle(fanout, ok_idx)
        # ATTRIBUTION: an aggregated credential failed verification, so
        # at least one contributing partial is corrupt — re-verify each
        # failing lane's partials under their authorities' OWN verkeys
        # to name the culprits exactly (per-partial provenance)
        culprits = set()
        for p in bad_pos:
            row = sig_rows[p]
            msgs = messages_list[p]
            for j, signer_id in enumerate(subset):
                if signer_id in culprits:
                    continue
                if not minter.verify_partial(signer_id, row[j], msgs):
                    culprits.add(signer_id)
        if not culprits:
            # every partial checks out yet the aggregate does not: the
            # REQUEST itself is unservable (e.g. inconsistent messages
            # vs its own commitment) — fail just those lanes, typed
            bad_idx = [indices[p] for p in bad_pos]
            metrics.count("issue_mint_failures")
            self._fail_requests(
                fanout,
                bad_idx,
                GeneralError(
                    "minted credential failed verification with no "
                    "attributable corrupt partial — request unservable"
                ),
            )
            if self._tracker.settle(fanout, bad_idx):
                self._close_fanout(fanout, result="mint_failed")
                return None
            return self._tracker.next_subset(fanout)
        metrics.count("issue_corrupt_partials", len(culprits))
        fanout.bspan.event("corrupt_partials", authorities=sorted(culprits))
        self._tracker.drop_partials(fanout, culprits)
        for signer_id in culprits:
            auth = next(
                (a for a in self._authorities if a.id == signer_id), None
            )
            if auth is not None:
                self._note_failure(auth, "corrupt partial signature")
        subset = self._tracker.next_subset(fanout)
        if subset is None:
            # not enough clean rows yet: the minting claim was released;
            # make sure enough contributors are still coming
            self._ensure_coverage(fanout)
        return subset

    def _release(self, fanout, indices, creds_by_idx):
        """Hand verified credentials to their futures — the ONLY path a
        credential leaves the service on, and it is behind the verify
        gate by construction."""
        now = self.engine.clock()
        epoch = fanout.keyset.epoch if fanout.keyset is not None else None
        for idx in indices:
            r = fanout.requests[idx]
            cred = creds_by_idx[idx]
            if epoch is not None:
                # the credential's mint epoch rides with it (and over the
                # wire): verify resolves the aggregated verkey by epoch
                cred.epoch = epoch
            metrics.observe("issue_latency_s", now - r.t_submit)
            r.span.end(verdict=True)
            r.future.set_result(cred)
        metrics.count("issue_minted", len(indices))

    def _fail_requests(self, fanout, indices, exc):
        for idx in indices:
            r = fanout.requests[idx]
            r.queue_span.end()
            r.span.end(error=type(exc).__name__)
            r.future.set_exception(exc)
        if indices:
            metrics.count("issue_failed_requests", len(indices))

    def _close_fanout(self, fanout, result):
        """Fully settled (or force-failed): close the record everywhere —
        tracker (marks resolved: late rows discard), hedge timers, every
        authority's queued copy (a canceled queued sign ends its watchdog
        deadline too; one mid-sign finishes and ends its own)."""
        self._tracker.close_fanout(fanout)
        self._hedges.cancel(fanout.fid)
        with self._flock:
            # swap-then-unpin so a double close (sweep racing a late
            # settle) never unpins twice
            keyset, fanout.keyset = fanout.keyset, None
        if keyset is not None and self.keychain is not None:
            self.keychain.unpin(keyset)
        now = self.engine.clock()
        for auth in self._authorities:
            if auth.cancel(fanout.fid):
                self.engine._watchdog.end(auth.label, fanout.fid, now=now)
                metrics.count("issue_cancelled_signs")
        fanout.bspan.end(result=result)


class IssuanceService(ExecutionEngine):
    """Dynamic-batching threshold-issuance service over a signer pool.

    signers: keygen.Signer list (id, sigkey share, per-signer verkey) —
    the authority pool; threshold: t, the quorum size. backend: default
    backend (instance or name) for every authority AND the minter — None
    is one TorchBackend on `cuda`, which raises where no card is present
    (pass TorchBackend(device="cpu") or "spec" to run on the CPU);
    backends: optional per-authority override list aligned with signers
    (chaos tests wrap ONE authority's backend in faults.FaultyBackend
    without touching the others); devices: optional per-authority
    `torch.device` list (device-pinned sign dispatch). minter: the resolution
    crypto (default quorum.CryptoMinter; tests inject a stub to exercise
    quorum mechanics fake-clock, crypto-free).

    Self-healing knobs mirror serve/service.py: health_policy per-
    authority breaker, watchdog for hung signs, watchdog_interval_s the
    health-tick period (None = tests drive health_tick() by hand),
    brownout for graded shedding, hedge a hedge.HedgePolicy (None: the
    default policy). keychain: a keylife.EpochRegistry whose active KeySet
    each fan-out pins (KeyLifecycleManager.attach installs the sets)."""

    def __init__(
        self,
        signers,
        params,
        threshold,
        backend=None,
        backends=None,
        devices=None,
        minter=None,
        max_batch=32,
        max_wait_ms=20.0,
        max_depth=1024,
        clock=time.monotonic,
        health_policy=None,
        watchdog=None,
        watchdog_interval_s=0.25,
        hedge=None,
        brownout=None,
        keychain=None,
    ):
        super().__init__(
            name="coconut-issue",
            metric_ns="issue",
            clock=clock,
            health_policy=health_policy,
            watchdog=watchdog,
            watchdog_interval_s=watchdog_interval_s,
            brownout=brownout,
        )
        self._crash_msg = "issuance service crashed: %r"
        self._program = MintProgram(
            signers,
            params,
            threshold,
            backend=backend,
            backends=backends,
            devices=devices,
            minter=minter,
            hedge=hedge,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            max_depth=max_depth,
            keychain=keychain,
        )
        self.register(self._program)
        self.params = params
        self.threshold = threshold
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms

    # -- client side ---------------------------------------------------------

    def submit(
        self, sig_request, messages, elgamal_sk, lane="interactive",
        max_wait_ms=None,
    ):
        """Admit one issuance request; returns a ServeFuture resolving to
        the minted (verified, aggregated) Signature. `messages` is the
        FULL message vector (hidden + known — the verification gate needs
        it; the authorities only ever see `sig_request`). Raises
        ServiceBrownoutError / ServiceOverloadedError / ServiceClosedError
        exactly like the verify service."""
        return self.submit_request(
            "mint",
            IssuanceOrder(sig_request, elgamal_sk),
            messages,
            lane=lane,
            max_wait_ms=max_wait_ms,
        )

    # -- key lifecycle -------------------------------------------------------

    @property
    def keychain(self):
        return self._program.keychain

    def install_keyset(self, keyset):
        self._program.install_keyset(keyset)
        self.threshold = self._program.threshold

    # -- historical surface (delegating to the mint program) -----------------

    @property
    def minter(self):
        return self._program.minter

    @property
    def hedge_policy(self):
        return self._program.hedge_policy

    @property
    def _authorities(self):
        return self._program._authorities

    @property
    def _tracker(self):
        return self._program._tracker

    @property
    def _hedges(self):
        return self._program._hedges

    def _health_of(self, label):
        return self._program._health_of(label)

    def _capacity_fraction(self):
        return self._program.capacity_fraction()
