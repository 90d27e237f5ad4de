"""The prepare, show-prove and show-verify phases as engine programs — the
port's copy of `coconut_tpu/engine/phases.py`. Each rides the shared
executor pool beside the verify program (serve.VerifyProgram), with its
own queue, metric namespace, SLO class, pad-lane convention and shape key:

  PrepareProgram     user-side PrepareBlindSign, batched ("prep" ns, bulk
                     SLO): coalesced unrelated users, each encrypting under
                     their own ElGamal key (signature.batch_prepare_blind_sign
                     with one public key a request). Pad lanes repeat the
                     last request's row.
  ShowProveProgram   prover side of Show ("prove" ns, interactive SLO):
                     pok_sig.batch_show over the coalesced credentials, one
                     revealed-index set a program. Pad lanes repeat the last
                     credential.
  ShowVerifyProgram  verifier side of Show ("showv" ns, interactive SLO):
                     ps.batch_show_verify with explicit per-lane challenges.
                     Pad lanes clone the first proof and its challenge.

With a keychain (keylife.EpochRegistry) the show programs split a batch by
mint epoch and run each group under its epoch's verkey.
ExecutionEngine._seed_pool_program gives every executor each program's
dispatch closure, and the per-program "%ns_jit_shapes" counters count the
distinct shapes dispatched.
engine/session.ProtocolEngine registers all five phases on one engine.

`ShowVerifyProgram(nullifiers=..., dead_letters=...)` is the double-spend
guard: nullifiers derived at assemble time, a membership probe on the
guard's device masking each spent lane's own bit inside the dispatch, and
in demux the authoritative check-and-set with one WAL group commit before
any future resolves (a failed commit fails the accepted lanes with
TransientBackendError; a spent lane resolves to DoubleSpendError and a
schema-v4 dead-letter line).
"""

from .. import metrics
from ..obs import trace as otrace
from .program import Program


class ShowOrder:
    """One show-verify submission: the proof, its Fiat-Shamir challenge
    (None = recompute from the transcript at assemble time), the mint epoch
    of the credential shown (None = the boot verkey), and the nullifier's
    `domain` / `tag` (kept for the reference's signature; without a state
    store they are unused)."""

    __slots__ = ("proof", "challenge", "epoch", "domain", "tag")

    def __init__(self, proof, challenge=None, epoch=None, domain=None,
                 tag=None):
        self.proof = proof
        self.challenge = challenge
        self.epoch = epoch
        self.domain = domain
        self.tag = tag


def _group_by_epoch(epochs):
    """index lists per epoch, preserving arrival order within a group."""
    groups = {}
    for i, e in enumerate(epochs):
        groups.setdefault(e, []).append(i)
    return groups


def _demux_results(requests, results, metric_ns, clock):
    """Resolve each request's future with its own lane's output (pad
    lanes beyond len(requests) are discarded)."""
    with otrace.span("demux", n=len(requests)):
        now = clock()
        for req, out in zip(requests, results):
            metrics.observe("%s_latency_s" % metric_ns, now - req.t_submit)
            req.span.end(ok=True)
            req.future.set_result(out)
        metrics.count("%s_done" % metric_ns, len(requests))


class PrepareProgram(Program):
    """Batched user-side PrepareBlindSign: submit (messages, elgamal_pk),
    receive (SignatureRequest, randomness), randomness = [r, k_1..k_h] (the
    PoK witness). One `count_hidden` per program instance."""

    name = "prepare"
    metric_ns = "prep"
    slo_class = "bulk"  # throughput work: first to shed under brownout
    pad_convention = "repeat-last-row"

    def __init__(self, params, count_hidden, backend=None, max_batch=64,
                 max_wait_ms=20.0, max_depth=1024, pad_partial=True):
        self.params = params
        self.count_hidden = count_hidden
        self.backend = backend
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self.pad_partial = pad_partial

    def make_dispatch(self, device=None):
        from ..signature import batch_prepare_blind_sign

        params, count_hidden, backend = (
            self.params, self.count_hidden, self.backend,
        )

        def dispatch(messages_list, pks):
            out = batch_prepare_blind_sign(
                messages_list, count_hidden, list(pks), params,
                backend=backend,
            )
            return lambda: out

        return dispatch, False

    def assemble(self, requests, bspan):
        messages_list = [list(r.messages) for r in requests]
        pks = [r.sig for r in requests]
        n_pad = max(0, self.max_batch - len(requests))
        if self.pad_partial and n_pad:
            messages_list.extend([list(messages_list[-1])] * n_pad)
            pks.extend([pks[-1]] * n_pad)
            metrics.count("prep_pad_lanes", n_pad)
            bspan.set(n_pad=n_pad)
        return messages_list, pks

    def shape_key(self, requests, payload_a, payload_b):
        # the device hash-to-G1 program is a path of its own: key it, so a
        # switch mid-run shows up as a new shape
        hash_path = (
            "devhash"
            if getattr(self.backend, "device_hash_enabled", None) is not None
            and self.backend.device_hash_enabled()
            else "hosthash"
        )
        return (len(payload_a), hash_path)

    def demux(self, requests, result, messages_list, pks, seq, attempts,
              bspan):
        _demux_results(requests, result, self.metric_ns, self.engine.clock)
        bspan.end(result="demuxed")


class ShowProveProgram(Program):
    """Batched prover side of Show: submit (credential, messages), receive
    (proof, challenge, revealed_msgs). One revealed-index set per program
    instance (pok_sig.batch_show's batchable shape)."""

    name = "show_prove"
    metric_ns = "prove"
    slo_class = "interactive"  # a user is waiting on their own proof
    pad_convention = "repeat-credential"

    def __init__(self, vk, params, revealed_msg_indices, backend=None,
                 max_batch=64, max_wait_ms=20.0, max_depth=1024,
                 pad_partial=True, keychain=None):
        self.vk = vk
        self.params = params
        self.revealed_msg_indices = list(revealed_msg_indices)
        self.backend = backend
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self.pad_partial = pad_partial
        #: keylife.EpochRegistry: a credential's `epoch` attribute picks
        #: the verkey its show proof is built against
        self.keychain = keychain

    def _vk_for(self, epoch):
        if epoch is None or self.keychain is None:
            return self.vk
        return self.keychain.resolve(epoch).vk

    def make_dispatch(self, device=None):
        from ..pok_sig import batch_show

        params, revealed, backend = (
            self.params, self.revealed_msg_indices, self.backend,
        )

        def dispatch(sigs, messages_list):
            if self.keychain is None:
                out = batch_show(
                    sigs, self.vk, params, messages_list, revealed,
                    backend=backend,
                )
                return lambda: out
            # epoch-partitioned: each group proves against its epoch's
            # verkey (one epoch per steady-state batch; rollovers rare)
            groups = _group_by_epoch([getattr(s, "epoch", None) for s in sigs])
            proofs = [None] * len(sigs)
            challenges = [None] * len(sigs)
            revealed_out = [None] * len(sigs)
            for epoch, idxs in groups.items():
                p, c, rv = batch_show(
                    [sigs[i] for i in idxs],
                    self._vk_for(epoch),
                    params,
                    [messages_list[i] for i in idxs],
                    revealed,
                    backend=backend,
                )
                for i, pi, ci, ri in zip(idxs, p, c, rv):
                    proofs[i], challenges[i], revealed_out[i] = pi, ci, ri
            out = (proofs, challenges, revealed_out)
            return lambda: out

        return dispatch, False

    def assemble(self, requests, bspan):
        sigs = [r.sig for r in requests]
        messages_list = [list(r.messages) for r in requests]
        n_pad = max(0, self.max_batch - len(requests))
        if self.pad_partial and n_pad:
            sigs.extend([sigs[-1]] * n_pad)
            messages_list.extend([list(messages_list[-1])] * n_pad)
            metrics.count("prove_pad_lanes", n_pad)
            bspan.set(n_pad=n_pad)
        return sigs, messages_list

    def shape_key(self, requests, payload_a, payload_b):
        # the distinct MSM behind batch_show has two schedules, Horner and
        # bucketed, chosen by gpu/backend._bucket_window from the backend's
        # bucket_mode: key that mode, so a change mid-run shows up as a
        # new shape
        mode = getattr(self.backend, "bucket_mode", None)
        return (len(payload_a), "msm%s" % (mode,))

    def demux(self, requests, result, sigs, messages_list, seq, attempts,
              bspan):
        proofs, challenges, revealed_list = result
        _demux_results(
            requests,
            list(zip(proofs, challenges, revealed_list)),
            self.metric_ns,
            self.engine.clock,
        )
        bspan.end(result="demuxed")


class ShowVerifyProgram(Program):
    """Batched verifier side of Show: submit a ShowOrder (proof [+
    challenge]) with its revealed-message map, receive the verdict bool.
    Challenges always go to ps.batch_show_verify explicitly — pad lanes
    clone the first proof, and a cloned lane reuses its original's
    challenge."""

    name = "show_verify"
    metric_ns = "showv"
    slo_class = "interactive"
    pad_convention = "clone-first-proof"

    def __init__(self, vk, params, backend=None, max_batch=64,
                 max_wait_ms=20.0, max_depth=1024, pad_partial=True,
                 keychain=None, mode="exact", nullifiers=None,
                 dead_letters=None):
        if mode not in ("exact", "batched"):
            raise ValueError("unknown show-verify mode %r" % (mode,))
        if mode == "batched" and backend is None:
            raise ValueError(
                "show-verify mode='batched' requires a backend"
            )
        self.vk = vk
        self.params = params
        self.backend = backend
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self.pad_partial = pad_partial
        #: "exact" re-checks every lane's two pairings; "batched" folds the
        #: batch into ONE combined pairing product, bisecting on rejection
        self.mode = mode
        #: keylife.EpochRegistry: each ShowOrder's `epoch` picks the
        #: verkey its proof verifies (and re-hashes) against
        self.keychain = keychain
        #: state.NullifierGuard: when set, every lane derives a nullifier
        #: from its transcript, a device membership probe is fused ahead
        #: of the verify bit, and accepted nullifiers are WAL-group-
        #: committed BEFORE any future resolves — a double-spent lane
        #: resolves to a typed DoubleSpendError
        self.nullifiers = nullifiers
        #: faults.DeadLetterLog: double-spend rejections append a
        #: schema-v4 line carrying the spent nullifier
        self.dead_letters = dead_letters

    def _vk_for(self, epoch):
        if epoch is None or self.keychain is None:
            return self.vk
        return self.keychain.resolve(epoch).vk

    def make_dispatch(self, device=None):
        from ..ps import batch_show_verify

        params, backend = self.params, self.backend

        def dispatch(proofs, aux):
            revealed_list, challenges = aux[0], aux[1]
            epochs = aux[2] if len(aux) > 2 else None
            digests = aux[3] if len(aux) > 3 else None
            null_epochs = aux[4] if len(aux) > 4 else None
            null_domains = aux[5] if len(aux) > 5 else None
            if epochs is None:
                out = list(batch_show_verify(
                    proofs, self.vk, params, revealed_list,
                    challenges=challenges, backend=backend,
                    mode=self.mode,
                ))
            else:
                out = [False] * len(proofs)
                for epoch, idxs in _group_by_epoch(epochs).items():
                    bits = batch_show_verify(
                        [proofs[i] for i in idxs],
                        self._vk_for(epoch),
                        params,
                        [revealed_list[i] for i in idxs],
                        challenges=[challenges[i] for i in idxs],
                        backend=backend,
                        mode=self.mode,
                        epoch=epoch,
                    )
                    for i, b in zip(idxs, bits):
                        out[i] = bool(b)
            if digests is not None and self.nullifiers is not None:
                # fused double-spend probe: a spent lane fails ITS OWN
                # verify bit here, inside the batch computation, not in
                # a serial post-pass. Advisory — the table snapshot may
                # lag a concurrent commit; demux's check-and-set under
                # the store lock is authoritative either way, so a
                # probe failure degrades to commit-time detection.
                try:
                    spent = self.nullifiers.probe(
                        digests, null_epochs, domains=null_domains
                    )
                except Exception:
                    spent = None
                    metrics.count("nullifier_probe_errors")
                if spent is not None:
                    out = [
                        bool(b) and not s for b, s in zip(out, spent)
                    ]
            return lambda: out

        return dispatch, False

    def shape_key(self, requests, payload_a, payload_b):
        if self.mode == "batched":
            # the combined show program clone-pads to a power of two — the
            # shape key is that padded width, not the raw count
            from .core import _next_pow2

            return ("batched", _next_pow2(max(1, len(payload_a))))
        return super().shape_key(requests, payload_a, payload_b)

    def assemble(self, requests, bspan):
        from ..signature import fiat_shamir_challenge

        proofs = [r.sig.proof for r in requests]
        revealed_list = [dict(r.messages) for r in requests]
        epochs = (
            [getattr(r.sig, "epoch", None) for r in requests]
            if self.keychain is not None
            else None
        )
        challenges = [
            r.sig.challenge
            if r.sig.challenge is not None
            else fiat_shamir_challenge(
                r.sig.proof.to_bytes_for_challenge(
                    # a stranger-verifier transcript re-hash must bind the
                    # verkey the prover hashed: the mint epoch's
                    self._vk_for(getattr(r.sig, "epoch", None)),
                    self.params,
                )
            )
            for r in requests
        ]
        digests = null_epochs = null_domains = None
        if self.nullifiers is not None:
            from ..state.nullifier import nullifier_of

            # derived BEFORE padding: pad lanes clone lane 0's digest
            # below, and demux never looks past len(requests), so a
            # cloned pad digest can never masquerade as a second spend
            null_epochs = [
                getattr(r.sig, "epoch", None) for r in requests
            ]
            null_domains = [
                getattr(r.sig, "domain", None) for r in requests
            ]
            digests = [
                nullifier_of(
                    p, c, e, self.params,
                    domain=dom, tag=getattr(r.sig, "tag", None),
                )
                for p, c, e, dom, r in zip(
                    proofs, challenges, null_epochs, null_domains,
                    requests,
                )
            ]
        n_pad = max(0, self.max_batch - len(requests))
        if self.pad_partial and n_pad:
            proofs.extend([proofs[0]] * n_pad)
            revealed_list.extend([dict(revealed_list[0])] * n_pad)
            challenges.extend([challenges[0]] * n_pad)
            if epochs is not None:
                epochs.extend([epochs[0]] * n_pad)
            if digests is not None:
                digests.extend([digests[0]] * n_pad)
                null_epochs.extend([null_epochs[0]] * n_pad)
                null_domains.extend([null_domains[0]] * n_pad)
            metrics.count("showv_pad_lanes", n_pad)
            bspan.set(n_pad=n_pad)
        if digests is not None:
            return proofs, (
                revealed_list, challenges, epochs, digests, null_epochs,
                null_domains,
            )
        if epochs is not None:
            return proofs, (revealed_list, challenges, epochs)
        return proofs, (revealed_list, challenges)

    def _reject_double_spend(self, req, digest, epoch, seq, lane,
                             domain=None):
        """Resolve one lane as a typed double-spend rejection (and
        dead-letter it with the spent nullifier, schema v4)."""
        from ..errors import DoubleSpendError

        req.span.end(error="double_spend")
        req.future.set_exception(DoubleSpendError(digest, epoch, domain))
        if self.dead_letters is not None:
            try:
                self.dead_letters.append(
                    seq,
                    lane,
                    "double_spend",
                    trace_id=getattr(req.future, "trace_id", None),
                    program=self.name,
                    nullifier=digest,
                )
            except Exception:  # pragma: no cover - sink failure
                metrics.count("dead_letter_errors")

    def demux(self, requests, result, proofs, aux, seq, attempts, bspan):
        # NOTE: core._settle calls demux OUTSIDE its per-batch
        # containment — an exception escaping here would crash the
        # executor loop, so every durability failure is converted into
        # per-lane outcomes instead of being allowed to propagate.
        from ..errors import TransientBackendError

        digests = aux[3] if len(aux) > 3 else None
        null_epochs = aux[4] if len(aux) > 4 else None
        null_domains = aux[5] if len(aux) > 5 else None
        guard = self.nullifiers
        with otrace.span("demux", n=len(requests)):
            now = self.engine.clock()
            n = len(requests)
            bits = [bool(b) for b in list(result)[:n]]
            committed = commit_err = None
            if guard is not None and digests is not None:
                # authoritative check-and-set: accepted lanes re-check
                # the live set (and each other) under the store lock,
                # then ONE WAL group commit persists the batch's new
                # nullifiers BEFORE any future below resolves
                try:
                    committed = guard.commit(
                        digests[:n],
                        epochs=list(null_epochs[:n]),
                        accept=bits,
                        domains=list(null_domains[:n]),
                    )
                except Exception as e:
                    commit_err = e
                    metrics.count("nullifier_commit_errors")
            n_valid = 0
            for i, (req, ok) in enumerate(zip(requests, bits)):
                metrics.observe("showv_latency_s", now - req.t_submit)
                if guard is not None and digests is not None:
                    if ok and commit_err is not None:
                        # the WAL could not persist the acceptance —
                        # resolving True would acknowledge a fact a
                        # restart forgets. Fail the lane retryably.
                        req.span.end(error="nullifier_commit")
                        req.future.set_exception(
                            TransientBackendError(
                                "nullifier WAL commit failed: %s"
                                % (commit_err,)
                            )
                        )
                        continue
                    if ok and committed is not None and not committed[i]:
                        # lost the check-and-set: a concurrent batch
                        # (or an intra-batch duplicate) spent it first
                        self._reject_double_spend(
                            req, digests[i], null_epochs[i], seq, i,
                            domain=null_domains[i],
                        )
                        continue
                    if not ok and guard.seen(
                        digests[i], null_epochs[i], null_domains[i]
                    ):
                        # the fused probe masked the lane's verify bit:
                        # surface the TYPED rejection, not a bare False
                        metrics.count("nullifier_double_spends")
                        self._reject_double_spend(
                            req, digests[i], null_epochs[i], seq, i,
                            domain=null_domains[i],
                        )
                        continue
                n_valid += ok
                req.span.end(verdict=ok)
                req.future.set_result(ok)
            metrics.count("showv_valid", n_valid)
            metrics.count("showv_invalid", len(requests) - n_valid)
        bspan.end(result="demuxed")
