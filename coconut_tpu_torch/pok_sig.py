"""Proof of knowledge of a credential with selective disclosure — the
"Show" / "ShowVerify" step, the port's copy of `coconut_tpu/pok_sig.py`:

  show          one proof on the host spec (PoKOfSignature + Fiat-Shamir);
  batch_show    the same proofs for a batch, every group operation routed
                through a batched backend (TorchBackend): ONE distinct MSM
                for the re-randomized signatures (with GLV on G1) and ONE
                program of two shared-base comb MSMs for J and the Schnorr
                commitments, both enqueued before either is read back;
  show_verify   the spec verifier, recomputing the challenge when none is
                given.

The randomness is drawn by rand_fr in the reference's order (all r, all t,
then each credential's blindings), so one seeded sequence gives the same
proofs in both packages.
"""

from .errors import UnsupportedNoOfMessages
from .ops.fields import R
from .pok_vc import Proof
from .ps import (
    PoKOfSignature, PoKOfSignatureProof, challenge_bytes, device_backend, is_spec, show_bases,
)
from .signature import fiat_shamir_challenge
from .sss import rand_fr


def show(sig, vk, params, messages, revealed_msg_indices, blindings=None):
    """Prover side on the host spec: returns (proof, challenge,
    revealed_msgs), non-interactive by Fiat-Shamir over the transcript."""
    pok = PoKOfSignature(
        sig, vk, params, messages,
        blindings=blindings, revealed_msg_indices=revealed_msg_indices,
    )
    challenge = fiat_shamir_challenge(pok.to_bytes())
    proof = pok.gen_proof(challenge)
    revealed_msgs = {i: messages[i] for i in proof.revealed_msg_indices}
    return proof, challenge, revealed_msgs


def batch_show(sigs, vk, params, messages_list, revealed_msg_indices, backend=None):
    """Batched prover side of Show: the proofs `show` makes, one a
    credential, with the group operations on `backend` (TorchBackend's
    async MSM primitives; `None` is a TorchBackend on `cuda`, which raises
    without a card; a name goes through backend.get_backend, and `ps.SPEC`
    or a SpecBackend runs `show` credential by credential on the host). All
    credentials share one revealed-index set. Returns (proofs, challenges,
    revealed_msgs_list)."""
    backend = device_backend(backend)
    B = len(sigs)
    if len(messages_list) != B:
        raise ValueError(
            "batch size mismatch: %d sigs, %d message vectors" % (B, len(messages_list))
        )
    if is_spec(backend) or B == 0:
        out = [show(s, vk, params, m, revealed_msg_indices) for s, m in zip(sigs, messages_list)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]
    ctx = params.ctx
    revealed = set(revealed_msg_indices)
    q = len(vk.Y_tilde)
    for msgs in messages_list:
        if len(msgs) != q:
            raise UnsupportedNoOfMessages(q, len(msgs))
    for i in revealed:
        if not 0 <= i < q:
            raise ValueError("revealed index %d out of range" % i)
    sig_grp, other_grp = ("g1", "g2") if ctx.name == "G1" else ("g2", "g1")
    draw = prover_draw(B, q - len(revealed))
    sig_rows, sig_scal, jobs = msm_inputs(sigs, vk, params, messages_list, revealed, draw)
    # both programs are enqueued before either is read back, so the sigma
    # decode overlaps the comb program
    sig_handle = getattr(backend, "msm_%s_distinct_async" % sig_grp)(sig_rows, sig_scal)
    many_handle = getattr(backend, "msm_%s_shared_many_async" % other_grp)(jobs)
    sig_out = backend.msm_distinct_wait(sig_handle)
    Js, comms = backend.msm_shared_many_wait(many_handle)
    return finish_proofs(
        params, jobs[0][0], sig_out[:B], sig_out[B:], Js, comms, draw, messages_list, revealed
    )


def prover_draw(B, nhidden):
    """The prover's randomness for B credentials, in PoKOfSignature's
    order: every r, every t, then each credential's 1 + nhidden
    blindings."""
    rs = [rand_fr() for _ in range(B)]
    ts = [rand_fr() for _ in range(B)]
    blindings = [[rand_fr() for _ in range(1 + nhidden)] for _ in range(B)]
    return rs, ts, blindings


def msm_inputs(sigs, vk, params, messages_list, revealed, draw):
    """The prover's MSMs for a draw (rs, ts, blindings):

      - ONE distinct MSM over the signature group for the sigma pair,
        sigma'_1 = sigma_1^r and sigma'_2 = (sigma_2 + t sigma_1)^r =
        sigma_2^r + sigma_1^{t r}: the sigma'_1 rows pad to the sigma'_2
        width with an identity base and a zero scalar and stack to [2B, 2];
      - two shared-base jobs over [g_tilde, hidden Y_tilde]: J = g_tilde^t
        * prod_hidden Y_j^{m_j} and the Schnorr commitments.

    Returns (sigma rows, their scalars, the jobs [(bases, scalars)])."""
    rs, ts, blindings = draw
    hidden = [i for i in range(len(vk.Y_tilde)) if i not in revealed]
    bases = show_bases(vk, params, revealed)
    secrets_rows = [
        [t % R] + [msgs[i] % R for i in hidden] for t, msgs in zip(ts, messages_list)
    ]
    rows = [[s.sigma_1, None] for s in sigs] + [[s.sigma_2, s.sigma_1] for s in sigs]
    scal = [[r, 0] for r in rs] + [[r, t * r % R] for r, t in zip(rs, ts)]
    return rows, scal, [(bases, secrets_rows), (bases, blindings)]


def finish_proofs(params, bases, sigma1p, sigma2p, Js, comms, draw, messages_list, revealed):
    """Fiat-Shamir and the responses, on the host: each credential's
    challenge hashes sigma'_1 || sigma'_2 || J || bases || commitment, and
    response_k = blinding_k - c * secret_k mod r over secrets [t, hidden
    m_j]. Returns (proofs, challenges, revealed_msgs_list)."""
    ctx = params.ctx
    _, ts, blindings = draw
    hidden = [i for i in range(len(messages_list[0])) if i not in revealed]
    bases_bytes = b"".join(ctx.other_to_bytes(b) for b in bases)
    proofs, challenges, revealed_list = [], [], []
    for i, msgs in enumerate(messages_list):
        transcript = (
            ctx.sig_to_bytes(sigma1p[i])
            + ctx.sig_to_bytes(sigma2p[i])
            + ctx.other_to_bytes(Js[i])
            + bases_bytes
            + ctx.other_to_bytes(comms[i])
        )
        c = fiat_shamir_challenge(transcript)
        secrets_row = [ts[i]] + [msgs[j] for j in hidden]
        responses = [(b - c * s) % R for b, s in zip(blindings[i], secrets_row)]
        proofs.append(
            PoKOfSignatureProof(sigma1p[i], sigma2p[i], Js[i], Proof(comms[i], responses), revealed)
        )
        challenges.append(c)
        revealed_list.append({j: msgs[j] for j in revealed})
    return proofs, challenges, revealed_list


def show_verify(proof, vk, params, revealed_msgs, challenge=None):
    """Verifier side on the host spec. `challenge=None` recomputes the
    Fiat-Shamir challenge from the proof's transcript (the secure
    non-interactive path)."""
    if challenge is None:
        challenge = fiat_shamir_challenge(challenge_bytes(proof, vk, params))
    return proof.verify(vk, params, revealed_msgs, challenge)
