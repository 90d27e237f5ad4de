"""The Pointcheval-Sanders layer of the port — a copy of
`coconut_tpu/ps.py` over the port's host spec and its batched backend
(`TorchBackend`): the spec verifier `ps_verify`, the selective-disclosure
prover's commitment phase `PoKOfSignature` and its proof
`PoKOfSignatureProof` (wire and challenge encodings, spec `verify`), and
the batch checks `batch_verify` and `batch_show_verify`.

mode="exact" returns the backend's per-lane verdicts. mode="batched" runs the
random-linear-combination check: ONE combined pairing product with ONE
shared final exponentiation for the whole batch and, only on a rejection,
a bisection ladder that names the forged lanes. Each sub-batch draws fresh
combiners from its own transcript, and a lone lane is a leaf (its single
combiner is invertible mod R, so the combined check of one lane is that
lane's exact check). All-valid batches give the exact mode's bits.

Where both halves of a rejected range pass (a <= 2^-lambda collision of
the parent draw), the reference settles the range with the spec's
`ps_verify` / `proof.verify`; the port settles it with the backend's exact
path over that range (`batch_verify` / `batch_show_verify`). The bits are
equal.

`batch_show_verify` recomputes the Fiat-Shamir challenges when none are
given. A batch whose proofs share one revealed-index set goes to the
backend; one that mixes sets (ragged) is verified proof by proof with the
spec, as the reference does, and counted in COUNTS
("show_verify_ragged_fallback": ragged batches a backend was given for,
"show_verify_ragged_proofs": their proofs). `backend=None` is a
TorchBackend on `cuda` (it raises without a card); a name ("torch",
"spec", "python") goes through backend.get_backend, and the sequential
host spec path is asked for by name, `backend="spec"`, or a SpecBackend.

The refusals the reference raises as `PSError` (batch-size mismatches, an
unknown mode, revealed messages that do not match a proof, batched mode
on the spec path) raise the port's `errors.PSError`, of the same name and
code. `PoKOfSignatureProof.from_bytes` decodes a proof as strictly as the
reference: its length, canonical field elements, points in the subgroup,
no duplicate revealed index.
"""

import collections

from .backend import SpecBackend, get_backend
from .errors import DeserializationError, PSError, UnsupportedNoOfMessages
from .gpu.backend import TorchBackend
from .ops import serialize as ser
from .pok_vc import Proof, ProverCommitting
from .signature import fiat_shamir_challenge
from .sss import rand_fr

MODES = ("exact", "batched")

# The backend name that asks for the sequential host spec path (SpecBackend;
# "python" is its alias).
SPEC = "spec"

# The reference's metrics of the ragged fallback, as counts the caller can
# read and reset.
COUNTS = collections.Counter()


def _check_mode(mode):
    if mode not in MODES:
        raise PSError("unknown verify mode %r" % (mode,))


def prepare_verify_statement(messages, vk, params):
    """The other-group accumulator X_tilde * prod Y_tilde_j^{m_j}."""
    if len(messages) != len(vk.Y_tilde):
        raise UnsupportedNoOfMessages(len(vk.Y_tilde), len(messages))
    ops = params.ctx.other
    return ops.add(vk.X_tilde, ops.msm(vk.Y_tilde, list(messages)))


def ps_verify(sig, messages, vk, params):
    """PS verification on the host spec: e(sigma_1, X_tilde * prod
    Y_tilde_j^{m_j}) == e(sigma_2, g_tilde), refusing sigma_1 == identity."""
    if sig.sigma_1 is None:
        return False
    acc = prepare_verify_statement(messages, vk, params)
    ctx = params.ctx
    return ctx.pairing_check(
        [(sig.sigma_1, acc), (ctx.sig.neg(sig.sigma_2), params.g_tilde)]
    )


def device_backend(backend):
    """The backend an entry point runs on: a TorchBackend on the default
    device (`cuda`; raises without a card) when none is given, a registry
    name ("torch", "spec", "python") resolved by backend.get_backend, else
    the caller's backend object."""
    if backend is None:
        return TorchBackend()
    if isinstance(backend, str):
        return get_backend(backend)
    return backend


def is_spec(backend):
    """Whether `backend` asks for the sequential host spec path."""
    return isinstance(backend, SpecBackend)


def batch_verify(sigs, messages_list, vk, params, backend, mode="exact", epoch=None):
    """One bool per credential of a batch under one verkey. `backend` is a
    backend object or a registry name, and required: unlike the reference,
    whose `backend=None` is its sequential spec path, the port's None would
    be a TorchBackend on `cuda` (ask for the spec by name, "spec"). `epoch`
    (the key epoch) joins the combiners' domain separation in batched
    mode."""
    if len(sigs) != len(messages_list):
        raise PSError(
            "batch size mismatch: %d sigs, %d message vectors"
            % (len(sigs), len(messages_list))
        )
    _check_mode(mode)
    backend = device_backend(backend)
    if mode == "exact":
        return backend.batch_verify(sigs, messages_list, vk, params)

    def combined(lo, hi):
        return backend.batch_verify_combined(
            sigs[lo:hi], messages_list[lo:hi], vk, params, epoch=epoch
        )

    def exact(lo, hi):
        return backend.batch_verify(sigs[lo:hi], messages_list[lo:hi], vk, params)

    B = len(sigs)
    bits = [True] * B
    if B == 0 or combined(0, B):
        return bits
    _bisect(combined, exact, bits, 0, B)
    return bits


def _bisect(combined, exact, bits, lo, hi):
    """The ladder under a rejected range [lo, hi): halves checked with fresh
    combiners, a lone lane a leaf, and a range whose halves both pass
    settled by the exact path. `combined(lo, hi)` returns the range's
    pairing bool; `bits` is set to False at each culprit."""
    if hi - lo == 1:
        bits[lo] = False
        return
    mid = (lo + hi) // 2
    left_ok = combined(lo, mid)
    right_ok = combined(mid, hi)
    if left_ok and right_ok:
        bits[lo:hi] = exact(lo, hi)
        return
    if not left_ok:
        _bisect(combined, exact, bits, lo, mid)
    if not right_ok:
        _bisect(combined, exact, bits, mid, hi)


def challenge_bytes(proof, vk, params):
    """The prover's Fiat-Shamir transcript rebuilt from a shown credential:
    sigma'_1 || sigma'_2 || J || the Schnorr bases || t. Reads the proof by
    its fields, so the JAX package's objects give the same bytes."""
    sig_enc, other = ser._encoders(params.ctx)
    bases = show_bases(vk, params, proof.revealed_msg_indices)
    return (
        sig_enc(proof.sigma_prime_1)
        + sig_enc(proof.sigma_prime_2)
        + other(proof.J)
        + proof.proof_vc.to_bytes_with_bases(other, bases)
    )


def show_bases(vk, params, revealed):
    """The Schnorr bases of a show: [g_tilde, Y_tilde_j for the hidden j]."""
    return [params.g_tilde] + [
        y for i, y in enumerate(vk.Y_tilde) if i not in revealed
    ]


def batch_show_verify(
    proofs, vk, params, revealed_msgs_list, challenges=None, backend=None,
    mode="exact", epoch=None,
):
    """One bool per shown credential (BASELINE config 3). challenges=None
    recomputes each Fiat-Shamir challenge from its proof's transcript (the
    secure non-interactive path). A batch sharing one revealed-index set
    runs on the backend (`None`: a TorchBackend on `cuda`); a ragged batch,
    or `backend=SPEC`, runs the spec verifier proof by proof on the host.

    In batched mode the Schnorr check stays per lane and the B pairing
    checks fold into one combined product; a lane's verdict is its Schnorr
    bit and its pairing bit. Dead lanes (identity sigma') fail through their
    Schnorr bit and never enter the fold or the ladder."""
    backend = device_backend(backend)
    if len(proofs) != len(revealed_msgs_list):
        raise PSError(
            "batch size mismatch: %d proofs, %d revealed maps"
            % (len(proofs), len(revealed_msgs_list))
        )
    _check_mode(mode)
    if challenges is None:
        challenges = [
            fiat_shamir_challenge(challenge_bytes(p, vk, params)) for p in proofs
        ]
    elif len(challenges) != len(proofs):
        raise PSError(
            "batch size mismatch: %d proofs, %d challenges"
            % (len(proofs), len(challenges))
        )
    for p, rm in zip(proofs, revealed_msgs_list):
        if set(rm.keys()) != p.revealed_msg_indices:
            raise PSError("revealed messages do not match proof's indices")
    uniform = bool(proofs) and all(
        p.revealed_msg_indices == proofs[0].revealed_msg_indices for p in proofs
    )
    spec = is_spec(backend)
    if mode == "batched" and spec:
        raise PSError("mode='batched' requires a backend")
    if not spec and uniform:
        if mode == "batched":
            return _combined_show_bits(
                proofs, vk, params, revealed_msgs_list, challenges, backend, epoch
            )
        return backend.batch_show_verify(
            proofs, vk, params, revealed_msgs_list, challenges
        )
    if not spec:
        COUNTS["show_verify_ragged_fallback"] += 1
        COUNTS["show_verify_ragged_proofs"] += len(proofs)
    return [
        p.verify(vk, params, rm, c)
        for p, rm, c in zip(proofs, revealed_msgs_list, challenges)
    ]


def _combined_show_bits(proofs, vk, params, revealed_msgs_list, challenges, backend, epoch):
    """Batched-mode show verdicts of a uniform, non-empty batch."""

    def combined(lo, hi):
        return backend.batch_show_verify_combined(
            proofs[lo:hi], vk, params, revealed_msgs_list[lo:hi],
            challenges[lo:hi], epoch=epoch,
        )[1]

    def exact(lo, hi):
        # the full exact verdicts; the Schnorr half is known, so they
        # settle the pairing half
        return backend.batch_show_verify(
            proofs[lo:hi], vk, params, revealed_msgs_list[lo:hi], challenges[lo:hi]
        )

    B = len(proofs)
    schnorr, pair_ok = backend.batch_show_verify_combined(
        proofs, vk, params, revealed_msgs_list, challenges, epoch=epoch
    )
    pair_bits = [True] * B
    if not pair_ok:
        _bisect(combined, exact, pair_bits, 0, B)
    return [bool(s) and bool(p) for s, p in zip(schnorr, pair_bits)]


class PoKOfSignature:
    """Commitment phase of the selective-disclosure proof ("Show"):
    re-randomizes the credential, sigma'_1 = sigma_1^r and sigma'_2 =
    (sigma_2 * sigma_1^t)^r, and commits to t and the hidden messages in
    J = g_tilde^t * prod_{hidden j} Y_tilde_j^{m_j}. Draws r, t, then one
    blinding a Schnorr base (those not supplied), by rand_fr."""

    def __init__(self, sig, vk, params, messages, blindings=None,
                 revealed_msg_indices=None):
        revealed = set(revealed_msg_indices or ())
        if len(messages) != len(vk.Y_tilde):
            raise UnsupportedNoOfMessages(len(vk.Y_tilde), len(messages))
        for i in revealed:
            if not 0 <= i < len(messages):
                raise PSError("revealed index %d out of range" % i)
        hidden = [i for i in range(len(messages)) if i not in revealed]
        if blindings is not None and len(blindings) != len(hidden):
            raise PSError(
                "need %d blindings for hidden messages, got %d"
                % (len(hidden), len(blindings))
            )
        ctx = params.ctx
        r = rand_fr()
        t = rand_fr()
        self.sigma_prime_1 = ctx.sig.mul(sig.sigma_1, r)
        self.sigma_prime_2 = ctx.sig.mul(
            ctx.sig.add(sig.sigma_2, ctx.sig.mul(sig.sigma_1, t)), r
        )
        bases = show_bases(vk, params, revealed)
        secrets = [t] + [messages[i] for i in hidden]
        committing = ProverCommitting(ctx.other, ctx.other_to_bytes)
        committing.commit(params.g_tilde, None)
        for k, i in enumerate(hidden):
            committing.commit(vk.Y_tilde[i], None if blindings is None else blindings[k])
        self.J = ctx.other.msm(bases, secrets)
        self._committed = committing.finish()
        self._secrets = secrets
        self._ctx = ctx
        self.revealed_msg_indices = revealed

    def to_bytes(self):
        """The Fiat-Shamir transcript (the challenge's input)."""
        ctx = self._ctx
        return (
            ctx.sig_to_bytes(self.sigma_prime_1)
            + ctx.sig_to_bytes(self.sigma_prime_2)
            + ctx.other_to_bytes(self.J)
            + self._committed.to_bytes()
        )

    def gen_proof(self, challenge):
        proof_vc = self._committed.gen_proof(challenge, self._secrets)
        return PoKOfSignatureProof(
            self.sigma_prime_1, self.sigma_prime_2, self.J, proof_vc,
            self.revealed_msg_indices,
        )


class PoKOfSignatureProof:
    """A shown credential: the re-randomized signature (sigma'_1,
    sigma'_2), J, the Schnorr proof of its opening (`pok_vc.Proof`) and the
    set of revealed message indices."""

    def __init__(self, sigma_prime_1, sigma_prime_2, J, proof_vc,
                 revealed_msg_indices):
        self.sigma_prime_1 = sigma_prime_1
        self.sigma_prime_2 = sigma_prime_2
        self.J = J
        self.proof_vc = proof_vc
        self.revealed_msg_indices = set(revealed_msg_indices)

    def _bases(self, vk, params):
        return show_bases(vk, params, self.revealed_msg_indices)

    def to_bytes(self, ctx):
        """Canonical wire encoding (prover -> verifier)."""
        return ser.show_proof_to_bytes(self, ctx)

    @classmethod
    def from_bytes(cls, b, ctx):
        n = ctx.sig_nbytes
        if len(b) < 2 * n + ctx.other_nbytes:
            raise DeserializationError("malformed PoKOfSignatureProof")
        s1 = ctx.sig_from_bytes(b[:n])
        s2 = ctx.sig_from_bytes(b[n : 2 * n])
        o = 2 * n
        J = ctx.other_from_bytes(b[o : o + ctx.other_nbytes])
        o += ctx.other_nbytes
        proof_vc, o = Proof.read_from(b, o, ctx.other_from_bytes, ctx.other_nbytes)
        if len(b) < o + 4:
            raise DeserializationError("malformed PoKOfSignatureProof")
        k = int.from_bytes(b[o : o + 4], "big")
        o += 4
        if len(b) != o + 4 * k:
            raise DeserializationError("malformed PoKOfSignatureProof")
        revealed = {int.from_bytes(b[o + 4 * i : o + 4 * (i + 1)], "big") for i in range(k)}
        if len(revealed) != k:
            raise DeserializationError("duplicate revealed indices")
        return cls(s1, s2, J, proof_vc, revealed)

    def to_bytes_for_challenge(self, vk, params):
        """The prover's transcript bytes, so a Fiat-Shamir verifier
        recomputes the challenge rather than trusting it."""
        return challenge_bytes(self, vk, params)

    def verify(self, vk, params, revealed_msgs, challenge):
        """The Schnorr relation on J, then the pairing
        e(sigma'_1, J * X_tilde * prod_{revealed} Y_tilde_i^{m_i}) ==
        e(sigma'_2, g_tilde), on the host spec."""
        ctx = params.ctx
        if self.sigma_prime_1 is None:
            return False
        if set(revealed_msgs.keys()) != self.revealed_msg_indices:
            raise PSError("revealed messages do not match proof's indices")
        if not self.proof_vc.verify(ctx.other, self._bases(vk, params), self.J, challenge):
            return False
        acc = ctx.other.add(self.J, vk.X_tilde)
        if revealed_msgs:
            idxs = sorted(revealed_msgs)
            acc = ctx.other.add(
                acc,
                ctx.other.msm(
                    [vk.Y_tilde[i] for i in idxs], [revealed_msgs[i] for i in idxs]
                ),
            )
        return ctx.pairing_check(
            [(self.sigma_prime_1, acc), (ctx.sig.neg(self.sigma_prime_2), params.g_tilde)]
        )
