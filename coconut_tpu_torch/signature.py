"""The Coconut issuance protocol and the credential holders — the port's
copy of the parts of `coconut_tpu/signature.py` that threshold issuance
(BASELINE config 4) runs:

  holders         Sigkey, Verkey (with the Lagrange-weighted
                  `Verkey.aggregate`), Signature (with
                  `Signature.aggregate` and the spec `verify`),
                  SignatureRequest (prepare: the commitment, the ElGamal
                  ciphertexts of h^{m_i} and the known messages; `get_h` /
                  `compute_h` hash the request to its generator h) and
                  BlindSignature (blind-sign and `unblind`), all on the
                  host spec;
  request proof   SignatureRequestPoK / SignatureRequestProof: the Schnorr
                  proof of knowledge a user attaches to a request (the
                  ElGamal secret, the commitment's opening, each
                  ciphertext, with shared blindings), its Fiat-Shamir
                  transcript bound to the statement (`_statement_bytes`),
                  `verify`, and the wire encoding. Computed on the host
                  spec, request by request, as the reference does;
  batch functions batch_prepare_blind_sign, batch_blind_sign,
                  batch_unblind and batch_aggregate: the same outputs for a
                  batch, every group operation through a batched backend
                  (TorchBackend's MSM programs, its device hash-to-G1 and
                  its plus-offset program). Prepare takes one ElGamal
                  public key or one a request, unblind one secret or one a
                  blind signature.

`backend=None` in a batch function is a TorchBackend on `cuda` (it raises
without a card); a registry name goes through `backend.get_backend`, so
`backend=ps.SPEC` ("spec", alias "python") runs the sequential host spec
(`backend.SpecBackend`) and "torch" a TorchBackend on `cuda`. Draws come
from `rand_fr` in the reference's order, so one seeded sequence gives
byte-equal requests and proofs in both packages. Where the backend has no
device hash, prepare hashes each request's generator with the native
core's `native.hash_to_g1_batch` when the library builds, else with the
spec, as the reference does.
"""

from . import native
from .backend import (
    async_distinct_api, async_distinct_plus_offset_api, async_shared_many_api,
)
from .elgamal import elgamal_encrypt
from .errors import (
    DeserializationError, GeneralError, UnequalNoOfBasesExponents,
    UnsupportedNoOfMessages,
)
from .ops import serialize as ser
from .ops.fields import R
from .ops.hashing import hash_to_fr
from .pok_vc import Proof, ProverCommitting
from .sss import lagrange_basis_at_0, rand_fr


def fiat_shamir_challenge(transcript_bytes):
    """Hash a proof-of-knowledge transcript to Fr."""
    return hash_to_fr(transcript_bytes)


def _default_ctx(ctx):
    from .params import DEFAULT_CTX  # params imports this module

    return ctx or DEFAULT_CTX


def _batch_backend(backend):
    """The backend a batch function runs on: `None` is a TorchBackend on
    `cuda`, a registry name ("torch", "spec" = ps.SPEC, "python") its
    backend.get_backend instance, anything else the caller's backend."""
    from . import ps  # ps imports this module

    return ps.device_backend(backend)


def _validate_share_ids(pairs, threshold):
    """The (signer_id, value) subset an aggregation interpolates over must
    hold `threshold` distinct, positive integer ids; raises GeneralError
    naming the offending ids. Returns the id set."""
    ids = [i for i, _ in pairs]
    bad = sorted({i for i in ids if not isinstance(i, int) or i < 1})
    if bad:
        raise GeneralError(
            "out-of-range signer ids in aggregation set: %r "
            "(share indices are 1-based positive integers)" % (bad,)
        )
    seen, dup = set(), set()
    for i in ids:
        if i in seen:
            dup.add(i)
        seen.add(i)
    if dup:
        raise GeneralError(
            "duplicate signer ids in aggregation set: %r "
            "(a repeated id would skew its Lagrange weight)" % (sorted(dup),)
        )
    if len(seen) != threshold:
        raise GeneralError(
            "aggregation subset holds %d distinct signer ids, need %d"
            % (len(seen), threshold)
        )
    return seen


def _shared_sigma_1(use):
    """The sigma_1 (= h) every partial signature of a subset shares."""
    sigma_1 = use[0][1].sigma_1
    for _, s in use[1:]:
        if s.sigma_1 != sigma_1:
            raise GeneralError(
                "partial signatures disagree on sigma_1 (different requests?)"
            )
    return sigma_1


class Sigkey:
    """Signer secret key: x, y_1..y_q."""

    def __init__(self, x, y):
        self.x = x
        self.y = list(y)


class Verkey:
    """Verification key: X_tilde, Y_tilde_1..q in OtherGroup."""

    def __init__(self, X_tilde, Y_tilde):
        self.X_tilde = X_tilde
        self.Y_tilde = list(Y_tilde)

    @staticmethod
    def aggregate(threshold, keys, ctx=None):
        """Lagrange-weighted aggregation over the first `threshold` of the
        (signer_id, Verkey) pairs, any subset of the signers."""
        ctx = _default_ctx(ctx)
        if len(keys) < threshold:
            raise GeneralError("need at least %d verkeys, got %d" % (threshold, len(keys)))
        q = len(keys[0][1].Y_tilde)
        for _, vk in keys[1:]:
            if len(vk.Y_tilde) != q:
                raise UnsupportedNoOfMessages(q, len(vk.Y_tilde))
        use = keys[:threshold]
        ids = _validate_share_ids(use, threshold)
        weights = [lagrange_basis_at_0(ids, i) for i, _ in use]
        ops = ctx.other
        X_tilde = ops.msm([vk.X_tilde for _, vk in use], weights)
        Y_tilde = [ops.msm([vk.Y_tilde[j] for _, vk in use], weights) for j in range(q)]
        return Verkey(X_tilde, Y_tilde)

    def to_bytes(self, ctx):
        return ser.verkey_to_bytes(self, ctx)

    @classmethod
    def from_bytes(cls, b, ctx):
        n = ctx.other_nbytes
        if len(b) < 2 * n or len(b) % n:
            raise DeserializationError("malformed Verkey encoding")
        parts = [ctx.other_from_bytes(b[o : o + n]) for o in range(0, len(b), n)]
        return cls(parts[0], parts[1:])

    def __eq__(self, other):
        return (
            isinstance(other, Verkey)
            and self.X_tilde == other.X_tilde
            and self.Y_tilde == other.Y_tilde
        )


class Signature:
    """PS signature (sigma_1, sigma_2); None is the point at infinity."""

    def __init__(self, sigma_1, sigma_2):
        self.sigma_1 = sigma_1
        self.sigma_2 = sigma_2

    @staticmethod
    def aggregate(threshold, sigs, ctx=None):
        """Lagrange interpolation in the exponent over the first `threshold`
        of the (signer_id, Signature) pairs; all share sigma_1 = h."""
        ctx = _default_ctx(ctx)
        if len(sigs) < threshold:
            raise GeneralError("need at least %d signatures, got %d" % (threshold, len(sigs)))
        use = sigs[:threshold]
        ids = _validate_share_ids(use, threshold)
        sigma_1 = _shared_sigma_1(use)
        bases = [s.sigma_2 for _, s in use]
        exps = [lagrange_basis_at_0(ids, i) for i, _ in use]
        return Signature(sigma_1, ctx.sig.msm(bases, exps))

    def verify(self, messages, vk, params):
        """Verify a per-signer or aggregated credential on the host spec
        (`ps.ps_verify`)."""
        from .ps import ps_verify  # ps imports this module

        return ps_verify(self, messages, vk, params)

    def to_bytes(self, ctx):
        return ser.signature_to_bytes(self, ctx)

    @classmethod
    def from_bytes(cls, b, ctx):
        n = ctx.sig_nbytes
        if len(b) != 2 * n:
            raise DeserializationError("malformed Signature encoding")
        return cls(ctx.sig_from_bytes(b[:n]), ctx.sig_from_bytes(b[n:]))

    def __eq__(self, other):
        return (
            isinstance(other, Signature)
            and self.sigma_1 == other.sigma_1
            and self.sigma_2 == other.sigma_2
        )


class SignatureRequest:
    """User-side PrepareBlindSign output: the commitment to the hidden
    messages, the ElGamal ciphertexts of h^{m_i} and the known (revealed to
    the signer) messages."""

    def __init__(self, known_messages, commitment, ciphertexts):
        self.known_messages = list(known_messages)
        self.commitment = commitment
        self.ciphertexts = list(ciphertexts)
        self._h_cache = None

    def get_h(self, ctx):
        """The request's generator h, computed once and cached."""
        if self._h_cache is None:
            self._h_cache = self.compute_h(self.commitment, self.known_messages, ctx)
        return self._h_cache

    @classmethod
    def new(cls, messages, count_hidden, elgamal_pk, params):
        """One request on the host spec: (request, randomness [r, k_1..
        k_hidden]). Draws r, then one k a hidden message."""
        if len(messages) < count_hidden:
            raise GeneralError(
                "count_hidden %d exceeds message count %d" % (count_hidden, len(messages))
            )
        if len(messages) != params.msg_count():
            raise UnsupportedNoOfMessages(params.msg_count(), len(messages))
        ops = params.ctx.sig
        bases = list(params.h[:count_hidden]) + [params.g]
        r = rand_fr()
        commitment = ops.msm(bases, list(messages[:count_hidden]) + [r])
        randomness = [r]
        known_messages = list(messages[count_hidden:])
        ciphertexts = []
        h = None
        if count_hidden > 0:
            h = cls.compute_h(commitment, known_messages, params.ctx)
            for m in messages[:count_hidden]:
                c1, c2, k = elgamal_encrypt(ops, params.g, elgamal_pk, ops.mul(h, m))
                randomness.append(k)
                ciphertexts.append((c1, c2))
        req = cls(known_messages, commitment, ciphertexts)
        req._h_cache = h
        return req, randomness

    @staticmethod
    def hash_input(commitment, known_messages, ctx):
        """The bytes hashed to h: the commitment || the known messages."""
        return ctx.sig_to_bytes(commitment) + b"".join(
            ser.fr_to_bytes(m) for m in known_messages
        )

    @classmethod
    def compute_h(cls, commitment, known_messages, ctx):
        """The anti-malleability generator h = Hash2Group(commitment ||
        known messages), on the host spec."""
        return ctx.hash_to_sig(cls.hash_input(commitment, known_messages, ctx))

    def to_bytes(self, ctx):
        out = [
            len(self.known_messages).to_bytes(4, "big"),
            len(self.ciphertexts).to_bytes(4, "big"),
        ]
        out.extend(ser.fr_to_bytes(m) for m in self.known_messages)
        out.append(ctx.sig_to_bytes(self.commitment))
        for c1, c2 in self.ciphertexts:
            out.append(ctx.sig_to_bytes(c1))
            out.append(ctx.sig_to_bytes(c2))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, b, ctx):
        if len(b) < 8:
            raise DeserializationError("malformed SignatureRequest encoding")
        n_known = int.from_bytes(b[:4], "big")
        n_ct = int.from_bytes(b[4:8], "big")
        n = ctx.sig_nbytes
        if len(b) != 8 + 32 * n_known + n + 2 * n * n_ct:
            raise DeserializationError("malformed SignatureRequest encoding")
        o = 8
        known = []
        for _ in range(n_known):
            known.append(ser.fr_from_bytes(b[o : o + 32]))
            o += 32
        commitment = ctx.sig_from_bytes(b[o : o + n])
        o += n
        cts = []
        for _ in range(n_ct):
            cts.append((ctx.sig_from_bytes(b[o : o + n]), ctx.sig_from_bytes(b[o + n : o + 2 * n])))
            o += 2 * n
        return cls(known, commitment, cts)


def _statement_bytes(sig_req, elgamal_pk, ctx):
    """The statement the request proof's Fiat-Shamir transcript binds: the
    full request (commitment, known messages, ciphertexts) and the ElGamal
    public key."""
    return sig_req.to_bytes(ctx) + ctx.sig_to_bytes(elgamal_pk)


class SignatureRequestPoK:
    """Commitment phase of the request proof: one Schnorr sub-proof for the
    ElGamal secret, one for the commitment's opening and two a ciphertext,
    each hidden message's blinding shared between the commitment and its
    ciphertext."""

    def __init__(self, pok_vc_elgamal_sk, pok_vc_commitment, pok_vc_ciphertext, statement):
        self.pok_vc_elgamal_sk = pok_vc_elgamal_sk
        self.pok_vc_commitment = pok_vc_commitment
        self.pok_vc_ciphertext = list(pok_vc_ciphertext)
        self.statement = statement

    @classmethod
    def init(cls, sig_req, elgamal_pk, params):
        """Draw the blindings (the ElGamal secret's, one a hidden message,
        the commitment randomness', then each ciphertext's k twice) and
        commit, on the host spec."""
        ctx = params.ctx
        ops = ctx.sig
        statement = _statement_bytes(sig_req, elgamal_pk, ctx)
        if len(sig_req.known_messages) + len(sig_req.ciphertexts) != len(params.h):
            raise UnsupportedNoOfMessages(
                len(params.h), len(sig_req.known_messages) + len(sig_req.ciphertexts)
            )
        committing_sk = ProverCommitting(ops, ctx.sig_to_bytes)
        committing_sk.commit(params.g, None)
        committed_sk = committing_sk.finish()
        committing_comm = ProverCommitting(ops, ctx.sig_to_bytes)
        hidden_msg_blindings = []
        for h_i in params.h[: len(sig_req.ciphertexts)]:
            b = rand_fr()
            committing_comm.commit(h_i, b)
            hidden_msg_blindings.append(b)
        committing_comm.commit(params.g, None)
        committed_comm = committing_comm.finish()
        ciphertext_commts = []
        if sig_req.ciphertexts:
            h = sig_req.get_h(ctx)
            for i in range(len(sig_req.ciphertexts)):
                committing_1 = ProverCommitting(ops, ctx.sig_to_bytes)
                committing_1.commit(params.g, None)
                committing_2 = ProverCommitting(ops, ctx.sig_to_bytes)
                committing_2.commit(elgamal_pk, None)
                committing_2.commit(h, hidden_msg_blindings[i])
                ciphertext_commts.append((committing_1.finish(), committing_2.finish()))
        return cls(committed_sk, committed_comm, ciphertext_commts, statement)

    def to_bytes(self):
        """Fiat-Shamir transcript bytes: the statement, then each
        sub-proof's bases and commitment."""
        out = [self.statement, self.pok_vc_elgamal_sk.to_bytes(), self.pok_vc_commitment.to_bytes()]
        for p1, p2 in self.pok_vc_ciphertext:
            out.append(p1.to_bytes())
            out.append(p2.to_bytes())
        return b"".join(out)

    def gen_proof(self, hidden_messages, randomness, elgamal_sk, challenge):
        """Response phase. `randomness` is what SignatureRequest.new (or
        batch_prepare_blind_sign) returned: [r, k_1..k_hidden]."""
        if len(self.pok_vc_ciphertext) != len(hidden_messages):
            raise UnequalNoOfBasesExponents(len(self.pok_vc_ciphertext), len(hidden_messages))
        if len(randomness) != len(self.pok_vc_ciphertext) + 1:
            raise UnequalNoOfBasesExponents(len(self.pok_vc_ciphertext) + 1, len(randomness))
        proof_elgamal_sk = self.pok_vc_elgamal_sk.gen_proof(challenge, [elgamal_sk])
        proof_commitment = self.pok_vc_commitment.gen_proof(
            challenge, list(hidden_messages) + [randomness[0]]
        )
        proof_ciphertexts = []
        for i, (p1, p2) in enumerate(self.pok_vc_ciphertext):
            proof_1 = p1.gen_proof(challenge, [randomness[i + 1]])
            proof_2 = p2.gen_proof(challenge, [randomness[i + 1], hidden_messages[i]])
            proof_ciphertexts.append((proof_1, proof_2))
        return SignatureRequestProof(proof_elgamal_sk, proof_commitment, proof_ciphertexts)


class SignatureRequestProof:
    """Response phase of the request proof: what a signer checks before
    blind-signing a request."""

    def __init__(self, proof_elgamal_sk, proof_commitment, proof_ciphertexts):
        self.proof_elgamal_sk = proof_elgamal_sk
        self.proof_commitment = proof_commitment
        self.proof_ciphertexts = list(proof_ciphertexts)

    def verify(self, sig_req, elgamal_pk, challenge, params):
        """Each Schnorr relation, and each hidden message's response equal
        in the commitment's and its ciphertext's sub-proofs. The input is
        the user's: every malformed shape is a clean False."""
        ctx = params.ctx
        ops = ctx.sig
        if len(self.proof_ciphertexts) != len(sig_req.ciphertexts):
            return False
        if len(self.proof_commitment.responses) != len(self.proof_ciphertexts) + 1:
            return False
        if len(self.proof_elgamal_sk.responses) != 1:
            return False
        if not self.proof_elgamal_sk.verify(ops, [params.g], elgamal_pk, challenge):
            return False
        bases = list(params.h[: len(sig_req.ciphertexts)]) + [params.g]
        if not self.proof_commitment.verify(ops, bases, sig_req.commitment, challenge):
            return False
        h = sig_req.get_h(ctx)
        ct_bases = [elgamal_pk, h]
        for i, (proof_1, proof_2) in enumerate(self.proof_ciphertexts):
            if len(proof_1.responses) != 1 or len(proof_2.responses) != 2:
                return False
            if proof_2.responses[1] != self.proof_commitment.responses[i]:
                return False
            if not proof_1.verify(ops, [params.g], sig_req.ciphertexts[i][0], challenge):
                return False
            if not proof_2.verify(ops, ct_bases, sig_req.ciphertexts[i][1], challenge):
                return False
        return True

    def to_bytes(self, ctx):
        """Wire encoding: the secret's and the commitment's proofs, the
        ciphertext count (4 bytes), then each ciphertext's two proofs."""
        out = [
            self.proof_elgamal_sk.to_bytes(ctx.sig_to_bytes),
            self.proof_commitment.to_bytes(ctx.sig_to_bytes),
            len(self.proof_ciphertexts).to_bytes(4, "big"),
        ]
        for p1, p2 in self.proof_ciphertexts:
            out.append(p1.to_bytes(ctx.sig_to_bytes))
            out.append(p2.to_bytes(ctx.sig_to_bytes))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, b, ctx):
        p_sk, o = Proof.read_from(b, 0, ctx.sig_from_bytes, ctx.sig_nbytes)
        p_comm, o = Proof.read_from(b, o, ctx.sig_from_bytes, ctx.sig_nbytes)
        if len(b) < o + 4:
            raise DeserializationError("malformed SignatureRequestProof")
        n_ct = int.from_bytes(b[o : o + 4], "big")
        o += 4
        cts = []
        for _ in range(n_ct):
            p1, o = Proof.read_from(b, o, ctx.sig_from_bytes, ctx.sig_nbytes)
            p2, o = Proof.read_from(b, o, ctx.sig_from_bytes, ctx.sig_nbytes)
            cts.append((p1, p2))
        if o != len(b):
            raise DeserializationError("trailing bytes in SignatureRequestProof")
        return cls(p_sk, p_comm, cts)

    def to_bytes_for_challenge(self, sig_req, elgamal_pk, params):
        """The prover's transcript bytes (SignatureRequestPoK.to_bytes),
        rebuilt from the proof, so a verifier recomputes the challenge."""
        ctx = params.ctx
        out = [
            _statement_bytes(sig_req, elgamal_pk, ctx),
            self.proof_elgamal_sk.to_bytes_with_bases(ctx.sig_to_bytes, [params.g]),
            self.proof_commitment.to_bytes_with_bases(
                ctx.sig_to_bytes, list(params.h[: len(sig_req.ciphertexts)]) + [params.g]
            ),
        ]
        if self.proof_ciphertexts:
            h = sig_req.get_h(ctx)
            for p1, p2 in self.proof_ciphertexts:
                out.append(p1.to_bytes_with_bases(ctx.sig_to_bytes, [params.g]))
                out.append(p2.to_bytes_with_bases(ctx.sig_to_bytes, [elgamal_pk, h]))
        return b"".join(out)


class BlindSignature:
    """Signer-side BlindSign and user-side Unblind. The signer does not
    re-verify the request's proof of knowledge here: callers check it
    first."""

    def __init__(self, h, blinded):
        self.h = h
        self.blinded = blinded

    @classmethod
    def new(cls, sig_request, sigkey, params):
        """c_tilde_1 = prod a_i^{y_i}, c_tilde_2 = prod b_i^{y_i} * h^{x +
        sum_j y_j m_j}, on the host spec."""
        hidden_count = len(sig_request.ciphertexts)
        if hidden_count + len(sig_request.known_messages) != len(sigkey.y):
            raise UnsupportedNoOfMessages(
                len(sigkey.y), hidden_count + len(sig_request.known_messages)
            )
        ctx = params.ctx
        h = sig_request.get_h(ctx)
        c1_bases = [a for a, _ in sig_request.ciphertexts]
        c2_bases = [b for _, b in sig_request.ciphertexts] + [h]
        exps = list(sigkey.y[:hidden_count])
        c2_exps = exps + [_blind_exponent(sigkey, hidden_count, sig_request.known_messages)]
        return cls(h, (ctx.sig.msm(c1_bases, exps), ctx.sig.msm(c2_bases, c2_exps)))

    def unblind(self, elgamal_sk, ctx):
        """sigma_2 = c_tilde_2 - c_tilde_1^sk."""
        ops = ctx.sig
        return Signature(self.h, ops.sub(self.blinded[1], ops.mul(self.blinded[0], elgamal_sk)))

    def to_bytes(self, ctx):
        return (
            ctx.sig_to_bytes(self.h)
            + ctx.sig_to_bytes(self.blinded[0])
            + ctx.sig_to_bytes(self.blinded[1])
        )

    @classmethod
    def from_bytes(cls, b, ctx):
        n = ctx.sig_nbytes
        if len(b) != 3 * n:
            raise DeserializationError("malformed BlindSignature encoding")
        return cls(
            ctx.sig_from_bytes(b[:n]),
            (ctx.sig_from_bytes(b[n : 2 * n]), ctx.sig_from_bytes(b[2 * n :])),
        )


def _blind_exponent(sigkey, hidden_count, known_messages):
    """h's exponent in c_tilde_2: x + sum_j y_{hidden+j} m_j mod r."""
    exp = sigkey.x
    for i, m in enumerate(known_messages):
        exp = (exp + sigkey.y[hidden_count + i] * m) % R
    return exp


def batch_prepare_blind_sign(messages_list, count_hidden, elgamal_pk, params, backend=None):
    """User-side PrepareBlindSign over a batch: the requests
    `SignatureRequest.new` makes, one a message vector, with the group
    operations batched on `backend`. `elgamal_pk` is one ElGamal public key
    for the whole batch, or a list of B keys, one a request (a Python list:
    an affine point is a tuple). Returns [(request, randomness [r,
    k_1..k_hidden])].

    With a list of keys the commitments and g^k go through the shared comb
    synchronously, pk^k through the distinct-base MSM ([pk_i] a row,
    repeated count_hidden times a request), h^m through another distinct
    MSM, and c2 = pk^k + h^m is a host add: the reference's path for this
    form.

    Draws every r, then every request's k's. On a backend with the
    asynchronous contracts the commitments and the two ElGamal comb MSMs
    (g^k, pk^k) are enqueued as two programs, the host waits only for the
    commitments, hashes each request to its h (on the device when
    `backend.device_hash_enabled()`: G1 only, and a failure of the device
    hash raises), and enqueues h^m with pk^k as a per-lane offset, so
    c2 = pk^k + h^m is assembled on the device. Without the offset
    contract h^m is a distinct MSM and c2 a host add; without the
    asynchronous contracts (the host spec) every MSM is synchronous."""
    B = len(messages_list)
    if B == 0:
        return []
    pk_list = None
    if isinstance(elgamal_pk, list):
        pk_list = list(elgamal_pk)
        if len(pk_list) != B:
            raise GeneralError(
                "elgamal_pk list length %d != batch size %d" % (len(pk_list), B)
            )
    backend = _batch_backend(backend)
    ctx = params.ctx
    ops = ctx.sig
    q = params.msg_count()
    for msgs in messages_list:
        if len(msgs) != q:
            raise UnsupportedNoOfMessages(q, len(msgs))
        if len(msgs) < count_hidden:
            raise GeneralError(
                "count_hidden %d exceeds message count %d" % (count_hidden, len(msgs))
            )
    grp = "g1" if ctx.name == "G1" else "g2"
    msm_shared = getattr(backend, "msm_%s_shared" % grp)
    msm_distinct = getattr(backend, "msm_%s_distinct" % grp)

    rs = [rand_fr() for _ in range(B)]
    commit_bases = list(params.h[:count_hidden]) + [params.g]
    commit_rows = [list(m[:count_hidden]) + [r] for m, r in zip(messages_list, rs)]
    known_lists = [list(m[count_hidden:]) for m in messages_list]
    ks = [[rand_fr() for _ in range(count_hidden)] for _ in range(B)]
    flat_k = [[k] for row in ks for k in row]

    if count_hidden == 0:
        commitments = msm_shared(commit_bases, commit_rows)
        return [
            (SignatureRequest(k, c, []), [r]) for k, c, r in zip(known_lists, commitments, rs)
        ]

    many_api = async_shared_many_api(backend, grp)
    distinct_api = async_distinct_api(backend, grp)
    elg_handle = None
    if pk_list is not None:
        commitments = msm_shared(commit_bases, commit_rows)
        gk = msm_shared([params.g], flat_k)
        pkk = msm_distinct(
            [[pk_list[i]] for i in range(B) for _ in range(count_hidden)], flat_k
        )
    elif many_api is not None:
        many_dispatch, many_wait = many_api
        commit_handle = many_dispatch([(commit_bases, commit_rows)])
        elg_handle = many_dispatch([([params.g], flat_k), ([elgamal_pk], flat_k)])
        (commitments,) = many_wait(commit_handle)
    else:
        commitments = msm_shared(commit_bases, commit_rows)
        gk = msm_shared([params.g], flat_k)
        pkk = msm_shared([elgamal_pk], flat_k)

    # each request's generator h; on the asynchronous path this overlaps
    # the ElGamal program
    datas = [
        SignatureRequest.hash_input(c, known, ctx)
        for c, known in zip(commitments, known_lists)
    ]
    # the reference's order: the device hash (which raises on failure, by
    # the port's rule), else the native core's batch (~100x the spec's
    # rate), else the spec; the bits are the same
    device_hash = getattr(backend, "device_hash_enabled", None)
    if ctx.name == "G1" and device_hash is not None and device_hash():
        hs = backend.hash_to_g1_batch(datas)
    elif ctx.name == "G1" and native.available():
        hs = native.hash_to_g1_batch(datas)
    else:
        hs = [ctx.hash_to_sig(d) for d in datas]

    hm_points = [[h] for h in hs for _ in range(count_hidden)]
    hm_scalars = [[m % R] for msgs in messages_list for m in msgs[:count_hidden]]
    offset_api = async_distinct_plus_offset_api(backend, grp)
    c2s = None
    if elg_handle is not None and offset_api is not None:
        offset_dispatch, offset_wait = offset_api
        c2_handle = offset_dispatch(hm_points, hm_scalars, elg_handle[1])
        (gk,) = many_wait((elg_handle[0],))
        c2s = offset_wait(c2_handle)
    elif elg_handle is not None and distinct_api is not None:
        distinct_dispatch, distinct_wait = distinct_api
        hm_handle = distinct_dispatch(hm_points, hm_scalars)
        gk, pkk = many_wait(elg_handle)
        hm = distinct_wait(hm_handle)
    else:
        if elg_handle is not None:
            gk, pkk = many_wait(elg_handle)
        hm = msm_distinct(hm_points, hm_scalars)
    out = []
    for i, (known, c, h, r) in enumerate(zip(known_lists, commitments, hs, rs)):
        cts = []
        for j in range(count_hidden):
            f = i * count_hidden + j
            c2 = c2s[f] if c2s is not None else ops.add(pkk[f], hm[f])
            cts.append((gk[f], c2))
        req = SignatureRequest(known, c, cts)
        req._h_cache = h
        out.append((req, [r] + ks[i]))
    return out


def batch_blind_sign(sig_requests, sigkey, params, backend=None):
    """Signer-side BlindSign over a batch: the BlindSignature.new of each
    request. All requests share one hidden / known split; callers have
    verified each request's proof of knowledge. With the asynchronous
    distinct contract c_tilde_1 and c_tilde_2 run as ONE distinct MSM: the
    c_tilde_1 rows (k = hidden) pad with an identity base and a zero scalar
    to the c_tilde_2 width and stack into [2B, hidden+1] rows."""
    if not sig_requests:
        return []
    backend = _batch_backend(backend)
    ctx = params.ctx
    hidden_count = len(sig_requests[0].ciphertexts)
    for req in sig_requests:
        if len(req.ciphertexts) != hidden_count or len(req.known_messages) != len(sigkey.y) - hidden_count:
            raise UnsupportedNoOfMessages(
                len(sigkey.y), len(req.ciphertexts) + len(req.known_messages)
            )
    hs, points, scalars = blind_sign_rows(sig_requests, sigkey, ctx)
    grp = "g1" if ctx.name == "G1" else "g2"
    msm = getattr(backend, "msm_%s_distinct" % grp)
    B = len(sig_requests)
    c2_points, c2_scalars = points[B:], scalars[B:]
    fused = async_distinct_api(backend, grp)
    if fused is not None:
        fused_dispatch, fused_wait = fused
        out = fused_wait(fused_dispatch(points, scalars))
        c1s, c2s = out[:B], out[B:]
    elif hidden_count == 0:
        c1s = [None] * B  # no ciphertexts: c_tilde_1 is the identity
        c2s = msm(c2_points, c2_scalars)
    else:
        c1s = msm(
            [[a for a, _ in req.ciphertexts] for req in sig_requests],
            [list(sigkey.y[:hidden_count])] * B,
        )
        c2s = msm(c2_points, c2_scalars)
    return [BlindSignature(h, (c1, c2)) for h, c1, c2 in zip(hs, c1s, c2s)]


def blind_sign_rows(sig_requests, sigkey, ctx):
    """(hs, points, scalars) of a blind-sign batch as one [2B, hidden+1]
    distinct MSM: B rows of c_tilde_1 (the ciphertexts' first points and
    y_i, padded with an identity base and a zero scalar), then B rows of
    c_tilde_2 (their second points and h, with y_i and h's exponent)."""
    hidden_count = len(sig_requests[0].ciphertexts)
    ys = list(sigkey.y[:hidden_count])
    hs = [req.get_h(ctx) for req in sig_requests]
    points = [[a for a, _ in req.ciphertexts] + [None] for req in sig_requests]
    scalars = [ys + [0] for _ in sig_requests]
    for req, h in zip(sig_requests, hs):
        points.append([b for _, b in req.ciphertexts] + [h])
        scalars.append(ys + [_blind_exponent(sigkey, hidden_count, req.known_messages)])
    return hs, points, scalars


def batch_unblind(blind_sigs, elgamal_sk, ctx, backend=None):
    """User-side Unblind over a batch: sigma_2 = c_tilde_2 - c_tilde_1^sk,
    the scalar multiplications as one k = 1 distinct MSM and the
    subtractions on the host. `elgamal_sk` is one secret for every blind
    signature, or a list (or tuple) of one a blind signature: the issuance
    service unblinds many users' partials in one call (issue/quorum.py)."""
    if not blind_sigs:
        return []
    backend = _batch_backend(backend)
    if isinstance(elgamal_sk, (list, tuple)):
        if len(elgamal_sk) != len(blind_sigs):
            raise GeneralError(
                "per-signature elgamal_sk list length %d != %d blind "
                "signatures" % (len(elgamal_sk), len(blind_sigs))
            )
        sk_rows = [[sk] for sk in elgamal_sk]
    else:
        sk_rows = [[elgamal_sk]] * len(blind_sigs)
    msm = getattr(backend, "msm_%s_distinct" % ("g1" if ctx.name == "G1" else "g2"))
    a_sks = msm([[bs.blinded[0]] for bs in blind_sigs], sk_rows)
    ops = ctx.sig
    return [
        Signature(bs.h, ops.sub(bs.blinded[1], a_sk)) for bs, a_sk in zip(blind_sigs, a_sks)
    ]


def batch_aggregate(threshold, partials_list, ctx=None, backend=None):
    """Lagrange-aggregate many requests' partial signatures in ONE [B, t]
    distinct MSM: partials_list holds one list of (signer_id, Signature)
    pairs a request, each validated as Signature.aggregate validates it and
    aggregated over its first `threshold` pairs."""
    if not partials_list:
        return []
    ctx = _default_ctx(ctx)
    backend = _batch_backend(backend)
    sigma_1s, rows_bases, rows_exps = [], [], []
    for sigs in partials_list:
        if len(sigs) < threshold:
            raise GeneralError("need at least %d signatures, got %d" % (threshold, len(sigs)))
        use = sigs[:threshold]
        ids = _validate_share_ids(use, threshold)
        sigma_1s.append(_shared_sigma_1(use))
        rows_bases.append([s.sigma_2 for _, s in use])
        rows_exps.append([lagrange_basis_at_0(ids, i) for i, _ in use])
    msm = getattr(backend, "msm_%s_distinct" % ("g1" if ctx.name == "G1" else "g2"))
    sigma_2s = msm(rows_bases, rows_exps)
    return [Signature(s1, s2) for s1, s2 in zip(sigma_1s, sigma_2s)]
