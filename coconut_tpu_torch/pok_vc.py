"""Schnorr proof of knowledge of committed values, generic over the group —
the port's copy of `coconut_tpu/pok_vc.py`:

  commit phase   : the prover picks blindings b_i (or takes supplied ones)
                   and publishes t = prod base_i ^ b_i;
  response phase : response_i = b_i - c * secret_i (mod r);
  verification   : t == prod base_i ^ response_i * commitment ^ c.

`ops` is a host CurveOps (`ops/curve.py`) and `to_bytes` its point encoder
(`ops/serialize.py`); `Proof.read_from` decodes one proof of a wire struct
(the request proof's `from_bytes`)."""

from .errors import DeserializationError, UnequalNoOfBasesExponents
from .ops.serialize import fr_from_bytes
from .ops.fields import R
from .sss import rand_fr


class ProverCommitting:
    """Accumulates (base, blinding) pairs."""

    def __init__(self, ops, to_bytes):
        self._ops = ops
        self._to_bytes = to_bytes
        self._bases = []
        self._blindings = []

    def commit(self, base, blinding=None):
        if blinding is None:
            blinding = rand_fr()
        self._bases.append(base)
        self._blindings.append(blinding)
        return len(self._bases) - 1

    def finish(self):
        t = self._ops.msm(self._bases, self._blindings)
        return ProverCommitted(self._to_bytes, self._bases, self._blindings, t)


class ProverCommitted:
    """Commitment-phase output."""

    def __init__(self, to_bytes, bases, blindings, t):
        self._to_bytes = to_bytes
        self.bases = bases
        self.blindings = blindings
        self.t = t

    def to_bytes(self):
        """Transcript bytes for Fiat-Shamir: bases then the commitment."""
        return b"".join([self._to_bytes(b) for b in self.bases] + [self._to_bytes(self.t)])

    def gen_proof(self, challenge, secrets):
        if len(secrets) != len(self.bases):
            raise UnequalNoOfBasesExponents(len(self.bases), len(secrets))
        responses = [(b - challenge * s) % R for b, s in zip(self.blindings, secrets)]
        return Proof(self.t, responses)


class Proof:
    """Response-phase output: the commitment t (a point, None for the
    identity) and one response a base."""

    def __init__(self, t, responses):
        self.t = t
        self.responses = list(responses)

    def verify(self, ops, bases, commitment, challenge):
        if len(bases) != len(self.responses):
            raise UnequalNoOfBasesExponents(len(bases), len(self.responses))
        lhs = ops.add(ops.msm(bases, self.responses), ops.mul(commitment, challenge))
        return lhs == self.t

    def to_bytes_with_bases(self, to_bytes, bases):
        """The commit-phase transcript bytes (bases || t), so a Fiat-Shamir
        verifier can recompute the challenge."""
        return b"".join([to_bytes(b) for b in bases] + [to_bytes(self.t)])

    def to_bytes(self, elem_to_bytes):
        """Canonical wire encoding: t || count (4 bytes) || responses (32
        bytes each)."""
        out = [elem_to_bytes(self.t), len(self.responses).to_bytes(4, "big")]
        out.extend(r.to_bytes(32, "big") for r in self.responses)
        return b"".join(out)

    @classmethod
    def read_from(cls, b, offset, elem_from_bytes, elem_size):
        """Parse one Proof at `offset`; returns (proof, next_offset)."""
        if len(b) < offset + elem_size + 4:
            raise DeserializationError("truncated PoK proof encoding")
        t = elem_from_bytes(b[offset : offset + elem_size])
        offset += elem_size
        n = int.from_bytes(b[offset : offset + 4], "big")
        offset += 4
        if len(b) < offset + 32 * n:
            raise DeserializationError("truncated PoK proof responses")
        responses = [
            fr_from_bytes(b[offset + 32 * i : offset + 32 * (i + 1)])
            for i in range(n)
        ]
        return cls(t, responses), offset + 32 * n
