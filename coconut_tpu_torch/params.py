"""The group contexts of both signature assignments and the Params holder —
the port's copy of `coconut_tpu/params.py`: the roles SignatureGroup /
OtherGroup, their hashes, encoders and correctly ordered pairing check, and
the label-derived setup `Params.new`. The Sigkey / Verkey / Signature
holders live in `signature.py` (imported here under their old names).

TorchBackend reads these by duck typing (sig.sigma_1, sig.sigma_2,
vk.X_tilde, vk.Y_tilde, params.g, params.g_tilde, params.ctx.name, and a
proof's sigma_prime_1, sigma_prime_2, J, proof_vc.t, proof_vc.responses,
revealed_msg_indices), so any objects with those attributes work, the JAX
package's own included. A context decodes single points
(`sig_from_bytes` / `other_from_bytes`), and `Params.to_bytes` /
`from_bytes` encode the setup as g || g_tilde || h_1 || ...
"""

from .errors import DeserializationError
from .ops import pairing as _pairing
from .ops import serialize as ser
from .ops.curve import G1_GEN, G2_GEN, g1, g2
from .ops.hashing import hash_to_g1, hash_to_g2
from .signature import Sigkey, Signature, Verkey  # noqa: F401 (their old home)


class GroupContext:
    """Binds the roles SignatureGroup / OtherGroup to concrete groups: "G1"
    puts signatures in G1 and verkeys in G2 (the default), "G2" the
    reverse."""

    def __init__(self, name):
        if name == "G1":
            self.sig, self.other = g1, g2
            self.sig_gen, self.other_gen = G1_GEN, G2_GEN
            self.hash_to_sig, self.hash_to_other = hash_to_g1, hash_to_g2
            self.sig_to_bytes, self.other_to_bytes = ser.g1_to_bytes, ser.g2_to_bytes
            self.sig_from_bytes, self.other_from_bytes = ser.g1_from_bytes, ser.g2_from_bytes
            self.sig_nbytes, self.other_nbytes = 96, 192
        elif name == "G2":
            self.sig, self.other = g2, g1
            self.sig_gen, self.other_gen = G2_GEN, G1_GEN
            self.hash_to_sig, self.hash_to_other = hash_to_g2, hash_to_g1
            self.sig_to_bytes, self.other_to_bytes = ser.g2_to_bytes, ser.g1_to_bytes
            self.sig_from_bytes, self.other_from_bytes = ser.g2_from_bytes, ser.g1_from_bytes
            self.sig_nbytes, self.other_nbytes = 192, 96
        else:
            raise ValueError("unknown signature group %r" % (name,))
        self.name = name

    def pairing_check(self, pairs):
        """prod e(sig_i, other_i) == 1 over (signature-group point,
        other-group point) pairs, mapped to the (G1, G2) order the pairing
        needs."""
        if self.name == "G1":
            ordered = [(s, o) for s, o in pairs]
        else:
            ordered = [(o, s) for s, o in pairs]
        return _pairing.pairing_check(ordered)


SIGNATURES_IN_G1 = GroupContext("G1")
SIGNATURES_IN_G2 = GroupContext("G2")
DEFAULT_CTX = SIGNATURES_IN_G1


class Params:
    """Setup output: g in SignatureGroup, g_tilde in OtherGroup, one h per
    message."""

    def __init__(self, g, g_tilde, h, ctx=DEFAULT_CTX):
        self.g = g
        self.g_tilde = g_tilde
        self.h = list(h)
        self.ctx = ctx

    @classmethod
    def new(cls, msg_count, label, ctx=DEFAULT_CTX):
        """Deterministic params from a label, with the reference's
        domain-separating suffixes: every party derives the same params."""
        label = bytes(label)
        g = ctx.hash_to_sig(label + b" : g")
        g_tilde = ctx.hash_to_other(label + b" : g_tilde")
        h = [ctx.hash_to_sig(label + b" : y" + str(i).encode()) for i in range(msg_count)]
        return cls(g, g_tilde, h, ctx)

    def msg_count(self):
        return len(self.h)

    def to_bytes(self):
        out = [self.ctx.sig_to_bytes(self.g), self.ctx.other_to_bytes(self.g_tilde)]
        out.extend(self.ctx.sig_to_bytes(hi) for hi in self.h)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, b, ctx=DEFAULT_CTX):
        head = ctx.sig_nbytes + ctx.other_nbytes
        if len(b) < head or (len(b) - head) % ctx.sig_nbytes:
            raise DeserializationError("malformed Params encoding")
        g = ctx.sig_from_bytes(b[: ctx.sig_nbytes])
        g_tilde = ctx.other_from_bytes(b[ctx.sig_nbytes : head])
        h = [
            ctx.sig_from_bytes(b[o : o + ctx.sig_nbytes])
            for o in range(head, len(b), ctx.sig_nbytes)
        ]
        return cls(g, g_tilde, h, ctx)

    def __eq__(self, other):
        return (
            isinstance(other, Params)
            and self.g == other.g
            and self.g_tilde == other.g_tilde
            and self.h == other.h
            and self.ctx.name == other.ctx.name
        )
