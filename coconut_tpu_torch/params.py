"""The group contexts of both signature assignments and the Params /
Signature / Sigkey / Verkey holders — the port's copy of the parts of
`coconut_tpu/params.py` and `coconut_tpu/signature.py` that the verify and
show paths read.

TorchBackend reads these by duck typing (sig.sigma_1, sig.sigma_2,
vk.X_tilde, vk.Y_tilde, params.g, params.g_tilde, params.ctx.name, and a
proof's sigma_prime_1, sigma_prime_2, J, proof_vc.t, proof_vc.responses,
revealed_msg_indices), so any objects with those attributes work, the JAX
package's own included. The shown credential and its Schnorr proof are
`ps.PoKOfSignatureProof` and `pok_vc.Proof`. Decoding (`*_from_bytes`) and
the label-derived `Params.new` (hash-to-curve) are not part of the port
yet.
"""

from .ops import pairing as _pairing
from .ops import serialize as ser
from .ops.curve import G1_GEN, G2_GEN, g1, g2


class GroupContext:
    """Binds the roles SignatureGroup / OtherGroup to concrete groups: "G1"
    puts signatures in G1 and verkeys in G2 (the default), "G2" the
    reverse."""

    def __init__(self, name):
        if name == "G1":
            self.sig, self.other = g1, g2
            self.sig_gen, self.other_gen = G1_GEN, G2_GEN
            self.sig_to_bytes, self.other_to_bytes = ser.g1_to_bytes, ser.g2_to_bytes
        elif name == "G2":
            self.sig, self.other = g2, g1
            self.sig_gen, self.other_gen = G2_GEN, G1_GEN
            self.sig_to_bytes, self.other_to_bytes = ser.g2_to_bytes, ser.g1_to_bytes
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


class Params:
    """Setup output: g in SignatureGroup, g_tilde in OtherGroup, one h per
    message."""

    def __init__(self, g, g_tilde, h, ctx=SIGNATURES_IN_G1):
        self.g = g
        self.g_tilde = g_tilde
        self.h = list(h)
        self.ctx = ctx


class Signature:
    """PS signature (sigma_1, sigma_2); None is the point at infinity."""

    def __init__(self, sigma_1, sigma_2):
        self.sigma_1 = sigma_1
        self.sigma_2 = sigma_2


class Sigkey:
    def __init__(self, x, y):
        self.x = x
        self.y = list(y)


class Verkey:
    def __init__(self, X_tilde, Y_tilde):
        self.X_tilde = X_tilde
        self.Y_tilde = list(Y_tilde)
