"""Minimal data holders for the verify and show-verify slices: the group
contexts of both signature assignments and the Params / Signature / Verkey / proof shapes the backend
reads.

TorchBackend reads these by duck typing (sig.sigma_1, sig.sigma_2,
vk.X_tilde, vk.Y_tilde, params.g, params.g_tilde, params.ctx.name, and a
proof's sigma_prime_1, sigma_prime_2, J, proof_vc.t, proof_vc.responses,
revealed_msg_indices), so any objects with those attributes work, the JAX
package's own included. The holders carry data only: the prover and the
Fiat-Shamir challenge are not part of the port yet.
"""

from .ops.curve import G1_GEN, G2_GEN, g1, g2


class GroupContext:
    """Binds the roles SignatureGroup / OtherGroup to concrete groups: "G1"
    puts signatures in G1 and verkeys in G2 (the default), "G2" the
    reverse."""

    def __init__(self, name):
        if name == "G1":
            self.sig, self.other = g1, g2
            self.sig_gen, self.other_gen = G1_GEN, G2_GEN
        elif name == "G2":
            self.sig, self.other = g2, g1
            self.sig_gen, self.other_gen = G2_GEN, G1_GEN
        else:
            raise ValueError("unknown signature group %r" % (name,))
        self.name = name


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


class SchnorrProof:
    """Response phase of a Schnorr proof of committed values: the
    commitment t (a point) and one response b_i - c * s_i mod r a base."""

    def __init__(self, t, responses):
        self.t = t
        self.responses = list(responses)


class PoKOfSignatureProof:
    """A shown credential: the re-randomized signature (sigma'_1,
    sigma'_2), J = g_tilde^t * prod_hidden Y_tilde_j^{m_j}, the Schnorr
    proof of its opening and the set of revealed message indices."""

    def __init__(self, sigma_prime_1, sigma_prime_2, J, proof_vc,
                 revealed_msg_indices):
        self.sigma_prime_1 = sigma_prime_1
        self.sigma_prime_2 = sigma_prime_2
        self.J = J
        self.proof_vc = proof_vc
        self.revealed_msg_indices = set(revealed_msg_indices)
