"""Scalar randomness and secret sharing over Fr — the port's copy of
`coconut_tpu/sss.py`: `rand_fr`, the polynomial helpers,
`lagrange_basis_at_0`, Shamir's `get_shared_secret` / `reconstruct_secret`,
Pedersen VSS (`PedersenVSS`: `gens`, `deal`, `deal_zero`, `check_share`,
`verify_share`) and the dealerless Pedersen DVSS (`PedersenDVSSParticipant`,
`share_secret_dvss`). The commitments live in G1 on the host spec
(`ops/curve.py`; `gens` hashes a label to G1 by `ops/hashing.hash_to_g1`),
as in the reference; every reject path raises `ShareVerificationError`
naming the dealer, with the reference's messages."""

import secrets

from .errors import GeneralError, ShareVerificationError
from .ops.curve import g1 as _g1_ops
from .ops.fields import R, fr_inv, fr_mul
from .ops.hashing import hash_to_g1


def rand_fr():
    """Uniform scalar in [0, r) from the OS CSPRNG."""
    return secrets.randbelow(R)


def poly_random(degree):
    """Random polynomial of the given degree (degree+1 coefficients, a0
    first)."""
    return [rand_fr() for _ in range(degree + 1)]


def poly_eval(coeffs, x):
    """Horner evaluation at integer x, in Fr."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def lagrange_basis_at_0(ids, my_id):
    """The Lagrange basis polynomial l_{my_id}(0) over the interpolation set
    `ids` (1-based, gaps allowed)."""
    ids = set(ids)
    if my_id not in ids:
        raise GeneralError("id %d not in interpolation set %s" % (my_id, sorted(ids)))
    if 0 in ids:
        raise GeneralError("signer ids must be nonzero (1-based)")
    num, den = 1, 1
    for j in ids:
        if j == my_id:
            continue
        num = num * (j % R) % R
        den = den * ((j - my_id) % R) % R
    return fr_mul(num, fr_inv(den))


def _check_threshold(threshold, total):
    if not 0 < threshold <= total:
        raise GeneralError("invalid threshold %d for total %d" % (threshold, total))


def get_shared_secret(threshold, total):
    """Deal a fresh random secret into `total` Shamir shares with
    reconstruction threshold `threshold`: (secret, {id: share}), ids
    1-based."""
    _check_threshold(threshold, total)
    coeffs = poly_random(threshold - 1)
    return coeffs[0], {i: poly_eval(coeffs, i) for i in range(1, total + 1)}


def reconstruct_secret(threshold, shares):
    """Lagrange-interpolate the secret at 0 from the `threshold` lowest-id
    shares of {id: share}."""
    if len(shares) < threshold:
        raise GeneralError(
            "need %d shares to reconstruct, got %d" % (threshold, len(shares))
        )
    use = dict(list(sorted(shares.items()))[:threshold])
    acc = 0
    for i, s in use.items():
        acc = (acc + lagrange_basis_at_0(use.keys(), i) * s) % R
    return acc


# --- Pedersen verifiable secret sharing ------------------------------------


class PedersenVSS:
    """Pedersen VSS with coefficient commitments g^{a_j} h^{b_j} in G1."""

    ops = _g1_ops

    @classmethod
    def gens(cls, label):
        """Two independent generators hashed from a label."""
        return (
            hash_to_g1(bytes(label) + b" : g"),
            hash_to_g1(bytes(label) + b" : h"),
        )

    @classmethod
    def _commit(cls, f_coeffs, g_coeffs, g, h, total):
        comm_coeffs = {
            j: cls.ops.add(cls.ops.mul(g, f_coeffs[j]), cls.ops.mul(h, g_coeffs[j]))
            for j in range(len(f_coeffs))
        }
        s_shares = {i: poly_eval(f_coeffs, i) for i in range(1, total + 1)}
        t_shares = {i: poly_eval(g_coeffs, i) for i in range(1, total + 1)}
        return comm_coeffs, s_shares, t_shares

    @classmethod
    def deal(cls, threshold, total, g, h):
        """Deal a fresh secret with blinding: (secret, blind_secret,
        comm_coeffs {j: g^{a_j} h^{b_j}}, s_shares {id: F(id)}, t_shares
        {id: G(id)}). Draws F's coefficients, then G's."""
        _check_threshold(threshold, total)
        f_coeffs = poly_random(threshold - 1)
        g_coeffs = poly_random(threshold - 1)
        comm, s_shares, t_shares = cls._commit(f_coeffs, g_coeffs, g, h, total)
        return f_coeffs[0], g_coeffs[0], comm, s_shares, t_shares

    @classmethod
    def deal_zero(cls, threshold, total, g, h):
        """A sharing of zero for proactive refresh: F(0) = 0 (its constant
        coefficient is still drawn, then pinned), G fully random. Returns
        (b0, comm_coeffs, s_shares, t_shares); recipients check
        comm_coeffs[0] == h^{b0} before accepting."""
        _check_threshold(threshold, total)
        f_coeffs = poly_random(threshold - 1)
        f_coeffs[0] = 0
        g_coeffs = poly_random(threshold - 1)
        comm, s_shares, t_shares = cls._commit(f_coeffs, g_coeffs, g, h, total)
        return g_coeffs[0], comm, s_shares, t_shares

    @classmethod
    def check_share(
        cls, threshold, share_id, share, comm_coeffs, g, h,
        dealer_id=None, round=None,
    ):
        """Raise ShareVerificationError (naming `dealer_id` and `round`)
        unless g^s h^t == prod_j comm_coeffs[j]^(share_id^j)."""
        s, t = share
        lhs = cls.ops.add(cls.ops.mul(g, s), cls.ops.mul(h, t))
        bases, exps = [], []
        e = 1
        for j in range(threshold):
            bases.append(comm_coeffs[j])
            exps.append(e)
            e = e * share_id % R
        if lhs != cls.ops.msm(bases, exps):
            raise ShareVerificationError(
                "share for participant %d failed verification against "
                "dealer %s's commitments%s"
                % (
                    share_id,
                    dealer_id if dealer_id is not None else "?",
                    " in %s round" % round if round else "",
                ),
                dealer_id=dealer_id,
                round=round,
            )

    @classmethod
    def verify_share(cls, threshold, share_id, share, comm_coeffs, g, h):
        """Boolean form of `check_share`."""
        try:
            cls.check_share(threshold, share_id, share, comm_coeffs, g, h)
        except ShareVerificationError:
            return False
        return True


# --- Pedersen decentralized (dealerless) VSS --------------------------------


class PedersenDVSSParticipant:
    """One participant of the dealerless protocol: deals its own secret,
    receives and verifies the others' shares, sums them."""

    def __init__(self, participant_id, threshold, total, g, h):
        self.id = participant_id
        self.threshold = threshold
        self.total = total
        (
            self.secret,
            self.blind_secret,
            self.comm_coeffs,
            self.s_shares,
            self.t_shares,
        ) = PedersenVSS.deal(threshold, total, g, h)
        self._received = {}  # from_id -> (s, t)
        self._received_comms = {}  # from_id -> comm_coeffs
        self.secret_share = None
        self.t_secret_share = None
        self.final_comm_coeffs = None

    def received_share(self, from_id, comm_coeffs, share, threshold, total, g, h):
        """Verify and keep a share of `from_id`'s secret at our id; every
        reject raises ShareVerificationError naming the dealer."""
        if from_id == self.id:
            raise ShareVerificationError(
                "participant %d received its own share" % self.id,
                dealer_id=from_id,
                round="dvss",
            )
        if from_id in self._received:
            raise ShareVerificationError(
                "participant %d already has a share from %d" % (self.id, from_id),
                dealer_id=from_id,
                round="dvss",
            )
        PedersenVSS.check_share(
            threshold, self.id, share, comm_coeffs, g, h,
            dealer_id=from_id, round="dvss",
        )
        self._received[from_id] = share
        self._received_comms[from_id] = comm_coeffs

    def compute_final_comm_coeffs_and_shares(self, threshold, total, g, h):
        """Sum own and received shares into this participant's share of the
        distributed secret, and the coefficient commitments likewise."""
        if len(self._received) != total - 1:
            raise GeneralError(
                "participant %d has %d of %d expected shares"
                % (self.id, len(self._received), total - 1)
            )
        s_acc = self.s_shares[self.id]
        t_acc = self.t_shares[self.id]
        for s, t in self._received.values():
            s_acc = (s_acc + s) % R
            t_acc = (t_acc + t) % R
        self.secret_share = s_acc
        self.t_secret_share = t_acc
        final = {}
        for j in range(threshold):
            acc = self.comm_coeffs[j]
            for comms in self._received_comms.values():
                acc = PedersenVSS.ops.add(acc, comms[j])
            final[j] = acc
        self.final_comm_coeffs = final


def share_secret_dvss(threshold, total, g, h):
    """The dealerless protocol simulated in-process: every participant
    deals, exchanges and verifies pairwise, then finalizes."""
    participants = [
        PedersenDVSSParticipant(i, threshold, total, g, h)
        for i in range(1, total + 1)
    ]
    for i in range(total):
        for j in range(total):
            if i == j:
                continue
            sender = participants[j]
            participants[i].received_share(
                sender.id,
                sender.comm_coeffs,
                (sender.s_shares[i + 1], sender.t_shares[i + 1]),
                threshold,
                total,
                g,
                h,
            )
    for p in participants:
        p.compute_final_comm_coeffs_and_shares(threshold, total, g, h)
    return participants
