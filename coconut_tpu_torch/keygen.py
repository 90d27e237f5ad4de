"""Threshold key generation — the port's copy of `coconut_tpu/keygen.py`:
`Signer`, `keygen_from_shares`, the trusted dealer by plain Shamir
(`trusted_party_SSS_keygen`) or by Pedersen VSS
(`trusted_party_PVSS_keygen`), and the in-process dealerless driver
`dvss_keygen` (alias `setup_signers_for_test`). Any `threshold` of the
`total` signers' partial signatures aggregate into one credential under the
aggregated verkey. The online, dealerless path is keylife/dkg.py."""

from collections import namedtuple

from .errors import GeneralError
from .ops.fields import R
from .signature import Sigkey, Verkey
from .sss import PedersenVSS, get_shared_secret, share_secret_dvss


class Signer:
    """id (1-based), signing key, verification key."""

    def __init__(self, signer_id, sigkey, verkey):
        self.id = signer_id
        self.sigkey = sigkey
        self.verkey = verkey


def keygen_from_shares(num_signers, x_shares, y_shares, params):
    """Lift secret shares to per-signer keys: alpha_i = g_tilde^{x_i},
    beta_i[j] = g_tilde^{y_i[j]}."""
    x_shares = dict(x_shares)
    y_shares = [dict(m) for m in y_shares]
    ops = params.ctx.other
    signers = []
    for i in range(num_signers):
        sid = i + 1
        try:
            x_i = x_shares.pop(sid)
            y_i = [m.pop(sid) for m in y_shares]
        except KeyError:
            raise GeneralError("missing share for signer id %d" % sid)
        alpha_i = ops.mul(params.g_tilde, x_i)
        beta_i = [ops.mul(params.g_tilde, y) for y in y_i]
        signers.append(Signer(sid, Sigkey(x_i, y_i), Verkey(alpha_i, beta_i)))
    return signers


def trusted_party_SSS_keygen(threshold, total, params):
    """Trusted-dealer key generation by Shamir sharing: (secret_x, secret_y
    list, signers). The first two are the master secrets, which a real
    dealer destroys. Draws x's polynomial, then each y_j's."""
    secret_x, x_shares = get_shared_secret(threshold, total)
    secret_y, y_shares = [], []
    for _ in range(params.msg_count()):
        s, shares = get_shared_secret(threshold, total)
        secret_y.append(s)
        y_shares.append(shares)
    return secret_x, secret_y, keygen_from_shares(total, x_shares, y_shares, params)


PVSSKeygenOutput = namedtuple(
    "PVSSKeygenOutput",
    [
        "secret_x",
        "secret_y",
        "signers",
        "secret_x_t",
        "comm_coeff_x",
        "x_shares",
        "x_t_shares",
        "secret_y_t",
        "comm_coeff_y",
        "y_shares",
        "y_t_shares",
    ],
)


def trusted_party_PVSS_keygen(threshold, total, params, g, h):
    """Trusted-dealer keygen by Pedersen VSS: the reference's 11 fields as a
    named tuple, so each signer can `PedersenVSS.verify_share` its share
    against the coefficient commitments."""
    secret_x, secret_x_t, comm_coeff_x, x_shares, x_t_shares = PedersenVSS.deal(
        threshold, total, g, h
    )
    secret_y, secret_y_t, comm_coeff_y, y, y_t = [], [], [], [], []
    for _ in range(params.msg_count()):
        s, s_t, cc, shares, t_shares = PedersenVSS.deal(threshold, total, g, h)
        secret_y.append(s)
        secret_y_t.append(s_t)
        comm_coeff_y.append(cc)
        y.append(shares)
        y_t.append(t_shares)
    signers = keygen_from_shares(total, x_shares, y, params)
    return PVSSKeygenOutput(
        secret_x,
        secret_y,
        signers,
        secret_x_t,
        comm_coeff_x,
        x_shares,
        x_t_shares,
        secret_y_t,
        comm_coeff_y,
        y,
        y_t,
    )


def dvss_keygen(threshold, total, params, g, h):
    """Dealerless keygen by Pedersen DVSS, all participants simulated in
    process: one full sharing round for x and for each y_j. Returns
    (secret_x, secret_y, signers); the master secrets exist only because the
    simulation holds every participant (tests and benches — the online path,
    keylife/, never forms them)."""
    secret_x = 0
    x_shares = {}
    for p in share_secret_dvss(threshold, total, g, h):
        x_shares[p.id] = p.secret_share
        secret_x = (secret_x + p.secret) % R
    secret_y = []
    y_shares = []
    for _ in range(params.msg_count()):
        shares = {}
        sec = 0
        for p in share_secret_dvss(threshold, total, g, h):
            shares[p.id] = p.secret_share
            sec = (sec + p.secret) % R
        y_shares.append(shares)
        secret_y.append(sec)
    signers = keygen_from_shares(total, x_shares, y_shares, params)
    return secret_x, secret_y, signers


# the reference's name for the dealerless setup (a test-scoped name there)
setup_signers_for_test = dvss_keygen
