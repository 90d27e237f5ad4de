"""Threshold key generation by a trusted dealer (plain Shamir) — the port's
copy of `Signer`, `keygen_from_shares` and `trusted_party_SSS_keygen` of
`coconut_tpu/keygen.py`. Any `threshold` of the `total` signers' partial
signatures aggregate into one credential under the aggregated verkey."""

from .errors import GeneralError
from .signature import Sigkey, Verkey
from .sss import get_shared_secret


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
