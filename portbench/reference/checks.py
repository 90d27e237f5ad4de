"""The plain reference's verdicts, in two forms.

`ps_verify` and `show_verify` are the spec checks with the public key:
the pairing equations of Pointcheval-Sanders verification and of the
selective-disclosure proof (PoKOfSignature::verify), on Python ints, one
credential or proof at a time (~0.2 s each on a host core).

`ps_verify_exp` and `show_verify_exp` are the same equations with the
signing key: every point of the benchmark's inputs was made from a known
discrete log, so each pairing equation becomes an equation between scalars
mod r, which is exact and costs microseconds. They judge every verdict of a
window; the spec checks judge a sample drawn from the seed.

Inputs are the benchmark's own plain data (harness/fixtures.py): points
as affine int tuples with None for the identity, params as {"g",
"g_tilde"}, the verkey as (X_tilde, [Y_tilde_j]), the signing key as (x,
[y_j]). Nothing here imports the measured program.
"""

from .curve import g1, g2
from .fields import R
from .pairing import pairing_check


def ps_verify(sigma_1, sigma_2, msgs, vk, params):
    """e(sigma_1, X_tilde + sum_j Y_tilde_j * m_j) == e(sigma_2, g_tilde),
    refusing sigma_1 == identity."""
    if sigma_1 is None:
        return False
    X, Y = vk
    acc = g2.add(X, g2.msm(list(Y), list(msgs)))
    return pairing_check([(sigma_1, acc), (g1.neg(sigma_2), params["g_tilde"])])


def show_verify(show, vk, params, hidden):
    """The Schnorr relation on J (sum_k base_k * resp_k + J * c == T over
    the bases [g_tilde, Y_tilde_hidden]), then e(sigma'_1, J + X_tilde +
    sum_revealed Y_tilde_i * m_i) == e(sigma'_2, g_tilde), refusing
    sigma'_1 == identity."""
    s1, s2, J, T, responses, revealed_msgs, c = show
    if s1 is None:
        return False
    X, Y = vk
    bases = [params["g_tilde"]] + [Y[i] for i in hidden]
    if g2.add(g2.msm(bases, responses), g2.mul(J, c)) != T:
        return False
    idxs = sorted(revealed_msgs)
    acc = g2.add(g2.add(J, X), g2.msm([Y[i] for i in idxs], [revealed_msgs[i] for i in idxs]))
    return pairing_check([(s1, acc), (g1.neg(s2), params["g_tilde"])])


def ps_verify_exp(logs, msgs, sk):
    """ps_verify with the signing key: logs = (log sigma_1, log sigma_2)
    over g, sigma_1 the identity when its log is None."""
    log_s1, log_s2 = logs
    if log_s1 is None:
        return False
    x, y = sk
    return log_s2 % R == log_s1 * (x + sum(yj * m for yj, m in zip(y, msgs))) % R


def show_verify_exp(logs, responses, revealed_msgs, challenge, sk, hidden):
    """show_verify with the signing key: logs = (log sigma'_1, log
    sigma'_2, log J, log T), the sigmas over g, J and T over g_tilde."""
    log_s1, log_s2, log_j, log_t = logs
    if log_s1 is None:
        return False
    x, y = sk
    bases = [1] + [y[i] for i in hidden]
    if (sum(a * r for a, r in zip(bases, responses)) + log_j * challenge) % R != log_t % R:
        return False
    acc = x + log_j + sum(y[i] * m for i, m in revealed_msgs.items())
    return log_s2 % R == log_s1 * acc % R
