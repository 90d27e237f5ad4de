"""Scalar randomness and Shamir secret sharing over Fr — the port's copy of
`rand_fr`, the polynomial helpers, `lagrange_basis_at_0` and
`get_shared_secret` of the JAX package's `coconut_tpu/sss.py` (its Pedersen
VSS / DVSS half is not part of the port)."""

import secrets

from .errors import GeneralError
from .ops.fields import R, fr_inv, fr_mul


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


def get_shared_secret(threshold, total):
    """Deal a fresh random secret into `total` Shamir shares with
    reconstruction threshold `threshold`: (secret, {id: share}), ids
    1-based."""
    if not 0 < threshold <= total:
        raise GeneralError("invalid threshold %d for total %d" % (threshold, total))
    coeffs = poly_random(threshold - 1)
    return coeffs[0], {i: poly_eval(coeffs, i) for i in range(1, total + 1)}
