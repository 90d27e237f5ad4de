"""Scalar randomness — the port's copy of `rand_fr` of the JAX package's
`coconut_tpu/sss.py` (its secret-sharing half is not part of the port)."""

import secrets

from .ops.fields import R


def rand_fr():
    """Uniform scalar in [0, r) from the OS CSPRNG."""
    return secrets.randbelow(R)
