"""Exponential ElGamal over either group — the port's copy of
`coconut_tpu/elgamal.py`. Encrypt returns the randomness `k`, which the
issuance request's proof of knowledge proves."""

from .sss import rand_fr


def elgamal_keygen(ops, base):
    """(sk, base^sk)."""
    sk = rand_fr()
    return sk, ops.mul(base, sk)


def elgamal_encrypt(ops, base, pk, msg_point):
    """(base^k, pk^k * msg, k)."""
    k = rand_fr()
    c1 = ops.mul(base, k)
    c2 = ops.add(ops.mul(pk, k), msg_point)
    return c1, c2, k


def elgamal_decrypt(ops, c1, c2, sk):
    """c2 - c1^sk."""
    return ops.sub(c2, ops.mul(c1, sk))
