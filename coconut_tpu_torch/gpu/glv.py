"""GLV split for the G1 distinct-base MSMs — the port's host copy of
`coconut_tpu/tpu/glv.py`.

E(Fp) carries the endomorphism phi(x, y) = (beta * x, y) with phi(P) =
lambda * P on the r-order subgroup, beta a cube root of unity in Fp and
lambda = z^2 - 1 (z the BLS parameter) one mod r. As lambda ~ 2^127.1 and
r ~ 2^254.9, the plain Euclidean split k = k2 * lambda + k1 gives two
nonnegative halves below 2^128, so k * P = k1 * P + k2 * phi(P): the
Horner schedule of a distinct MSM runs 27 windows instead of 52 for the
same number of adds.

Precondition: the points lie in the r-order subgroup (the prover's
sigma points do).
"""

from ..ops.fields import P, R

Z = -0xD201000000010000
LAMBDA = (Z * Z - 1) % R
# the cube root of unity in Fp that pairs with lambda
BETA = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC

assert (LAMBDA * LAMBDA + LAMBDA + 1) % R == 0
assert BETA != 1 and pow(BETA, 3, P) == 1

# both halves are < 2^128: ceil(128/5) = 26 signed 5-bit windows plus a
# carry window
HALF_BITS = 128

assert LAMBDA.bit_length() == 128
assert (R - 1) // LAMBDA < 1 << HALF_BITS


def decompose(k):
    """k (mod r) -> (k1, k2) with k = k1 + k2 * lambda, both in [0, 2^128)."""
    # lint: allow(const-time, CONSTTIME.md §1 host caveat - CPython big-int
    # divmod cost tracks bit length; accepted on the host recode path)
    k = int(k) % R
    return k % LAMBDA, k // LAMBDA


def phi(pt):
    """The endomorphism on an affine G1 point (None = identity)."""
    if pt is None:
        return None
    return (pt[0] * BETA % P, pt[1])
