"""BLS12-381 field arithmetic on Python ints, frozen for the benchmark's
plain reference: the curve constants, Fr, Fp, Fp2, the Fp6/Fp12 tower and
the Frobenius maps the spec pairing needs.

A copy of the pure-Python spec arithmetic, kept here so that the yardstick
does not move when the measured program changes. It imports nothing of
the program.

Representation:
  - Fp  elements: int in [0, P)
  - Fp2 elements: tuple (c0, c1) meaning c0 + c1*u, u^2 = -1
  - Fp6 elements: tuple (c0, c1, c2) of Fp2, v^3 = xi = u+1
  - Fp12 elements: tuple (c0, c1) of Fp6, w^2 = v
"""

# --- Curve constants -------------------------------------------------------

# Base field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (order of G1/G2/GT)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative). r = x^4 - x^2 + 1, p = (x-1)^2/3 * r + x.
BLS_X = -0xD201000000010000

assert R == BLS_X**4 - BLS_X**2 + 1
assert P == (BLS_X - 1) ** 2 // 3 * R + BLS_X

# --- Fr (scalar field) -----------------------------------------------------


def fr_add(a, b):
    return (a + b) % R


def fr_sub(a, b):
    return (a - b) % R


def fr_mul(a, b):
    return (a * b) % R


def fr_neg(a):
    return (-a) % R


def fr_inv(a):
    if a % R == 0:
        raise ZeroDivisionError("inverse of 0 in Fr")
    return pow(a, -1, R)


# --- Fp --------------------------------------------------------------------


def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_sq(a):
    return a * a % P


def fp_neg(a):
    return (-a) % P


def fp_inv(a):
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, -1, P)


def fp_sqrt(a):
    """Square root in Fp (P = 3 mod 4). Returns None if `a` is not a QR."""
    s = pow(a, (P + 1) // 4, P)
    if s * s % P != a % P:
        return None
    return s


def fp_sgn0(a):
    """Sign of an Fp element: parity of the canonical representative."""
    return a & 1


# --- Fp2 = Fp[u]/(u^2+1) ---------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    t2 = (a0 + a1) * (b0 + b1) - t0 - t1
    return ((t0 - t1) % P, t2 % P)


def fp2_sq(a):
    a0, a1 = a
    # (a0+a1)(a0-a1) = a0^2 - a1^2 ; 2*a0*a1
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_mul_fp(a, s):
    return (a[0] * s % P, a[1] * s % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = fp_inv(norm)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fp2_mul_xi(a):
    """Multiply by xi = u + 1: (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1)u."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sq(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 (P = 3 mod 4), or None if `a` is not a QR:
    a1 = a^((p-3)/4), x0 = a1 * a, alpha = a1 * x0 = a^((p-1)/2)."""
    if a == FP2_ZERO:
        return FP2_ZERO
    a1 = fp2_pow(a, (P - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    if alpha == ((-1) % P, 0):
        x = fp2_mul((0, 1), x0)  # u * x0
    else:
        b = fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2)
        x = fp2_mul(b, x0)
    if fp2_sq(x) != a:
        return None
    return x


def fp2_sgn0(a):
    """RFC 9380 sign of an Fp2 element."""
    sign_0 = a[0] & 1
    zero_0 = a[0] == 0
    sign_1 = a[1] & 1
    return sign_0 | (zero_0 & sign_1)


# --- Frobenius coefficients ------------------------------------------------

# gamma1[i] = xi^((p-1)*i/6) for i in 0..5 (Fp2 values)
_GAMMA1 = [fp2_pow(fp2_mul_xi(FP2_ONE), i * (P - 1) // 6) for i in range(6)]
# gamma2[i] = gamma1[i] * conj(gamma1[i]), the Frobenius^2 coefficients
_GAMMA2 = [fp2_mul(_GAMMA1[i], fp2_conj(_GAMMA1[i])) for i in range(6)]


# --- Fp6 = Fp2[v]/(v^3 - xi), xi = u+1 -------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = fp2_add(
        t0,
        fp2_mul_xi(fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1),
        fp2_mul_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fp6_sq(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_mul_fp2(a, s):
    return (fp2_mul(a[0], s), fp2_mul(a[1], s), fp2_mul(a[2], s))


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sq(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sq(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sq(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))), fp2_mul(a0, c0)
    )
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# --- Fp12 = Fp6[w]/(w^2 - v) -----------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    # (a0+a1)(b0+b1) - t0 - t1
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sq(a):
    a0, a1 = a
    # Complex squaring: c0 = (a0+a1)(a0+v*a1) - t - v*t ; c1 = 2t, t = a0*a1
    t = fp6_mul(a0, a1)
    c0 = fp6_sub(
        fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1))), t),
        fp6_mul_by_v(t),
    )
    c1 = fp6_add(t, t)
    return (c0, c1)


def fp12_conj(a):
    """Conjugation = Frobenius^6: a0 - a1 w. For f in the cyclotomic subgroup
    this is f^{-1}."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sq(a0), fp6_mul_by_v(fp6_sq(a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


def fp12_pow(a, e):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sq(base)
        e >>= 1
    return result


# --- Frobenius endomorphism on Fp6/Fp12 ------------------------------------


def fp6_frobenius(a):
    """(a0 + a1 v + a2 v^2) -> conj(a0) + conj(a1)*g1[2]*v + conj(a2)*g1[4]*v^2"""
    return (
        fp2_conj(a[0]),
        fp2_mul(fp2_conj(a[1]), _GAMMA1[2]),
        fp2_mul(fp2_conj(a[2]), _GAMMA1[4]),
    )


def fp12_frobenius(a):
    a0, a1 = a
    b0 = fp6_frobenius(a0)
    # w-part: conj(d_i) * gamma1[2i+1]  (pi(v^i w) = gamma1[2i+1] v^i w)
    b1 = (
        fp2_mul(fp2_conj(a1[0]), _GAMMA1[1]),
        fp2_mul(fp2_conj(a1[1]), _GAMMA1[3]),
        fp2_mul(fp2_conj(a1[2]), _GAMMA1[5]),
    )
    return (b0, b1)


def fp12_frobenius2(a):
    a0, a1 = a
    b0 = (
        a0[0],
        fp2_mul(a0[1], _GAMMA2[2]),
        fp2_mul(a0[2], _GAMMA2[4]),
    )
    b1 = (
        fp2_mul(a1[0], _GAMMA2[1]),
        fp2_mul(a1[1], _GAMMA2[3]),
        fp2_mul(a1[2], _GAMMA2[5]),
    )
    return (b0, b1)
