"""Optimal-ate pairing on BLS12-381 on Python ints, frozen for the
benchmark's plain reference: the projective Miller loop, the final
exponentiation, `pairing` and the pairing-product check, and the affine
Miller loop and direct final power as cross-checks.

Spec decisions:
  - e(P, Q) := final_exp(miller_loop_projective(P, Q));
  - final_exp(f) := f ** (3 * (p^12 - 1) / r); cubing is a bijection on
    the order-r target group, so `== 1` is unaffected;
  - pairing products share one final exponentiation.
"""

from .fields import (
    BLS_X,
    FP2_ONE,
    FP2_ZERO,
    FP6_ZERO,
    FP12_ONE,
    P,
    R,
    fp2_add,
    fp2_mul,
    fp2_mul_fp,
    fp2_mul_xi,
    fp2_neg,
    fp2_sq,
    fp2_sub,
    fp12_conj,
    fp12_frobenius,
    fp12_frobenius2,
    fp12_inv,
    fp12_mul,
    fp12_pow,
    fp12_sq,
    fp12_sub,
)

# --- Fp12 embedding and the untwist ------------------------------------------


def _embed_fp(a):
    """Fp -> Fp12."""
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _embed_fp2(c):
    """Fp2 -> Fp12."""
    return ((c, FP2_ZERO, FP2_ZERO), FP6_ZERO)


# w^2 = v and w^3 = v*w as Fp12 elements; their inverses computed once.
_W2 = ((FP2_ZERO, (1, 0), FP2_ZERO), FP6_ZERO)
_W3 = (FP6_ZERO, (FP2_ZERO, (1, 0), FP2_ZERO))
_W2_INV = fp12_inv(_W2)
_W3_INV = fp12_inv(_W3)


def untwist(q):
    """Map a G2 point on the twist E'(Fp2) to E(Fp12): (x,y) -> (x/w^2, y/w^3)."""
    x, y = q
    return (fp12_mul(_embed_fp2(x), _W2_INV), fp12_mul(_embed_fp2(y), _W3_INV))


# --- affine Miller loop (the cross-check oracle) -----------------------------

_X_ABS_BITS = bin(-BLS_X)[2:]


def miller_loop(p1, q2):
    """Miller loop f_{|x|,Q}(P) over Fp12, affine through the untwist, with
    the end conjugation for x < 0; one Fp12 inversion a step.

    p1: G1 affine (Fp pair) or None; q2: G2 affine (Fp2 pair) or None.
    Returns an Fp12 element (1 if either input is the identity).
    """
    if p1 is None or q2 is None:
        return FP12_ONE
    px = _embed_fp(p1[0])
    py = _embed_fp(p1[1])
    qx, qy = untwist(q2)
    tx, ty = qx, qy
    f = FP12_ONE
    for bit in _X_ABS_BITS[1:]:
        # tangent line at T evaluated at P
        lam = fp12_mul(
            fp12_mul(fp12_sq(tx), _embed_fp(3)),
            fp12_inv(fp12_mul(ty, _embed_fp(2))),
        )
        line = fp12_sub(fp12_sub(py, ty), fp12_mul(lam, fp12_sub(px, tx)))
        f = fp12_mul(fp12_sq(f), line)
        # T <- 2T
        x3 = fp12_sub(fp12_sq(lam), fp12_mul(tx, _embed_fp(2)))
        ty = fp12_sub(fp12_mul(lam, fp12_sub(tx, x3)), ty)
        tx = x3
        if bit == "1":
            # chord line through T and Q evaluated at P
            if tx == qx:
                raise ValueError("degenerate Miller addition step (T == +-Q)")
            lam = fp12_mul(fp12_sub(ty, qy), fp12_inv(fp12_sub(tx, qx)))
            line = fp12_sub(fp12_sub(py, qy), fp12_mul(lam, fp12_sub(px, qx)))
            f = fp12_mul(f, line)
            x3 = fp12_sub(fp12_sub(fp12_sq(lam), tx), qx)
            ty = fp12_sub(fp12_mul(lam, fp12_sub(tx, x3)), ty)
            tx = x3
    # x < 0: conjugate (the inverse up to factors the final exponentiation kills)
    return fp12_conj(f)


# --- projective Miller loop -------------------------------------------------
#
# T = (X, Y, Z) homogeneous on the twist E'(Fp2). Lines are returned as
# sparse coefficients (lA, lB, lC) meaning lA + lB·x_p·w^2 + lC·y_p·w^3 once
# evaluated at P = (x_p, y_p) in G1.


def proj_double_step(T):
    """(2T, tangent-line coefficients at T)."""
    X, Y, Z = T
    A = fp2_sq(X)
    B = fp2_sq(Y)
    C = fp2_sq(Z)
    D = fp2_mul(fp2_mul(X, B), Z)
    F = fp2_sub(fp2_mul_fp(fp2_sq(A), 9), fp2_mul_fp(D, 8))
    YZ = fp2_mul(Y, Z)
    X3 = fp2_mul(fp2_mul_fp(YZ, 2), F)
    Y3 = fp2_sub(
        fp2_mul(fp2_mul_fp(A, 3), fp2_sub(fp2_mul_fp(D, 4), F)),
        fp2_mul_fp(fp2_mul(fp2_sq(B), C), 8),
    )
    t = fp2_mul_fp(YZ, 2)
    Z3 = fp2_mul(fp2_sq(t), t)
    lA = fp2_sub(fp2_mul(X, A), fp2_mul_fp(fp2_mul_xi(fp2_mul(Z, C)), 8))
    lB = fp2_neg(fp2_mul_fp(fp2_mul(A, Z), 3))
    lC = fp2_mul_fp(fp2_mul(Y, C), 2)
    return (X3, Y3, Z3), (lA, lB, lC)


def proj_add_step(T, q):
    """(T + Q, chord-line coefficients), Q = (x2, y2) affine on the twist."""
    X, Y, Z = T
    x2, y2 = q
    theta = fp2_sub(Y, fp2_mul(y2, Z))
    lam = fp2_sub(X, fp2_mul(x2, Z))
    lam2 = fp2_sq(lam)
    lam3 = fp2_mul(lam2, lam)
    H = fp2_sub(
        fp2_mul(fp2_sq(theta), Z), fp2_mul(lam2, fp2_add(X, fp2_mul(x2, Z)))
    )
    X3 = fp2_mul(lam, H)
    Y3 = fp2_sub(fp2_mul(theta, fp2_sub(fp2_mul(lam2, X), H)), fp2_mul(lam3, Y))
    Z3 = fp2_mul(lam3, Z)
    lA = fp2_sub(fp2_mul(theta, x2), fp2_mul(lam, y2))
    lB = fp2_neg(theta)
    lC = lam
    return (X3, Y3, Z3), (lA, lB, lC)


def line_to_fp12(line, p1):
    """Evaluate sparse line coefficients at P and embed into Fp12:
    positions (w^0, w^2, w^3) -> Fp6 slots ((0,0), (0,1), (1,1))."""
    lA, lB, lC = line
    xp, yp = p1
    return (
        (lA, fp2_mul_fp(lB, xp), FP2_ZERO),
        (FP2_ZERO, fp2_mul_fp(lC, yp), FP2_ZERO),
    )


def miller_loop_projective(p1, q2):
    """f_{|x|,Q}(P) with the end conjugation for x < 0; 1 if either input
    is the identity (None)."""
    if p1 is None or q2 is None:
        return FP12_ONE
    T = (q2[0], q2[1], FP2_ONE)
    f = FP12_ONE
    for bit in _X_ABS_BITS[1:]:
        T, line = proj_double_step(T)
        f = fp12_mul(fp12_sq(f), line_to_fp12(line, p1))
        if bit == "1":
            T, line = proj_add_step(T, q2)
            f = fp12_mul(f, line_to_fp12(line, p1))
    return fp12_conj(f)


# --- final exponentiation ----------------------------------------------------

# Hard part: 3*(p^4 - p^2 + 1)/r = lam0 + lam1*p + lam2*p^2 + lam3*p^3
_LAM3 = (BLS_X - 1) ** 2
_LAM2 = _LAM3 * BLS_X
_LAM1 = _LAM3 * (BLS_X * BLS_X - 1)
_LAM0 = _LAM2 * (BLS_X * BLS_X - 1) + 3
assert _LAM0 + _LAM1 * P + _LAM2 * P**2 + _LAM3 * P**3 == 3 * (
    (P**4 - P**2 + 1) // R
)


def _cyc_pow(a, e):
    """a^e for `a` in the cyclotomic subgroup (so a^-1 == conj(a))."""
    if e < 0:
        return fp12_conj(_cyc_pow(a, -e))
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sq(base)
        e >>= 1
    return result


def final_exp(f):
    """f ** (3 * (p^12 - 1) / r)."""
    # easy part: f^((p^6 - 1)(p^2 + 1))
    m = fp12_mul(fp12_conj(f), fp12_inv(f))
    m = fp12_mul(fp12_frobenius2(m), m)
    # hard part via Frobenius multi-exp; m is now cyclotomic
    r0 = _cyc_pow(m, _LAM0)
    r1 = fp12_frobenius(_cyc_pow(m, _LAM1))
    r2 = fp12_frobenius2(_cyc_pow(m, _LAM2))
    r3 = fp12_frobenius(fp12_frobenius2(_cyc_pow(m, _LAM3)))
    return fp12_mul(fp12_mul(r0, r1), fp12_mul(r2, r3))


def final_exp_slow(f):
    """The direct power — the cross-check oracle of final_exp."""
    return fp12_pow(f, 3 * ((P**12 - 1) // R))


# The hard part also factors as an x-power chain (five exponentiations by
# the 64-bit |BLS_X| instead of four multi-hundred-bit exponents):
# 3·(p^4 - p^2 + 1)/r = (x-1)^2·(x+p)·(x^2 + p^2 - 1) + 3. Exact:
assert (BLS_X - 1) ** 2 * (BLS_X + P) * (BLS_X**2 + P**2 - 1) + 3 == 3 * (
    (P**4 - P**2 + 1) // R
)


def final_exp_chain(f):
    """final_exp by the x-power chain, the structure the device's final
    exponentiation follows; the same output as `final_exp`."""
    m = fp12_mul(fp12_conj(f), fp12_inv(f))
    m = fp12_mul(fp12_frobenius2(m), m)  # cyclotomic now
    # t0 = m^(x-1); t1 = t0^(x-1) = m^((x-1)^2)
    t0 = fp12_mul(_cyc_pow(m, BLS_X), fp12_conj(m))
    t1 = fp12_mul(_cyc_pow(t0, BLS_X), fp12_conj(t0))
    # t2 = t1^(x+p) = t1^x · pi(t1)
    t2 = fp12_mul(_cyc_pow(t1, BLS_X), fp12_frobenius(t1))
    # t3 = t2^(x^2 + p^2 - 1) = (t2^x)^x · pi^2(t2) · conj(t2)
    t3 = fp12_mul(
        fp12_mul(_cyc_pow(_cyc_pow(t2, BLS_X), BLS_X), fp12_frobenius2(t2)),
        fp12_conj(t2),
    )
    # · m^3
    return fp12_mul(t3, fp12_mul(fp12_sq(m), m))


# --- pairing API ---------------------------------------------------------------


def pairing(p1, q2):
    """e(P, Q) for P in G1, Q in G2."""
    return final_exp(miller_loop_projective(p1, q2))



def multi_pairing(pairs):
    """prod_i e(P_i, Q_i), (G1, G2) pairs, with one shared final
    exponentiation."""
    f = FP12_ONE
    for p1, q2 in pairs:
        f = fp12_mul(f, miller_loop_projective(p1, q2))
    return final_exp(f)


def pairing_check(pairs):
    """True iff prod_i e(P_i, Q_i) == 1."""
    return multi_pairing(pairs) == FP12_ONE
