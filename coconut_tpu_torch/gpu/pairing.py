"""Batched optimal-ate pairing — the port of `coconut_tpu/tpu/pairing.py`:
the generic pair-set Miller loop (`multi_miller_loop`, run by the combined
verify programs on a [B+1, 1] pair set, and `pairing_product_is_one`),
the two-pair Miller loop with a shared twist point of the exact verify
programs, and the final exponentiation.

Same homogeneous twist coordinates, line coefficients and x-power chain as
the spec (`ops.pairing.miller_loop_projective` / `final_exp_chain`), so
post-final-exp GT values decode bit-identical to it.

`lax.scan`s of the reference become Python loops over the static bit
schedule of |BLS_X|.
"""

from ..ops.fields import BLS_X
from . import tower as tw

# Static bit schedule of |BLS_X|, msb first, leading bit dropped.
_XBITS = [int(b) for b in bin(-BLS_X)[2:]][1:]

# Segment decomposition of the same schedule for the Miller loop: runs of
# pure doubling steps between the set bits, then the 5 double+add steps.
# _SEG_ZEROS[i] = number of pure-double steps before the i-th set bit;
# _TRAILING = pure-double steps after the last set bit.
_SEG_ZEROS, _TRAILING = [], 0
for _b in _XBITS:
    if _b:
        _SEG_ZEROS.append(_TRAILING)
        _TRAILING = 0
    else:
        _TRAILING += 1


def _proj_double_step(T):
    """Mirror of ops.pairing.proj_double_step on Fp2 limb tensors."""
    X, Y, Z = T
    A = tw.fp2_sq(X)
    B = tw.fp2_sq(Y)
    C = tw.fp2_sq(Z)
    D = tw.fp2_mul(tw.fp2_mul(X, B), Z)
    F = tw.fp2_sub(tw.fp2_mul_small(tw.fp2_sq(A), 9), tw.fp2_mul_small(D, 8))
    YZ = tw.fp2_mul(Y, Z)
    X3 = tw.fp2_mul(tw.fp2_mul_small(YZ, 2), F)
    Y3 = tw.fp2_sub(
        tw.fp2_mul(tw.fp2_mul_small(A, 3), tw.fp2_sub(tw.fp2_mul_small(D, 4), F)),
        tw.fp2_mul_small(tw.fp2_mul(tw.fp2_sq(B), C), 8),
    )
    t = tw.fp2_mul_small(YZ, 2)
    Z3 = tw.fp2_mul(tw.fp2_sq(t), t)
    lA = tw.fp2_sub(
        tw.fp2_mul(X, A), tw.fp2_mul_small(tw.fp2_mul_xi(tw.fp2_mul(Z, C)), 8)
    )
    lB = tw.fp2_neg(tw.fp2_mul_small(tw.fp2_mul(A, Z), 3))
    lC = tw.fp2_mul_small(tw.fp2_mul(Y, C), 2)
    return (X3, Y3, Z3), (lA, lB, lC)


def _proj_add_step(T, q):
    """Mirror of ops.pairing.proj_add_step; q = (x2, y2) affine twist."""
    X, Y, Z = T
    x2, y2 = q
    theta = tw.fp2_sub(Y, tw.fp2_mul(y2, Z))
    lam = tw.fp2_sub(X, tw.fp2_mul(x2, Z))
    lam2 = tw.fp2_sq(lam)
    lam3 = tw.fp2_mul(lam2, lam)
    H = tw.fp2_sub(
        tw.fp2_mul(tw.fp2_sq(theta), Z),
        tw.fp2_mul(lam2, tw.fp2_add(X, tw.fp2_mul(x2, Z))),
    )
    X3 = tw.fp2_mul(lam, H)
    Y3 = tw.fp2_sub(
        tw.fp2_mul(theta, tw.fp2_sub(tw.fp2_mul(lam2, X), H)),
        tw.fp2_mul(lam3, Y),
    )
    Z3 = tw.fp2_mul(lam3, Z)
    lA = tw.fp2_sub(tw.fp2_mul(theta, x2), tw.fp2_mul(lam, y2))
    lB = tw.fp2_neg(theta)
    lC = lam
    return (X3, Y3, Z3), (lA, lB, lC)


def _eval_line(line, px, py):
    """(lA, lB, lC) -> (lA, lB*px, lC*py): the sparse element for mul_line."""
    lA, lB, lC = line
    return (lA, tw.fp2_mul_fp(lB, px), tw.fp2_mul_fp(lC, py))


def multi_miller_loop(px, py, qx, qy, valid):
    """Product of Miller loops over the trailing "pairs" axis of the leading
    dims: px, py Fp limb tensors [..., npairs]; qx, qy affine twist points
    as Fp2 pairs of the same leading dims; valid bool [..., npairs].
    Returns an Fp12 element with leading dims [...] (the pairs folded by
    fp12_mul in pair order).

    Pad-lane contract (as the reference's): a lane with valid=False
    contributes exactly the GT identity, whatever its coordinates, so an
    all-pad pair set folds to one and pad lanes change no product,
    wherever they sit. As in the reference's code, the identity is
    selected once after the loop (no per-line masks)."""
    shape, dev = valid.shape, valid.device
    T = (qx, qy, tw.fp2_ones(shape, dev))
    f = tw.fp12_ones(shape, dev)

    def dbl(f, T):
        T, line = _proj_double_step(T)
        return tw.mul_line(tw.fp12_sq(f), _eval_line(line, px, py)), T

    for nz in _SEG_ZEROS:
        for _ in range(nz):
            f, T = dbl(f, T)
        f, T = dbl(f, T)
        T, la = _proj_add_step(T, (qx, qy))
        f = tw.mul_line(f, _eval_line(la, px, py))
    for _ in range(_TRAILING):
        f, T = dbl(f, T)
    f = tw.fp12_conj(f)  # x < 0
    f = tw.fp12_select(valid, f, tw.fp12_ones(shape, dev))
    out = _index_fp12(f, 0)
    for i in range(1, shape[-1]):
        out = tw.fp12_mul(out, _index_fp12(f, i))
    return out


def _index_fp12(f, i):
    return tw.tree_map(lambda t: t[..., i, :], f)


def _mask_line(line, valid):
    """Select the identity line (1, 0, 0) on invalid lanes so a dead pair
    contributes the factor 1 to the merged accumulator at every step."""
    lA, lB, lC = line
    one = tw.fp2_ones(valid.shape, valid.device)
    zero = tw.fp2_zeros(valid.shape, valid.device)
    return (
        tw.fp2_select(valid, lA, one),
        tw.fp2_select(valid, lB, zero),
        tw.fp2_select(valid, lC, zero),
    )


def miller_two_pairs_shared_q2(
    px1, py1, qx1, qy1, valid1, px2, py2, q2x, q2y, valid2
):
    """Miller product of exactly two pairs per credential with pair 2's
    TWIST point shared across the batch — the verify shape
    e(sigma_1_i, acc_i) * e(-sigma_2_i, g_tilde) in the G1 assignment.

    The fp12 accumulator is [B]-shaped (both pairs' lines multiplied in per
    step), and pair 2's T-ladder and line coefficients run once at scalar
    shape (g_tilde is one point), broadcast against [B] only in the two
    line evaluations. Dead pairs contribute the factor 1 via _mask_line."""
    shape, dev = valid1.shape, valid1.device
    T1 = (qx1, qy1, tw.fp2_ones(shape, dev))
    T2 = (q2x, q2y, tw.fp2_ones((), dev))
    f = tw.fp12_ones(shape, dev)

    def fuse(f, l1, l2):
        f = tw.mul_line(f, _mask_line(_eval_line(l1, px1, py1), valid1))
        return tw.mul_line(f, _mask_line(_eval_line(l2, px2, py2), valid2))

    def dbl(f, T1, T2):
        T1, l1 = _proj_double_step(T1)
        T2, l2 = _proj_double_step(T2)
        return fuse(tw.fp12_sq(f), l1, l2), T1, T2

    for nz in _SEG_ZEROS:
        for _ in range(nz):
            f, T1, T2 = dbl(f, T1, T2)
        f, T1, T2 = dbl(f, T1, T2)
        T1, l1 = _proj_add_step(T1, (qx1, qy1))
        T2, l2 = _proj_add_step(T2, (q2x, q2y))
        f = fuse(f, l1, l2)
    for _ in range(_TRAILING):
        f, T1, T2 = dbl(f, T1, T2)
    return tw.fp12_conj(f)  # x < 0


def _pow_x_abs(m):
    """m^{|BLS_X|} in the cyclotomic subgroup: Granger-Scott squarings
    over the static bits, one multiply per set bit. The reference computes
    the multiply on every bit and selects it away on zero bits; skipping
    it gives the same accumulator, limb for limb."""
    acc = m  # the leading bit folds in via init = m
    for bit in _XBITS:
        acc = tw.fp12_cyclo_sq(acc)
        if bit:
            acc = tw.fp12_mul(acc, m)
    return acc


def _pow_x_neg(m):
    """m^{BLS_X} (x negative): conj of m^{|x|}."""
    return tw.fp12_conj(_pow_x_abs(m))


def final_exp(f):
    """Mirror of ops.pairing.final_exp_chain (identical GT values)."""
    m = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    m = tw.fp12_mul(tw.fp12_frobenius2(m), m)
    t0 = tw.fp12_mul(_pow_x_neg(m), tw.fp12_conj(m))
    t1 = tw.fp12_mul(_pow_x_neg(t0), tw.fp12_conj(t0))
    t2 = tw.fp12_mul(_pow_x_neg(t1), tw.fp12_frobenius(t1))
    t3 = tw.fp12_mul(
        tw.fp12_mul(_pow_x_neg(_pow_x_neg(t2)), tw.fp12_frobenius2(t2)),
        tw.fp12_conj(t2),
    )
    return tw.fp12_mul(t3, tw.fp12_mul(tw.fp12_cyclo_sq(m), m))


def pairing_product_is_one(px, py, qx, qy, valid):
    """[..., npairs] pair sets -> bool [...]: prod e(P_i, Q_i) == 1. Pad
    pairs (valid=False) are identity factors, so an all-pad set answers
    True."""
    return tw.fp12_is_one(final_exp(multi_miller_loop(px, py, qx, qy, valid)))
