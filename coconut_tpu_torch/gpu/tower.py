"""Extension-field tower Fp2/Fp6/Fp12 over the limb Fp — the port of
`coconut_tpu/tpu/tower.py`.

Same tower as the spec (u^2 = -1, v^3 = xi = u+1, w^2 = v) and the same
Karatsuba/complex formulas, so decoded results are bit-identical to it.
Elements are nested tuples of Fp limb tensors.

Every tower multiply bottoms out in ONE stacked base-field multiply
(`fp.mul_stack`): fp2_mul stacks its 3 Karatsuba products, fp6_mul its 6
fp2 products (18 base lanes), fp12_mul its 3 fp6 products (54 base lanes).
One Fp12 multiply is therefore a single kernel launch over [.., 54, 52],
which keeps the launches per verify batch in the thousands.
"""

import functools

import torch

from ..ops import fields as F
from . import fp
from .limbs import fp_decode_batch, fp_encode, fp_encode_batch, fp_encode_raw_batch

# --- nested-tuple helpers -----------------------------------------------------


def tree_map(f, *trees):
    """Apply f leafwise over nested tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(f, *parts) for parts in zip(*trees))
    return f(*trees)


def leaves(tree):
    """Leaves of a nested tuple, depth first (c0.c0.c0 first for Fp12)."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


# --- codecs (host <-> device) ----------------------------------------------------


def encode_batch(elems, device, dtype=None):
    """List of same-structure spec elements (ints / nested tuples) -> nested
    tuple of Montgomery limb tensors [n, 52] on `device`. `dtype` converts
    in numpy before the upload (int16 is the halved wire: balanced limbs
    are exact |v| <= 132)."""
    first = elems[0]
    if isinstance(first, tuple):
        return tuple(
            encode_batch([e[i] for e in elems], device, dtype=dtype)
            for i in range(len(first))
        )
    arr = fp_encode_batch(elems)
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(arr).to(device)


def encode_raw_batch(elems, device):
    """Raw-wire variant of encode_batch: uint8 [n, 48] canonical digits,
    NOT in the Montgomery domain (fp.to_mont converts on device)."""
    first = elems[0]
    if isinstance(first, tuple):
        return tuple(
            encode_raw_batch([e[i] for e in elems], device)
            for i in range(len(first))
        )
    return torch.from_numpy(fp_encode_raw_batch(elems).copy()).to(device)


def decode_batch(tree):
    """Inverse of encode_batch: nested limb tensors -> list of spec
    elements (canonical ints / nested tuples)."""
    if isinstance(tree, tuple):
        parts = [decode_batch(t) for t in tree]
        return [tuple(p[i] for p in parts) for i in range(len(parts[0]))]
    return fp_decode_batch(tree.detach().cpu().numpy())


# --- stack/unstack helpers ---------------------------------------------------


def _stack2(elems):
    """[(c0, c1), ...] fp2s -> stacked fp2 with a new [S] axis before limbs."""
    return (
        torch.stack(torch.broadcast_tensors(*[e[0] for e in elems]), dim=-2),
        torch.stack(torch.broadcast_tensors(*[e[1] for e in elems]), dim=-2),
    )


def _unstack2(t, n):
    return [(t[0][..., i, :], t[1][..., i, :]) for i in range(n)]


def _stack6(elems):
    """[(c0, c1, c2), ...] fp6s -> stacked fp6 (components are stacked fp2s)."""
    return tuple(_stack2([e[i] for e in elems]) for i in range(3))


def _unstack6(t, n):
    parts = [_unstack2(t[i], n) for i in range(3)]
    return [(parts[0][i], parts[1][i], parts[2][i]) for i in range(n)]


# --- Fp2 --------------------------------------------------------------------


def fp2_encode_const(c, device):
    """Spec Fp2 (int pair) -> Montgomery limb constant pair on `device`."""
    return (
        torch.from_numpy(fp_encode(c[0])).to(device),
        torch.from_numpy(fp_encode(c[1])).to(device),
    )


def fp2_add(a, b):
    return (fp.add(a[0], b[0]), fp.add(a[1], b[1]))


def fp2_sub(a, b):
    return (fp.sub(a[0], b[0]), fp.sub(a[1], b[1]))


def fp2_neg(a):
    return (fp.neg(a[0]), fp.neg(a[1]))


def fp2_mul(a, b):
    # Karatsuba: one stacked mul of [a0*b0, a1*b1, (a0+a1)(b0+b1)]
    t0, t1, t2 = fp.mul_stack(
        [a[0], a[1], fp.add(a[0], a[1])],
        [b[0], b[1], fp.add(b[0], b[1])],
    )
    return (fp.sub(t0, t1), fp.sub(fp.sub(t2, t0), t1))


def fp2_sq(a):
    # (a0+a1)(a0-a1), 2*a0*a1 — one stacked mul
    t0, t1 = fp.mul_stack(
        [fp.add(a[0], a[1]), a[0]],
        [fp.sub(a[0], a[1]), a[1]],
    )
    return (t0, fp.add(t1, t1))


def fp2_mul_fp(a, s):
    t0, t1 = fp.mul_stack([a[0], a[1]], [s, s])
    return (t0, t1)


def fp2_mul_small(a, k):
    return (fp.mul_small(a[0], k), fp.mul_small(a[1], k))


def fp2_conj(a):
    return (a[0], fp.neg(a[1]))


def fp2_mul_xi(a):
    """x (u+1): (c0 - c1, c0 + c1)."""
    return (fp.sub(a[0], a[1]), fp.add(a[0], a[1]))


def fp2_inv(a):
    s0, s1 = fp.mul_stack([a[0], a[1]], [a[0], a[1]])
    ninv = fp.inv(fp.add(s0, s1))
    t0, t1 = fp.mul_stack([a[0], a[1]], [ninv, ninv])
    return (t0, fp.neg(t1))


def fp2_is_zero(a):
    z0, z1 = fp.is_zero_many([a[0], a[1]])
    return z0 & z1


def fp2_eq(a, b):
    z0, z1 = fp.is_zero_many([fp.sub(a[0], b[0]), fp.sub(a[1], b[1])])
    return z0 & z1


def fp2_select(mask, a, b):
    return (fp.select(mask, a[0], b[0]), fp.select(mask, a[1], b[1]))


def fp2_zeros(shape, device):
    z = fp.zeros(shape, device)
    return (z, z)


def fp2_ones(shape, device):
    return (fp.ones_mont(shape, device), fp.zeros(shape, device))


# --- Fp6 --------------------------------------------------------------------


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    """Toom-style 6-product fp6 multiply, all products in ONE stacked
    fp2_mul (18 base lanes): t_i = a_i b_i, plus the three cross sums."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    prods = fp2_mul(
        _stack2(
            [a0, a1, a2, fp2_add(a1, a2), fp2_add(a0, a1), fp2_add(a0, a2)]
        ),
        _stack2(
            [b0, b1, b2, fp2_add(b1, b2), fp2_add(b0, b1), fp2_add(b0, b2)]
        ),
    )
    t0, t1, t2, t12, t01, t02 = _unstack2(prods, 6)
    c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_sub(t12, t1), t2)))
    c1 = fp2_add(fp2_sub(fp2_sub(t01, t0), t1), fp2_mul_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_sub(t02, t0), t2), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(a):
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    # six products in one stack: a0^2, a1*a2, a2^2, a0*a1, a1^2, a0*a2
    prods = fp2_mul(
        _stack2([a0, a1, a2, a0, a1, a0]), _stack2([a0, a2, a2, a1, a1, a2])
    )
    s00, s12, s22, s01, s11, s02 = _unstack2(prods, 6)
    c0 = fp2_sub(s00, fp2_mul_xi(s12))
    c1 = fp2_sub(fp2_mul_xi(s22), s01)
    c2 = fp2_sub(s11, s02)
    # t = xi*(a2 c1 + a1 c2) + a0 c0 — three products in one stack
    prods2 = fp2_mul(_stack2([a2, a1, a0]), _stack2([c1, c2, c0]))
    u1, u2, u0 = _unstack2(prods2, 3)
    t = fp2_add(fp2_mul_xi(fp2_add(u1, u2)), u0)
    tinv = fp2_inv(t)
    prods3 = fp2_mul(_stack2([c0, c1, c2]), _stack2([tinv, tinv, tinv]))
    r0, r1, r2 = _unstack2(prods3, 3)
    return (r0, r1, r2)


def fp6_zeros(shape, device):
    z = fp2_zeros(shape, device)
    return (z, z, z)


def fp6_ones(shape, device):
    return (fp2_ones(shape, device), fp2_zeros(shape, device), fp2_zeros(shape, device))


# --- Fp12 -------------------------------------------------------------------


def fp12_mul(a, b):
    """Karatsuba over w: 3 fp6 products in ONE stacked fp6_mul (54 base
    lanes, one kernel launch)."""
    a0, a1 = a
    b0, b1 = b
    prods = fp6_mul(
        _stack6([a0, a1, fp6_add(a0, a1)]),
        _stack6([b0, b1, fp6_add(b0, b1)]),
    )
    t0, t1, t2 = _unstack6(prods, 3)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(t2, t0), t1)
    return (c0, c1)


def fp12_sq(a):
    a0, a1 = a
    # t = a0*a1 and s = (a0+a1)(a0 + v*a1) in one stacked fp6_mul
    prods = fp6_mul(
        _stack6([a0, fp6_add(a0, a1)]),
        _stack6([a1, fp6_add(a0, fp6_mul_by_v(a1))]),
    )
    t, s = _unstack6(prods, 2)
    c0 = fp6_sub(fp6_sub(s, t), fp6_mul_by_v(t))
    c1 = fp6_add(t, t)
    return (c0, c1)


def fp12_cyclo_sq(a):
    """Granger–Scott cyclotomic squaring — valid ONLY for elements of the
    cyclotomic subgroup (everything after the easy part of the final
    exponentiation). The square decomposes into three Fp4 squarings over
    the pairs (c00,c11), (c10,c02), (c01,c12):

      fp4_sq(x, y) = (x^2 + xi y^2, 2xy)           [3 fp2 squarings]
      z0' = 3A0 - 2z0   z1' = 3B0 + 2z1            [A_i, B_i = fp4 parts]
      z4' = 3A1 - 2z4   z5' = 3B1 + 2z5
      z2' = 3 xi B2 + 2z2   z3' = 3A2 - 2z3

    18 base products + 12 compress muls (each input component times the
    encoded 1, which keeps the lazy class bounded over unbounded squaring
    chains) in ONE stacked multiply of 30 base lanes."""
    (c00, c01, c02), (c10, c11, c12) = a
    pairs = [(c00, c11), (c10, c02), (c01, c12)]
    lhs, rhs = [], []
    for x, y in pairs:
        for e in (x, y, fp2_add(x, y)):
            # fp2_sq(e) = ((e0+e1)(e0-e1), 2 e0 e1): two base products
            lhs += [fp.add(e[0], e[1]), e[0]]
            rhs += [fp.sub(e[0], e[1]), e[1]]
    one = fp.ones_mont((), c00[0].device)
    for comp in (c00, c11, c10, c02, c01, c12):
        lhs += [comp[0], comp[1]]
        rhs += [one, one]
    prods = fp.mul_stack(lhs, rhs)
    sq = []  # the 9 fp2 squares, pair-major
    for i in range(9):
        sq.append((prods[2 * i], fp.add(prods[2 * i + 1], prods[2 * i + 1])))
    cc = []  # compressed input components, in the order fed above
    for j in range(6):
        cc.append((prods[18 + 2 * j], prods[18 + 2 * j + 1]))
    z0c, z1c, z2c, z3c, z4c, z5c = cc  # (c00, c11, c10, c02, c01, c12)

    def fp4_parts(i):
        tx, ty, ts = sq[3 * i], sq[3 * i + 1], sq[3 * i + 2]
        A = fp2_add(tx, fp2_mul_xi(ty))
        B = fp2_sub(fp2_sub(ts, tx), ty)
        return A, B

    A0, B0 = fp4_parts(0)
    A1, B1 = fp4_parts(1)
    A2, B2 = fp4_parts(2)

    def t3m2(t, z):  # 3t - 2z
        return fp2_sub(fp2_mul_small(t, 3), fp2_mul_small(z, 2))

    def t3p2(t, z):  # 3t + 2z
        return fp2_add(fp2_mul_small(t, 3), fp2_mul_small(z, 2))

    z0p = t3m2(A0, z0c)
    z1p = t3p2(B0, z1c)
    z4p = t3m2(A1, z4c)
    z5p = t3p2(B1, z5c)
    z2p = t3p2(fp2_mul_xi(B2), z2c)
    z3p = t3m2(A2, z3c)
    return ((z0p, z4p, z3p), (z2p, z1p, z5p))


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    prods = fp6_mul(_stack6([a0, a1]), _stack6([a0, a1]))
    s0, s1 = _unstack6(prods, 2)
    t = fp6_sub(s0, fp6_mul_by_v(s1))
    tinv = fp6_inv(t)
    prods2 = fp6_mul(_stack6([a0, a1]), _stack6([tinv, tinv]))
    r0, r1 = _unstack6(prods2, 2)
    return (r0, fp6_neg(r1))


def mul_line(f, line):
    """f * (lA + lB w^2 + lC w^3) — the Miller-loop sparse product.

    The line element is s = (s0, s1) with s0 = (lA, lB, 0), s1 = (0, lC, 0).
    15 Fp2 products in ONE stacked mul: 6 for f0*(lA,lB), 3 for f1*lC, 6 for
    (f0+f1)*(lA, lB+lC)."""
    lA, lB, lC = line
    f0, f1 = f
    g = fp6_add(f0, f1)
    lBC = fp2_add(lB, lC)
    lhs = _stack2(
        [
            f0[0], f0[2], f0[1], f0[0], f0[2], f0[1],  # mul_by_01(f0, lA, lB)
            f1[2], f1[0], f1[1],                        # mul_by_1(f1, lC)
            g[0], g[2], g[1], g[0], g[2], g[1],         # mul_by_01(g, lA, lBC)
        ]
    )
    rhs = _stack2(
        [
            lA, lB, lA, lB, lA, lB,
            lC, lC, lC,
            lA, lBC, lA, lBC, lA, lBC,
        ]
    )
    p = _unstack2(fp2_mul(lhs, rhs), 15)
    # mul_by_01 structure: c0 = a0*s0 + xi*(a2*s1); c1 = a1*s0 + a0*s1;
    # c2 = a2*s0 + a1*s1 — regroup the products accordingly:
    t0 = (
        fp2_add(p[0], fp2_mul_xi(p[1])),
        fp2_add(p[2], p[3]),
        fp2_add(p[4], p[5]),
    )
    t1 = (fp2_mul_xi(p[6]), p[7], p[8])
    mixed = (
        fp2_add(p[9], fp2_mul_xi(p[10])),
        fp2_add(p[11], p[12]),
        fp2_add(p[13], p[14]),
    )
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(mixed, t0), t1)
    return (c0, c1)


@functools.lru_cache(maxsize=None)
def _frobenius_consts(device):
    """The spec's Frobenius coefficients as Montgomery constants on `device`."""
    return (
        [fp2_encode_const(c, device) for c in F._GAMMA1],
        [fp2_encode_const(c, device) for c in F._GAMMA2],
    )


def fp12_frobenius(a):
    a0, a1 = a
    g1c = _frobenius_consts(a0[0][0].device)[0]
    prods = fp2_mul(
        _stack2(
            [
                fp2_conj(a0[1]),
                fp2_conj(a0[2]),
                fp2_conj(a1[0]),
                fp2_conj(a1[1]),
                fp2_conj(a1[2]),
            ]
        ),
        _stack2([g1c[2], g1c[4], g1c[1], g1c[3], g1c[5]]),
    )
    m01, m02, m10, m11, m12 = _unstack2(prods, 5)
    return ((fp2_conj(a0[0]), m01, m02), (m10, m11, m12))


def fp12_frobenius2(a):
    a0, a1 = a
    g2c = _frobenius_consts(a0[0][0].device)[1]
    prods = fp2_mul(
        _stack2([a0[1], a0[2], a1[0], a1[1], a1[2]]),
        _stack2([g2c[2], g2c[4], g2c[1], g2c[3], g2c[5]]),
    )
    m01, m02, m10, m11, m12 = _unstack2(prods, 5)
    return ((a0[0], m01, m02), (m10, m11, m12))


def fp12_ones(shape, device):
    return (fp6_ones(shape, device), fp6_zeros(shape, device))


def fp12_select(mask, a, b):
    """mask [...] bool -> a where true else b, component by component."""
    return tree_map(lambda x, y: fp.select(mask, x, y), a, b)


def fp12_is_one(a):
    """Exact componentwise test against the Montgomery one, all 12
    compress-muls stacked into one multiply."""
    comps = leaves(a)  # 12 Fp components, c0.c0.c0 first
    one = fp.ones_mont(comps[0].shape[:-1], comps[0].device)
    zs = fp.is_zero_many([fp.sub(comps[0], one)] + comps[1:])
    bits = zs[0]
    for z in zs[1:]:
        bits = bits & z
    return bits
