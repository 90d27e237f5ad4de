"""Batched G1/G2 complete projective arithmetic, the shared-base comb MSM,
the distinct-base MSMs (the signed Horner schedule and the bucketed one),
the static scalar multiplication and the SvdW map of the hash to G1 — the
port of `coconut_tpu/tpu/curve.py`.

Point formulas are the Renes-Costello-Batina (2015) COMPLETE projective
addition/doubling for a = 0: valid for every pair of inputs including the
identity (0 : 1 : 0), with no branches or masks. Each formula's independent
field products are stacked into single multiplies (`fl.mul_many`): 12
products in 2 stacked multiplies per addition, 8 in 2 per doubling.

Each function takes `fl`, a field namespace (FP for G1, FP2 for the G2
twist), mirroring the spec's CurveOps being generic over the field. Points
are (X, Y, Z) tuples of field elements with leading batch dims.
"""

import functools

import torch

from ..ops.fields import P
from . import fp
from . import tower as tw
from .limbs import MONT_R, balanced_limbs
from .tower import tree_map


class _Fp2Field:
    """Adapter giving the tower's Fp2 the same surface as the fp module."""

    add = staticmethod(tw.fp2_add)
    sub = staticmethod(tw.fp2_sub)
    mul = staticmethod(tw.fp2_mul)
    sq = staticmethod(tw.fp2_sq)
    neg = staticmethod(tw.fp2_neg)
    inv = staticmethod(tw.fp2_inv)
    is_zero = staticmethod(tw.fp2_is_zero)
    eq = staticmethod(tw.fp2_eq)
    select = staticmethod(tw.fp2_select)
    zeros = staticmethod(tw.fp2_zeros)
    ones = staticmethod(tw.fp2_ones)
    mul_small = staticmethod(tw.fp2_mul_small)

    @staticmethod
    def mul_many(lhs, rhs):
        """Stack independent Fp2 products into one base-field multiply."""
        prods = tw.fp2_mul(tw._stack2(lhs), tw._stack2(rhs))
        return tw._unstack2(prods, len(lhs))

    @staticmethod
    def b3(t):
        # 3b' = 12(1+u): t*(1+u) is (c0-c1, c0+c1); then scale by 12
        return tw.fp2_mul_small(tw.fp2_mul_xi(t), 12)


class _FpField:
    add = staticmethod(fp.add)
    sub = staticmethod(fp.sub)
    mul = staticmethod(fp.mul)
    sq = staticmethod(fp.sq)
    neg = staticmethod(fp.neg)
    inv = staticmethod(fp.inv)
    is_zero = staticmethod(fp.is_zero)
    eq = staticmethod(fp.eq)
    select = staticmethod(fp.select)
    mul_small = staticmethod(fp.mul_small)
    mul_many = staticmethod(fp.mul_stack)
    zeros = staticmethod(fp.zeros)
    ones = staticmethod(fp.ones_mont)

    @staticmethod
    def b3(t):
        return fp.mul_small(t, 12)  # 3b = 12 (b = 4)


FP = _FpField
FP2 = _Fp2Field


def jinfinity(fl, shape, device):
    """The projective identity (0 : 1 : 0)."""
    return (fl.zeros(shape, device), fl.ones(shape, device), fl.zeros(shape, device))


def jadd(fl, p, q):
    """Complete projective addition (RCB 2015 Alg. 7, a = 0)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, m3, m4, m5 = fl.mul_many(
        [X1, Y1, Z1, fl.add(X1, Y1), fl.add(Y1, Z1), fl.add(X1, Z1)],
        [X2, Y2, Z2, fl.add(X2, Y2), fl.add(Y2, Z2), fl.add(X2, Z2)],
    )
    t3 = fl.sub(fl.sub(m3, t0), t1)  # X1Y2 + X2Y1
    t4 = fl.sub(fl.sub(m4, t1), t2)  # Y1Z2 + Y2Z1
    t5 = fl.sub(fl.sub(m5, t0), t2)  # X1Z2 + X2Z1
    b3t2 = fl.b3(t2)
    y3 = fl.b3(t5)
    t0_3 = fl.add(fl.add(t0, t0), t0)  # 3X1X2
    z3s = fl.add(t1, b3t2)
    t1m = fl.sub(t1, b3t2)
    x3a, t2c, y3b, t1d, t0e, z3f = fl.mul_many(
        [t4, t3, y3, t1m, t0_3, z3s],
        [y3, t1m, t0_3, z3s, t3, t4],
    )
    return (
        fl.sub(t2c, x3a),
        fl.add(t1d, y3b),
        fl.add(z3f, t0e),
    )


def jdouble(fl, p):
    """Complete projective doubling (RCB 2015 Alg. 9, a = 0)."""
    X, Y, Z = p
    a_, b_, c_, xy = fl.mul_many([Y, Y, Z, X], [Y, Z, Z, Y])
    cb = fl.b3(c_)
    e8 = fl.mul_small(a_, 8)
    y3s = fl.add(a_, cb)
    t0m = fl.sub(a_, fl.mul_small(cb, 3))
    x3p, z3, y2m, x3m = fl.mul_many([cb, b_, t0m, t0m], [e8, e8, y3s, xy])
    return (fl.add(x3m, x3m), fl.add(x3p, y2m), z3)


def to_affine(fl, p):
    """Projective -> (x, y, is_infinity mask), with one field inversion."""
    X, Y, Z = p
    zinv = fl.inv(Z)
    return fl.mul(X, zinv), fl.mul(Y, zinv), fl.is_zero(Z)


def affine_to_jacobian(fl, x, y, inf):
    """Affine points + identity mask -> projective (x : y : 1), or the
    identity (0 : 1 : 0) where `inf` is set."""
    one = fl.ones(inf.shape, inf.device)
    zero = fl.zeros(inf.shape, inf.device)
    return (
        fl.select(inf, zero, x),
        fl.select(inf, one, y),
        fl.select(inf, zero, one),
    )


def build_tables_device(fl, x, y, inf, entries=16):
    """Per-point projective multiples 0..entries-1 on the device, for the
    windowed MSMs. x, y: affine points [..., k]; inf: bool [..., k].
    Returns points with leaves [..., k, entries, L]. Entry 0 is the
    identity and entry i is jadd(entry i-1, P), the reference's order of
    adds, so the limbs match it exactly."""
    jac = affine_to_jacobian(fl, x, y, inf)
    rows = [jinfinity(fl, inf.shape, inf.device)]
    for _ in range(1, entries):
        rows.append(jadd(fl, rows[-1], jac))
    return tree_map(lambda *ts: torch.stack(ts, dim=inf.dim()), *rows)


def msm_distinct_signed(fl, x, y, inf, mag, sgn):
    """Signed 5-bit windowed MSM over per-row bases (each credential brings
    its own points, so the tables are built on the device).

    x, y, inf: affine points [..., k]; mag/sgn: signed window digits
    [..., k, nwin], msb first (digit = (-1)^sgn * mag, mag <= 16). Horner:
    per window 5 doublings, then one add per base in base order. Returns a
    projective accumulator with leading dims [...]."""
    tables = build_tables_device(fl, x, y, inf, entries=17)
    k = inf.shape[-1]
    idx = mag.long()[..., None]  # gather indices are long: uint8 would mask

    def leaf(t):  # [..., k, 17, L] -> [..., k, nwin, L]
        return torch.take_along_dim(t, idx, dim=-2)

    X, Y, Z = (tree_map(leaf, t) for t in tables)
    Y = fl.select(sgn, fl.neg(Y), Y)
    acc = jinfinity(fl, inf.shape[:-1], inf.device)
    for w in range(mag.shape[-1]):
        for _ in range(5):
            acc = jdouble(fl, acc)
        for j in range(k):
            acc = jadd(fl, acc, tree_map(lambda t: t[..., j, w, :], (X, Y, Z)))
    return acc


def fold_points(fl, pts, n, axis_offset=0, chunk=16):
    """Sum a nested tuple of n (power of two) points along its
    (axis_offset)-th leading axis with n-1 lane-adds: a running sum over
    chunk-size groups (one add at width n/chunk per step), then pairwise
    halving over the n/chunk partial sums. Same order of adds as the
    reference, so the projective results compare limb for limb."""
    assert n & (n - 1) == 0
    ax = axis_offset
    if n > chunk:
        g = n // chunk

        def split(t):
            s = t.shape
            return t.reshape(s[:ax] + (g, chunk) + s[ax + 1 :]).movedim(ax + 1, 0)

        xs = tree_map(split, pts)  # leaves [chunk, .. g ..]
        acc = tree_map(lambda t: t[0], xs)
        for i in range(1, chunk):
            acc = jadd(fl, acc, tree_map(lambda t: t[i], xs))
        pts = acc
        n = g
    while n > 1:
        half = n // 2
        lo = tree_map(lambda t: t.narrow(ax, 0, half), pts)
        hi = tree_map(lambda t: t.narrow(ax, half, half), pts)
        pts = jadd(fl, lo, hi)
        n = half
    return tree_map(lambda t: t.select(ax, 0), pts)


def fold_points_any(fl, pts, n, axis_offset=0):
    """Sum n points (ANY n >= 1) along the (axis_offset)-th leading axis:
    binary decomposition of n into power-of-two blocks, each folded by
    fold_points, partials chain-added."""
    ax = axis_offset
    if n == 1:
        return tree_map(lambda t: t.select(ax, 0), pts)
    acc = None
    off = 0
    for bit in range(n.bit_length() - 1, -1, -1):
        blk = 1 << bit
        if not n & blk:
            continue
        part = tree_map(lambda t: t.narrow(ax, off, blk), pts)
        folded = fold_points(fl, part, blk, axis_offset=ax)
        acc = folded if acc is None else jadd(fl, acc, folded)
        off += blk
    return acc


def build_comb_tables(fl, tables_e, nwin, window):
    """Fixed-base comb window tables for the shared-base MSM.

    tables_e: projective multiples 0..2^(window-1) with leading
    [k, 2^(window-1)+1] (entry 0 = identity). Returns leading
    [k, nwin, entries] where entry (j, w, d) = d * (2^window)^(nwin-1-w) *
    base_j, so the w-th msb-first signed digit's contribution is a pure
    table lookup and the MSM itself needs no doublings."""
    rows = [tables_e]  # row w (lsb first) = (2^window)^w * tables_e
    for _ in range(nwin - 1):
        nxt = rows[-1]
        for _ in range(window):
            nxt = jdouble(fl, nxt)
        rows.append(nxt)
    # [nwin (lsb first), k, E, L] -> msb first, then [k, nwin, E, L]
    return tree_map(lambda *ts: torch.stack(ts[::-1], dim=1), *rows)


def msm_shared_comb(fl, wtables, mag, sgn):
    """Fixed-base comb MSM over shared bases: gather one table entry per
    (credential, base, window) and fold — 0 doublings, k*nwin-1 lane-adds
    per credential, all at full [B] width.

    wtables: comb tables from build_comb_tables, leading [k, nwin, E];
    mag/sgn: signed window digits [B, k, nwin] (msb first, digit =
    (-1)^sgn * mag). Returns a projective accumulator with leading [B].

    Layout: the fold runs over a LEADING (k*nwin) axis with the batch in
    the trailing lane axis, as in the reference, so intermediates compare
    like with like."""
    B, k, nwin = mag.shape
    dev = mag.device
    jidx = torch.arange(k, device=dev)[:, None, None]
    widx = torch.arange(nwin, device=dev)[None, :, None]
    mag_t = mag.permute(1, 2, 0).long()  # [k, nwin, B]; gather indices are long
    sgn_t = sgn.permute(1, 2, 0)

    def leaf(t):  # [k, nwin, E, L] -> [k, nwin, B, L]
        return t[jidx, widx, mag_t]

    X, Y, Z = (tree_map(leaf, w) for w in wtables)
    Y = fl.select(sgn_t, fl.neg(Y), Y)
    flat = tree_map(lambda t: t.reshape((k * nwin, B) + t.shape[3:]), (X, Y, Z))
    return fold_points_any(fl, flat, k * nwin, axis_offset=0)


def msm_distinct_bucketed(fl, x, y, inf, mag, sgn, window):
    """Bucketed (Pippenger) distinct-base MSM: the table-free schedule for
    rows with many bases, where msm_distinct_signed's 17-entry table build
    (16 chained adds at [..., k] width) and its gathers dominate.

    x, y, inf: affine points [..., k]; mag/sgn: [..., k, nwin] signed
    `window`-bit digits, msb first, magnitudes <= nb = 2^(window-1). Horner
    over the windows: per window `window` doublings, then each of the k
    points is scattered into its digit's bucket (gather the bucket, one
    complete add at batch width, one-hot writeback) in base order, then the
    nb buckets fold by the running-sum trick (sum_b b * bucket_b in 2nb
    adds, top bucket first) and one add joins the total. A zero digit
    scatters nothing (its one-hot row is all false). The order of adds is
    the reference's, so the projective limbs compare with it. Returns a
    projective accumulator with leading dims [...]."""
    nb = 1 << (window - 1)
    bshape = inf.shape[:-1]
    bdim = len(bshape)
    dev = inf.device
    jac = affine_to_jacobian(fl, x, y, inf)  # leaves [..., k, L]
    slots = torch.arange(nb, device=dev)
    acc = jinfinity(fl, bshape, dev)
    for w in range(mag.shape[-1]):
        for _ in range(window):
            acc = jdouble(fl, acc)
        buckets = jinfinity(fl, bshape + (nb,), dev)
        for j in range(inf.shape[-1]):
            d = mag[..., j, w].long()
            px, py, pz = tree_map(lambda t: t.select(bdim, j), jac)
            pj = (px, fl.select(sgn[..., j, w], fl.neg(py), py), pz)
            idx = (d - 1).clamp(min=0)[..., None, None]  # d = 0 is masked below
            cur = tree_map(
                lambda t: torch.take_along_dim(t, idx, dim=bdim).squeeze(bdim), buckets
            )
            new = jadd(fl, cur, pj)
            onehot = ((slots == idx[..., 0]) & (d[..., None] > 0))[..., None]
            buckets = tree_map(
                lambda bt, nt: torch.where(onehot, nt.unsqueeze(bdim), bt), buckets, new
            )
        run = jinfinity(fl, bshape, dev)
        tot = jinfinity(fl, bshape, dev)
        for b in range(nb - 1, -1, -1):
            run = jadd(fl, run, tree_map(lambda t: t.select(bdim, b), buckets))
            tot = jadd(fl, tot, run)
        acc = jadd(fl, acc, tot)
    return acc


def scalar_mul_static(fl, pt, k, window=4):
    """Projective point times a static positive int: fp.pow_static's
    structure over the curve. The multiples 0..2^window-1 come from chained
    complete adds from the identity; each msb-first window is `window`
    doublings and one add of its multiple (the identity for a zero digit,
    added like any other, as the reference's scan does). The complete
    formulas hold on the whole curve: the cofactor clear of the hash to G1
    (126 bits, 32 windows) runs on points outside the r-torsion, so it
    never goes through GLV."""
    assert k > 0
    lead = tw.leaves(pt)[0]
    shape, dev = lead.shape[:-1], lead.device
    nw = (k.bit_length() + window - 1) // window
    digits = [(k >> (window * i)) & ((1 << window) - 1) for i in range(nw - 1, -1, -1)]
    rows = [jinfinity(fl, shape, dev)]
    for _ in range(1, 1 << window):
        rows.append(jadd(fl, rows[-1], pt))
    acc = jinfinity(fl, shape, dev)
    for d in digits:
        for _ in range(window):
            acc = jdouble(fl, acc)
        acc = jadd(fl, acc, rows[d])
    return acc


# --- SvdW map (the device half of hash_to_g1) --------------------------------


@functools.lru_cache(maxsize=None)
def _svdw_mont(device):
    """The SvdW constants of the Fp map (ops/hashing._SVDW_FP: Z, c1..c4)
    and the curve's b = 4, as Montgomery limb vectors on `device`."""
    from ..ops.hashing import _SVDW_FP

    def enc(v):
        return torch.from_numpy(balanced_limbs(v * MONT_R % P)).to(device)

    return tuple(enc(v) for v in _SVDW_FP + (4,))


def svdw_map_fp(u, u_par):
    """Batched SvdW straight-line map to the curve over Fp, bit-identical to
    the spec (ops/hashing._map_to_curve_svdw over _FpAdapter). u [..., L]:
    field elements in Montgomery limbs; u_par [...] bool: sgn0(u), known on
    the host (u is the expand_message_xmd output). Returns affine (x, y).
    The map never outputs the identity.

    Fixed op count, branchless selects. The three candidates' square
    roots run as ONE stacked pow_static over a [..., 3] axis; the inverse
    of tv1 * tv2 maps 0 to 0 (fp.inv), as the spec's inv0 does. sgn0(y) is
    taken on from_mont(y), the standard-domain value."""
    Z, c1, c2, c3, c4, b4 = _svdw_mont(u.device)
    one = fp.ones_mont(u.shape[:-1], u.device)
    tv1 = fp.mul(fp.sq(u), c1)
    tv2 = fp.add(one, tv1)
    tv1m = fp.sub(one, tv1)
    tv3 = fp.inv(fp.mul(tv1m, tv2))
    tv4 = fp.mul(fp.mul(fp.mul(u, tv1m), tv3), c3)
    x1 = fp.sub(c2, tv4)
    x2 = fp.add(c2, tv4)
    t5 = fp.mul(fp.sq(tv2), tv3)
    x3 = fp.add(fp.mul(fp.sq(t5), c4), Z)
    xs = torch.stack(torch.broadcast_tensors(x1, x2, x3), dim=-2)  # [..., 3, L]
    gxs = fp.add(fp.mul(fp.sq(xs), xs), b4)  # g(x) = x^3 + 4
    ss = fp.pow_static(gxs, (P + 1) // 4)  # the candidate square roots
    # gx is a square iff s^2 == gx (P = 3 mod 4): the spec's test
    ok = fp.is_zero(fp.sub(fp.sq(ss), gxs))  # [..., 3]
    ok1, ok2 = ok[..., 0], ok[..., 1]
    x = fp.select(ok1, xs[..., 0, :], fp.select(ok2, xs[..., 1, :], xs[..., 2, :]))
    y = fp.select(ok1, ss[..., 0, :], fp.select(ok2, ss[..., 1, :], ss[..., 2, :]))
    flip = fp.canon_parity(fp.from_mont(y)) != u_par
    return x, fp.select(flip, fp.neg(y), y)
