"""Hashing to fields and groups — the port's host copy of the JAX package's
hashing spec ("CTH-v2", `coconut_tpu/ops/hashing.py`):

  - expand_message_xmd with SHA-256 (RFC 9380 §5.3.1);
  - hash_to_fr / _hash_to_fp / _hash_to_fp2: 64 uniform bytes a field
    element, reduced mod r / mod p;
  - hash_to_g1 / hash_to_g2: the Shallue-van de Woestijne straight-line
    map (RFC 9380 §6.6.1), P = clear_cofactor(map(u0) + map(u1)). Every
    step has a fixed operation count (three x-candidates, branchless
    selects), which is what lets the device run the G1 map batched
    (gpu/curve.svdw_map_fp). The SvdW constants (Z, c1..c4) are derived
    at import from the curve equation alone.

The Fiat-Shamir challenges are hash_to_fr of a proof transcript; the
issuance request's generator h and the label-derived `Params.new` hash to
the signature group.
"""

import hashlib

from .curve import G1_COFACTOR, G2_COFACTOR, g1, g2
from .fields import (
    P,
    R,
    fp2_add,
    fp2_inv,
    fp2_mul,
    fp2_neg,
    fp2_sgn0,
    fp2_sq,
    fp2_sqrt,
    fp2_sub,
    fp_sgn0,
    fp_sqrt,
)

_HASH = hashlib.sha256
_B_IN_BYTES = 32
_R_IN_BYTES = 64

DST_FR = b"COCONUT-TPU-V2-FR"
DST_G1 = b"COCONUT-TPU-V2-G1"
DST_G2 = b"COCONUT-TPU-V2-G2"


def expand_message_xmd(msg, dst, len_in_bytes):
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        raise ValueError("DST longer than 255 bytes")
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("requested too many bytes")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = _HASH(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = _HASH(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        blocks.append(_HASH(xored + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_fr(msg, dst=DST_FR):
    """Arbitrary bytes -> a scalar in Fr."""
    u = expand_message_xmd(msg, dst, 64)
    return int.from_bytes(u, "big") % R


def _hash_to_fp(msg, dst):
    u = expand_message_xmd(msg, dst, 64)
    return int.from_bytes(u, "big") % P


def _hash_to_fp2(msg, dst):
    u = expand_message_xmd(msg, dst, 128)
    return (
        int.from_bytes(u[:64], "big") % P,
        int.from_bytes(u[64:], "big") % P,
    )


# --- Shallue-van de Woestijne map -------------------------------------------
#
# Generic over a field adapter; instantiated for Fp (G1) and Fp2 (G2). The
# constants follow the RFC 9380 §6.6.1 recipe for y^2 = x^3 + B (A = 0):
#   Z: first candidate (1, -1, 2, -2, ...) with g(Z) != 0,
#      -(3Z^2)/(4 g(Z)) a nonzero square, and g(Z) or g(-Z/2) square;
#   c1 = g(Z); c2 = -Z/2; c3 = sqrt(-g(Z) 3Z^2) with sgn0(c3) == 0;
#   c4 = -4 g(Z) / (3Z^2).


class _FpAdapter:
    B = 4

    @staticmethod
    def embed(k):
        return k % P

    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sq = staticmethod(lambda a: a * a % P)
    neg = staticmethod(lambda a: -a % P)
    sqrt = staticmethod(fp_sqrt)
    sgn0 = staticmethod(fp_sgn0)

    @staticmethod
    def inv0(a):
        return pow(a, P - 2, P)

    @staticmethod
    def is_zero(a):
        return a == 0


class _Fp2Adapter:
    B = (4, 4)

    @staticmethod
    def embed(k):
        return (k % P, 0)

    add = staticmethod(fp2_add)
    sub = staticmethod(fp2_sub)
    mul = staticmethod(fp2_mul)
    sq = staticmethod(fp2_sq)
    neg = staticmethod(fp2_neg)
    sqrt = staticmethod(fp2_sqrt)
    sgn0 = staticmethod(fp2_sgn0)

    @staticmethod
    def inv0(a):
        return (0, 0) if a == (0, 0) else fp2_inv(a)

    @staticmethod
    def is_zero(a):
        return a == (0, 0)


def _svdw_constants(F):
    def g(x):
        return F.add(F.mul(F.sq(x), x), F.B)

    def is_square(a):
        return F.sqrt(a) is not None

    half = F.inv0(F.embed(2))
    for k in range(1, 65):
        for Z in (F.embed(k), F.embed(-k)):
            gZ = g(Z)
            if F.is_zero(gZ):
                continue
            h = F.mul(F.embed(3), F.sq(Z))  # 3Z^2 (+ 4A, A = 0)
            if F.is_zero(h):
                continue
            t = F.neg(F.mul(h, F.inv0(F.mul(F.embed(4), gZ))))
            if F.is_zero(t) or not is_square(t):
                continue
            if not (is_square(gZ) or is_square(g(F.mul(F.neg(Z), half)))):
                continue
            c1 = gZ
            c2 = F.mul(F.neg(Z), half)
            c3 = F.sqrt(F.neg(F.mul(gZ, h)))
            if F.sgn0(c3) == 1:
                c3 = F.neg(c3)
            c4 = F.mul(F.neg(F.mul(F.embed(4), gZ)), F.inv0(h))
            return Z, c1, c2, c3, c4
    raise AssertionError("no SvdW Z found")  # unreachable for BLS12-381


_SVDW_FP = _svdw_constants(_FpAdapter)
_SVDW_FP2 = _svdw_constants(_Fp2Adapter)


def _map_to_curve_svdw(F, consts, u):
    """RFC 9380 §6.6.1 straight-line SvdW map: field element -> curve point
    (full curve, not yet in the r-torsion subgroup). Fixed op count."""
    Z, c1, c2, c3, c4 = consts
    one = F.embed(1)
    tv1 = F.mul(F.sq(u), c1)
    tv2 = F.add(one, tv1)
    tv1 = F.sub(one, tv1)
    tv3 = F.inv0(F.mul(tv1, tv2))
    tv4 = F.mul(F.mul(F.mul(u, tv1), tv3), c3)
    x1 = F.sub(c2, tv4)
    x2 = F.add(c2, tv4)
    x3 = F.add(F.mul(F.sq(F.mul(F.sq(tv2), tv3)), c4), Z)

    def g(x):
        return F.add(F.mul(F.sq(x), x), F.B)

    gx1, gx2 = g(x1), g(x2)
    if F.sqrt(gx1) is not None:
        x, gx = x1, gx1
    elif F.sqrt(gx2) is not None:
        x, gx = x2, gx2
    else:
        x, gx = x3, g(x3)
    y = F.sqrt(gx)
    if F.sgn0(y) != F.sgn0(u):
        y = F.neg(y)
    return (x, y)


def hash_to_g1(msg, dst=DST_G1):
    """Deterministic hash to G1: clear_cofactor(svdw(u0) + svdw(u1))."""
    u = expand_message_xmd(msg, dst, 128)
    u0 = int.from_bytes(u[:64], "big") % P
    u1 = int.from_bytes(u[64:], "big") % P
    q = g1.add(
        _map_to_curve_svdw(_FpAdapter, _SVDW_FP, u0),
        _map_to_curve_svdw(_FpAdapter, _SVDW_FP, u1),
    )
    pt = g1.mul(q, G1_COFACTOR)
    if pt is None:
        raise ValueError("hash_to_g1 hit the identity (probability ~2^-255)")
    return pt


def hash_to_g2(msg, dst=DST_G2):
    """Deterministic hash to G2: clear_cofactor(svdw(u0) + svdw(u1))."""
    u = expand_message_xmd(msg, dst, 256)
    u0 = (int.from_bytes(u[:64], "big") % P, int.from_bytes(u[64:128], "big") % P)
    u1 = (
        int.from_bytes(u[128:192], "big") % P,
        int.from_bytes(u[192:], "big") % P,
    )
    q = g2.add(
        _map_to_curve_svdw(_Fp2Adapter, _SVDW_FP2, u0),
        _map_to_curve_svdw(_Fp2Adapter, _SVDW_FP2, u1),
    )
    pt = g2.mul(q, G2_COFACTOR)
    if pt is None:
        raise ValueError("hash_to_g2 hit the identity (probability ~2^-255)")
    return pt
