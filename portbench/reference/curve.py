"""BLS12-381 group arithmetic on Python ints, frozen for the benchmark's
plain reference and its fixtures: point add, double, negation, scalar
multiplication and MSM for G1 (over Fp) and G2 (over Fp2), the standard
generators and the cofactors.

Points are affine tuples `(x, y)` with `None` as the point at infinity;
internally the ops use Jacobian coordinates (X, Y, Z), Z == 0 for infinity.
"""

from .fields import (
    R,
    fp_add,
    fp_inv,
    fp_mul,
    fp_neg,
    fp_sq,
    fp_sub,
    fp2_add,
    fp2_inv,
    fp2_mul,
    fp2_neg,
    fp2_sq,
    fp2_sub,
    FP2_ONE,
    FP2_ZERO,
)

G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

B_G1 = 4  # E:  y^2 = x^3 + 4
B_G2 = (4, 4)  # E': y^2 = x^3 + 4(u+1)

# Standard generators (same as the BLS12-381 spec / zkcrypto / blst).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


class CurveOps:
    """Short-Weierstrass Jacobian arithmetic generic over the coordinate field."""

    def __init__(self, f_add, f_sub, f_mul, f_sq, f_neg, f_inv, zero, one, b):
        self.f_add = f_add
        self.f_sub = f_sub
        self.f_mul = f_mul
        self.f_sq = f_sq
        self.f_neg = f_neg
        self.f_inv = f_inv
        self.zero = zero
        self.one = one
        self.b = b

    # -- affine <-> jacobian

    def to_jacobian(self, p):
        if p is None:
            return (self.one, self.one, self.zero)
        return (p[0], p[1], self.one)

    def to_affine(self, j):
        X, Y, Z = j
        if Z == self.zero:
            return None
        zinv = self.f_inv(Z)
        zinv2 = self.f_sq(zinv)
        return (self.f_mul(X, zinv2), self.f_mul(Y, self.f_mul(zinv2, zinv)))

    # -- jacobian ops

    def jdouble(self, j):
        X, Y, Z = j
        if Z == self.zero or Y == self.zero:
            return (self.one, self.one, self.zero)
        A = self.f_sq(X)
        B = self.f_sq(Y)
        C = self.f_sq(B)
        # D = 2*((X+B)^2 - A - C)
        D = self.f_sub(self.f_sub(self.f_sq(self.f_add(X, B)), A), C)
        D = self.f_add(D, D)
        E = self.f_add(self.f_add(A, A), A)
        F = self.f_sq(E)
        X3 = self.f_sub(F, self.f_add(D, D))
        C8 = self.f_add(C, C)
        C8 = self.f_add(C8, C8)
        C8 = self.f_add(C8, C8)
        Y3 = self.f_sub(self.f_mul(E, self.f_sub(D, X3)), C8)
        Z3 = self.f_mul(self.f_add(Y, Y), Z)
        return (X3, Y3, Z3)

    def jadd(self, j1, j2):
        X1, Y1, Z1 = j1
        X2, Y2, Z2 = j2
        if Z1 == self.zero:
            return j2
        if Z2 == self.zero:
            return j1
        Z1Z1 = self.f_sq(Z1)
        Z2Z2 = self.f_sq(Z2)
        U1 = self.f_mul(X1, Z2Z2)
        U2 = self.f_mul(X2, Z1Z1)
        S1 = self.f_mul(Y1, self.f_mul(Z2, Z2Z2))
        S2 = self.f_mul(Y2, self.f_mul(Z1, Z1Z1))
        if U1 == U2:
            if S1 == S2:
                return self.jdouble(j1)
            return (self.one, self.one, self.zero)
        H = self.f_sub(U2, U1)
        I = self.f_sq(self.f_add(H, H))
        J = self.f_mul(H, I)
        rr = self.f_sub(S2, S1)
        rr = self.f_add(rr, rr)
        V = self.f_mul(U1, I)
        X3 = self.f_sub(self.f_sub(self.f_sq(rr), J), self.f_add(V, V))
        S1J = self.f_mul(S1, J)
        Y3 = self.f_sub(self.f_mul(rr, self.f_sub(V, X3)), self.f_add(S1J, S1J))
        Z3 = self.f_mul(self.f_mul(Z1, Z2), H)
        Z3 = self.f_add(Z3, Z3)  # account for I = (2H)^2 convention
        return (X3, Y3, Z3)

    # -- affine API

    def add(self, p, q):
        return self.to_affine(self.jadd(self.to_jacobian(p), self.to_jacobian(q)))

    def double(self, p):
        return self.to_affine(self.jdouble(self.to_jacobian(p)))

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.f_neg(p[1]))

    def sub(self, p, q):
        return self.add(p, self.neg(q))

    def mul(self, p, k):
        """Scalar multiplication k*p (k any int)."""
        if p is None or k == 0:
            return None
        if k < 0:
            return self.mul(self.neg(p), -k)
        acc = (self.one, self.one, self.zero)
        base = self.to_jacobian(p)
        for bit in bin(k)[2:]:
            acc = self.jdouble(acc)
            if bit == "1":
                acc = self.jadd(acc, base)
        return self.to_affine(acc)

    def msm(self, points, scalars):
        """sum_i scalars[i] * points[i]: 4-bit windowed Straus over all
        points at once, scalars reduced mod r."""
        if len(points) != len(scalars):
            raise ValueError(
                "bases/exponents length mismatch: %d vs %d"
                % (len(points), len(scalars))
            )
        acc = (self.one, self.one, self.zero)
        js = [self.to_jacobian(pt) for pt in points]
        # tables [0..15]*p
        tables = []
        for j in js:
            tbl = [(self.one, self.one, self.zero)]
            for _ in range(15):
                tbl.append(self.jadd(tbl[-1], j))
            tables.append(tbl)
        ks = [k % R for k in scalars]
        nbits = max((k.bit_length() for k in ks), default=0)
        nwin = (nbits + 3) // 4
        for w in range(nwin - 1, -1, -1):
            for _ in range(4):
                acc = self.jdouble(acc)
            for tbl, k in zip(tables, ks):
                d = (k >> (4 * w)) & 0xF
                if d:
                    acc = self.jadd(acc, tbl[d])
        return self.to_affine(acc)

    def is_on_curve(self, p):
        if p is None:
            return True
        x, y = p
        return self.f_sq(y) == self.f_add(self.f_mul(self.f_sq(x), x), self.b)

    def in_subgroup(self, p):
        """On the curve and of order dividing r (the decoders' check)."""
        return self.is_on_curve(p) and self.mul(p, R) is None


g1 = CurveOps(
    f_add=fp_add,
    f_sub=fp_sub,
    f_mul=fp_mul,
    f_sq=fp_sq,
    f_neg=fp_neg,
    f_inv=fp_inv,
    zero=0,
    one=1,
    b=B_G1,
)

g2 = CurveOps(
    f_add=fp2_add,
    f_sub=fp2_sub,
    f_mul=fp2_mul,
    f_sq=fp2_sq,
    f_neg=fp2_neg,
    f_inv=fp2_inv,
    zero=FP2_ZERO,
    one=FP2_ONE,
    b=B_G2,
)
