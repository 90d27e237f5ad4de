"""Batched Fp (BLS12-381 base field) arithmetic on 52 lazy signed 8-bit
limbs in float32 tensors — the port of `coconut_tpu/tpu/fp.py`.

Every function operates on tensors of shape [..., NLIMBS] (leading dims =
batch). Elements are in the Montgomery domain (R = 2^416) as SIGNED limb
vectors, value = sum_i limb_i * 256^i, in one of two classes:

  NORMALIZED — mul outputs and encoded constants: |limbs| <= 132,
    |value| <= V_NORM = 4p, and limbs 50 and 51 exactly zero (tail
    domination: an integer below 1 is 0).

  LAZY — any +/-/small-constant combination of normalized values with
    total limb weight <= 2^17/132: |limbs| <= L_LAZY = 2^17,
    |value| <= V_LAZY = 1024p, limbs 50-51 zero. Every value entering a
    lazy combination has |value| < p, so even a ~992-term sum stays below
    V_LAZY.

add/sub/neg/mul_small are elementwise; every carry lives inside `mul`
(cuda_fp.py: the CUDA kernel for CUDA tensors, its plain PyTorch version
for CPU tensors). Exact predicates compress first (one multiply by the
encoded 1): the result is normalized with |value| < 0.66p, so it is 0 mod
p iff every limb is 0.

Constants are built once per device (`_const`); no tensor is fixed to a
device at import.
"""

import functools

import torch
import torch.nn.functional as F

from ..ops.fields import P
from . import cuda_fp
from .limbs import MONT_R, NLIMBS, balanced_limbs

# --- bounds (exact integer arithmetic at import time) -----------------------

L_NORM = 132            # normalized limb bound
V_NORM = 4 * P          # normalized value bound
L_LAZY = 1 << 17        # lazy limb bound (mul-input cap)
V_LAZY = 1024 * P       # lazy value bound (mul-input cap)

_TAIL50 = L_NORM * ((256**50 - 1) // 255)
_TAIL51 = L_NORM * ((256**51 - 1) // 255)
# top-limb vacancy of normalized values: l50 = l51 = 0 exactly
assert V_NORM + _TAIL50 < 256**50
assert V_NORM + _TAIL51 < 256**51
# two passes on lazy limbs: pass1 <= 128 + ceil(L_LAZY/256) = 640;
# pass2 <= 128 + 3 = 131 <= L_NORM. Carries land in the vacant top limbs:
# pass1 puts <= 512 in l50, pass2 puts <= 2 in l51, carry out of l51 is 0.
_P1 = 128 + (L_LAZY + 128) // 256
assert 128 + (_P1 + 128) // 256 <= L_NORM
assert (_P1 + 128) // 256 < 128  # l51 stays far below a further carry
# byte planes exact in int8: |t| <= 132^2 => hi in [-69,69], lo in [-128,127]
assert L_NORM * L_NORM <= 127 * 256 + 127
# school coefficients: sums of <= 52 products, exact f32/int32
assert NLIMBS * L_NORM * L_NORM < 1 << 24
# REDC: |m| <= 0.64 R; |out| <= V_LAZY^2/R + 0.64p < 0.66p < V_NORM
assert V_LAZY * V_LAZY // MONT_R + 64 * P // 100 + 1 < 2 * P // 3
# mul-internal coefficient bound (t + m*p): < 2^22, exact f32 adds
assert NLIMBS * L_NORM * L_NORM * 2 < 1 << 22
# Raw canonical base-256 digits (0..255 per limb) are valid LAZY mul
# inputs: 255 <= L_LAZY, value < p <= V_LAZY, and p < 2^381 < 256^48 so a
# 48-byte value leaves limbs 48..51 exactly zero after padding.
assert 255 <= L_LAZY and P <= V_LAZY and P < 256**48

_CONSTS_NP = {
    "one_m": balanced_limbs(MONT_R % P),
    "r2": balanced_limbs(MONT_R * MONT_R % P),
    "one_raw": balanced_limbs(1),
}


@functools.lru_cache(maxsize=None)
def _const(name, device):
    return torch.from_numpy(_CONSTS_NP[name]).to(device)


# --- public ops -------------------------------------------------------------


def zeros(shape, device):
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.float32, device=device)


def ones_mont(shape, device):
    return _const("one_m", torch.device(device)).expand(tuple(shape) + (NLIMBS,))


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def mul_small(a, k):
    """a * k for small static nonnegative k — elementwise (lazy)."""
    if k == 0:
        return torch.zeros_like(a)
    if k == 1:
        return a
    return a * float(k)


def mul(a, b):
    """Montgomery product a * b * 2^-416 mod p. Inputs LAZY, output
    NORMALIZED (see the module docstring). CUDA tensors launch the kernel,
    CPU tensors run its plain version (cuda_fp.mul)."""
    return cuda_fp.mul(a, b)


def sq(a):
    return mul(a, a)


def to_mont(t):
    """Raw canonical limbs -> Montgomery domain, on device: uint8/float
    [..., 48 or 52] raw base-256 digits of a canonical Fp value. One
    Montgomery multiply by R^2 gives x * R mod p, the value fp_encode
    computes with host bigints."""
    t = t.float()
    if t.shape[-1] < NLIMBS:
        t = F.pad(t, (0, NLIMBS - t.shape[-1]))
    return mul(t, _const("r2", t.device))


def from_mont(t):
    """Montgomery limbs -> limbs whose value is the standard-domain
    representative: one multiply by the raw integer 1 (x R * 1 * R^-1 = x).
    The output is a mul output (|value| < 0.66p). The SvdW map's sgn0 is
    taken on it: the sign is defined on the canonical integer, not on its
    Montgomery image."""
    return mul(t, _const("one_raw", t.device))


def pow_static(a, e, window=4):
    """a^e for a static positive int exponent: 4-bit windows, msb first.
    Per window: `window` squarings + ONE multiply by an entry of the table
    a^0..a^15 (14 muls to build). The entry for a zero digit is the
    encoded 1, multiplied like any other so the limbs match the
    reference's scan exactly."""
    assert e > 0
    nw = (e.bit_length() + window - 1) // window
    digits = [(e >> (window * i)) & ((1 << window) - 1) for i in range(nw - 1, -1, -1)]
    lead = a.shape[:-1]
    pows = [ones_mont(lead, a.device), a]
    for _ in range(2, 1 << window):
        pows.append(mul(pows[-1], a))
    acc = ones_mont(lead, a.device)
    for d in digits:
        for _ in range(window):
            acc = mul(acc, acc)
        acc = mul(acc, pows[d])
    return acc


def inv(a):
    """a^{p-2}; returns 0 for input 0 (callers mask identities explicitly)."""
    return pow_static(a, P - 2)


# --- exact predicates (compress, then all-limbs-zero) -----------------------


def is_zero(a):
    """a == 0 mod p for any LAZY a."""
    c = mul(a, ones_mont(a.shape[:-1], a.device))
    return (c == 0.0).all(dim=-1)


def is_zero_many(vals):
    """[v, ...] -> [v == 0 mod p, ...] with all the compress-muls stacked
    into one multiply."""
    ones = ones_mont(vals[0].shape[:-1], vals[0].device)
    outs = mul_stack(vals, [ones] * len(vals))
    return [(o == 0.0).all(dim=-1) for o in outs]


def eq(a, b):
    return is_zero(a - b)


def select(mask, a, b):
    """mask [...] bool -> a where true else b (limb tensors)."""
    return torch.where(mask[..., None], a, b)


# --- stacked-multiply helper ------------------------------------------------


def mul_stack(lhs_list, rhs_list):
    """Stack S independent products into ONE mul: lists of operands with
    broadcastable leading dims -> list of S products. One kernel launch
    for a whole tower or curve formula's base-field multiplies."""
    L = torch.stack(torch.broadcast_tensors(*lhs_list), dim=-2)  # [..., S, N]
    Rv = torch.stack(torch.broadcast_tensors(*rhs_list), dim=-2)
    out = mul(L, Rv)
    return list(out.unbind(dim=-2))


# --- canonical byte packing (the readback of point-returning programs) -----

_BASE = 256.0
_INV_BASE = 1.0 / 256.0
# 2p < 2^383: digits 48.. of any value + 2p below 4p are zero
assert 2 * P < 1 << 383
CANON_BYTES = 48
_TWO_P_DIGITS = [float(((2 * P) >> (8 * i)) & 0xFF) for i in range(NLIMBS)]


@functools.lru_cache(maxsize=None)
def _two_p(device):
    return torch.tensor(_TWO_P_DIGITS, dtype=torch.float32, device=device)


def pack_canon48(t):
    """f32 [..., 52] lazy limbs with |value| < 2p and |limbs| <= ~400 ->
    uint8 [..., 48] base-256 digits of (value + 2p), a canonical-width
    representative of value mod p: 48 bytes an Fp element on the readback
    instead of 208. Adding 2p's digits keeps every limb in [-400, 655]; the
    sequential floor-carry scan gives the exact digits of the nonnegative
    v + 2p < 2^383, whose digits 48..51 are zero and dropped. Every
    intermediate is an exact small float32 integer. The host inverse is
    limbs.fp_decode_batch's uint8 path."""
    return _canon_digits(t)[..., :CANON_BYTES].to(torch.uint8)


def canon_parity(t):
    """sgn0 of t: the parity of the canonical representative of t mod p,
    for NORMALIZED limbs with |value| < p (any mul output). With w = value
    + 2p in (p, 3p) the canonical value is w - 2p when w >= 2p and w - p
    otherwise; p is odd, so its parity is w's, flipped when w < 2p. Both
    come from _canon_digits: w's parity is digit 0's, and w >= 2p is a
    digit compare against 2p, most significant first (a value 0 gives
    w == 2p and parity 0, as sgn0(0) = 0). Returns bool [...]."""
    digits = _canon_digits(t)
    diff = torch.sign(digits - _two_p(t.device))  # [..., 52]
    # the sign of the most significant nonzero difference (0 if none: the
    # index clamps to digit 0, whose difference is then 0 too)
    top = torch.where(
        diff != 0.0, torch.arange(NLIMBS, device=t.device), -1
    ).amax(dim=-1, keepdim=True)
    ge2p = torch.gather(diff, -1, top.clamp(min=0))[..., 0] >= 0.0
    par_w = torch.remainder(digits[..., 0], 2.0) != 0.0
    return torch.where(ge2p, par_w, ~par_w)


def _canon_digits(t):
    """Exact base-256 digits of (value + 2p), [..., 52]: 52 steps of a
    floor carry, limb 0 first (floor semantics, so a negative limb borrows
    from the next). Stack every coordinate a program returns into one call:
    the scan's launches do not grow with the width."""
    v = t + _two_p(t.device)
    digits = torch.empty_like(v)
    c = torch.zeros_like(v[..., 0])
    for i in range(NLIMBS):
        s = v[..., i] + c
        c = torch.floor(s * _INV_BASE)
        digits[..., i] = s - c * _BASE
    return digits
