"""Limb codec: Python ints <-> 52 signed 8-bit limbs in float32 — the
port's copy of `coconut_tpu/tpu/limbs.py` (numpy only, no torch).

Fp values travel as 52 BALANCED limbs (each in [-128, 128], least
significant first) in the Montgomery domain (a * 2^416 mod p). 416 bits
against the 381-bit p leave ~2^35 of headroom, which is what lets the
device arithmetic add and subtract lazily and confine every carry to the
Montgomery multiply (see gpu/fp.py). Every intermediate of that multiply is
an integer below 2^24, so float32 holds it exactly.
"""

import numpy as np

from ..ops.fields import P, R

LIMB_BITS = 8
NLIMBS = 52  # 52 * 8 = 416 bits: ~2^35 of headroom over the 381-bit p
MASK = (1 << LIMB_BITS) - 1
MONT_BITS = LIMB_BITS * NLIMBS  # 416
MONT_R = 1 << MONT_BITS

DTYPE = np.float32

# Raw (non-Montgomery) wire format: 48 canonical little-endian bytes per Fp.
RAW_BYTES = 48


def balanced_limbs(x, nlimbs=NLIMBS, wrap=False):
    """Nonnegative int -> balanced signed limbs (each in [-128, 128]) as
    np.float32[nlimbs]. With `wrap`, a final carry is dropped (value taken
    mod 2^(8*nlimbs) — for constants only used in mod-2^416 arithmetic,
    e.g. N')."""
    digs = [(x >> (LIMB_BITS * i)) & MASK for i in range(nlimbs)]
    if x >> (LIMB_BITS * nlimbs):
        raise ValueError("value out of range for %d limbs" % nlimbs)
    out = []
    carry = 0
    for d in digs:
        v = d + carry
        if v > 128:
            v -= 256
            carry = 1
        else:
            carry = 0
        out.append(v)
    if carry and not wrap:
        raise ValueError("balanced form needs %d limbs + carry" % nlimbs)
    return np.array(out, dtype=DTYPE)


def fp_encode(x):
    """Canonical Fp int -> balanced Montgomery limb vector (host-side)."""
    return balanced_limbs(x % P * MONT_R % P)


def balanced_limbs_batch(xs, nlimbs=NLIMBS):
    """List of nonnegative ints -> np.float32[n, nlimbs] balanced limbs,
    vectorized over the batch: the 0/1 balance carry runs as one numpy
    loop over the limb axis."""
    buf = b"".join(int(x).to_bytes(nlimbs, "little") for x in xs)
    d = np.frombuffer(buf, dtype=np.uint8).reshape(-1, nlimbs).astype(np.int32)
    c = np.zeros(len(xs), dtype=np.int32)
    out = np.empty((len(xs), nlimbs), dtype=DTYPE)
    for i in range(nlimbs):
        v = d[:, i] + c
        c = (v > 128).astype(np.int32)
        out[:, i] = v - (c << 8)
    if c.any():
        raise ValueError("balanced form needs %d limbs + carry" % nlimbs)
    return out


def fp_encode_batch(xs):
    """List of ints -> np.float32[n, NLIMBS], balanced Montgomery."""
    return balanced_limbs_batch([int(x) % P * MONT_R % P for x in xs])


def fp_encode_raw_batch(xs):
    """List of canonical Fp ints -> np.uint8[n, RAW_BYTES] raw base-256
    digits, NOT in the Montgomery domain and NOT balanced. The device
    enters the domain with one Montgomery multiply by R^2 (fp.to_mont)."""
    buf = b"".join((int(x) % P).to_bytes(RAW_BYTES, "little") for x in xs)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), RAW_BYTES)


# COCONUT_DEBUG_PACK=1: backend._pack_pts records the largest limb magnitude
# of every leaf it packs that breaks fp.pack_canon48's |v| <= 396 contract,
# and the host decode boundary raises, so a violation surfaces on the very
# readback it corrupted.
PACK_DEBUG_VIOLATIONS = []


def pack_debug_record(m):
    """Record a limb-magnitude maximum that exceeds the pack bound."""
    v = float(m)
    if v > 396.0:
        PACK_DEBUG_VIOLATIONS.append(v)


def pack_debug_check():
    """Raise (and drain) if any recorded limb magnitude broke the pack
    bound; called at the fp_decode_batch entry."""
    if PACK_DEBUG_VIOLATIONS:
        worst = max(PACK_DEBUG_VIOLATIONS)
        del PACK_DEBUG_VIOLATIONS[:]
        raise AssertionError("_pack_pts limb |v| = %r exceeds the pack bound 396" % worst)


def fp_decode_batch(arr):
    """Montgomery device output -> flat list of canonical ints, by dtype:

      - uint8 [..., 48]: base-256 digits of (value + 2p) from
        fp.pack_canon48 (the packed readback), int.from_bytes an element,
        then the Montgomery divide mod p;
      - any float/int [..., NLIMBS]: signed limb vectors, pre-combined into
        48-bit chunks in int64 numpy (exact for |limb| <= ~400: a 6-limb
        chunk is < 6 * 400 * 2^40 < 2^52), leaving ~9 Python big-int ops
        an element."""
    pack_debug_check()  # surface any COCONUT_DEBUG_PACK violation here
    rinv = pow(MONT_R, -1, P)
    a0 = np.asarray(arr)
    if a0.dtype == np.uint8:
        flat = np.ascontiguousarray(a0.reshape(-1, a0.shape[-1]))
        nb = flat.shape[1]
        buf = flat.tobytes()
        return [
            int.from_bytes(buf[i * nb : (i + 1) * nb], "little") * rinv % P
            for i in range(flat.shape[0])
        ]
    a = a0.astype(np.float64)
    flat = a.reshape(-1, a.shape[-1]).round().astype(np.int64)
    n, nl = flat.shape
    nchunk = -(-nl // 6)
    pad = nchunk * 6 - nl
    if pad:
        flat = np.concatenate([flat, np.zeros((n, pad), np.int64)], axis=1)
    w6 = np.int64(1) << (LIMB_BITS * np.arange(6, dtype=np.int64))
    chunks = (flat.reshape(n, nchunk, 6) * w6).sum(axis=2)
    shifts = [LIMB_BITS * 6 * j for j in range(nchunk)]
    out = []
    for row in chunks:
        v = 0
        for j in range(nchunk):
            v += int(row[j]) << shifts[j]
        out.append(v * rinv % P)
    return out


def fr_digits_signed_np(scalars, nwin=52, window=5):
    """[n] iterable of ints -> (mag [n, nwin], neg bool [n, nwin]) signed
    `window`-bit digits, msb first: k = sum_w d_w * (2^window)^w with
    d_w in [-(2^(window-1) - 1), 2^(window-1)], d = sign * mag.

    mag dtype: uint8 for window <= 8, int16 for window >= 9 — the digit
    magnitude reaches 256 at window 9, and a uint8 there wraps 256 -> 0 and
    returns wrong verify bits. The top digit absorbs the final carry (Fr is
    255 bits; 43*6 = 258, 29*9 = 261)."""
    half = 1 << (window - 1)
    base = 1 << window
    mag_dtype = np.uint8 if half <= 255 else np.int16
    acc_dtype = np.int16 if window <= 10 else np.int32
    nbytes = (nwin * window + 7) // 8
    # lint: allow(const-time, CONSTTIME.md §1 host caveat - big-int reduce +
    # to_bytes cost tracks bit length; accepted on the host recode path)
    buf = b"".join((int(s) % R).to_bytes(nbytes, "little") for s in scalars)
    bits = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8).reshape(-1, nbytes),
        axis=1,
        bitorder="little",
    )[:, : nwin * window]
    uw = bits.reshape(-1, nwin, window).astype(acc_dtype) @ (
        1 << np.arange(window, dtype=acc_dtype)
    )  # unsigned base-2^window digits, lsb first
    mag = np.empty((uw.shape[0], nwin), dtype=mag_dtype)
    neg = np.empty((uw.shape[0], nwin), dtype=bool)
    c = np.zeros(uw.shape[0], dtype=acc_dtype)
    for w in range(nwin):  # lsb first; msb-first order fixed on store
        v = uw[:, w] + c
        over = v > half
        d = np.where(over, v - base, v)
        c = over.astype(acc_dtype)
        mag[:, nwin - 1 - w] = np.abs(d).astype(mag_dtype)
        neg[:, nwin - 1 - w] = d < 0
    # lint: allow(const-time, carry is structurally zero for every Fr input -
    # the branch direction is input-independent)
    if c.any():  # Fr < 2^255: the top window absorbs every carry
        raise ValueError("signed digits overflowed %d windows" % nwin)
    return mag, neg
