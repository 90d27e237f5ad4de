"""TorchBackend — batched PS-credential verification and selective-
disclosure show verification on the GPU, the port of the verify and
show-verify paths of `coconut_tpu/tpu/backend.py`:

  host (Python ints)
    -> encode_verify_batch: per-verkey comb tables (LRU), g_tilde
       (static-operand LRU), signed comb digits, sigma points   [host]
    -> fused_verify: comb MSM -> affine -> two-pair Miller loop
       -> final exponentiation -> GT == 1                        [device]
    -> one bool per credential

  encode_show_verify_batch / fused_show_verify (BASELINE config 3): the
  same, plus the Schnorr check of each proof (comb MSM over g_tilde and
  the hidden Y_tilde, the distinct MSM J^c, one affine compare with the
  commitment t) and J joined to the pairing accumulator.

  The CurveBackend MSM primitives (msm_g{1,2}_shared[_many][_async],
  msm_g{1,2}_distinct[_async] and their waits), which the batched show
  prover (`coconut_tpu_torch.pok_sig.batch_show`) runs on: point-returning
  programs (msm_shared_many_program, msm_distinct_affine_program) whose
  affine outputs come back as 48 canonical bytes a coordinate
  (fp.pack_canon48, one carry scan over every coordinate of a program)
  and are decoded on the host. G1 distinct MSMs split each scalar by GLV
  (gpu/glv.py, 27 windows instead of 52).

  Issuance (BASELINE config 4, `coconut_tpu_torch.signature`'s batch
  functions) adds: the device hash-to-G1 (hash_to_g1_program: the SvdW
  map of both field candidates, one add, the cofactor ladder; the
  expand_message_xmd stays on the host), the distinct MSM with a per-lane
  affine offset taken from another program's packed output on the device
  (msm_distinct_plus_offset_program, via _unpack_pt), and the bucketed
  (Pippenger) schedule of the distinct MSMs (curve.msm_distinct_bucketed),
  chosen per batch shape by the reference's cost model (_bucket_window).

  fused_verify_combined / fused_show_verify_combined: the random-linear-
  combination batch check. Each lane's pairing check is raised to a
  128-bit combiner r_i, so the B checks fold into one product of B+1
  Miller pairs with ONE shared final exponentiation; the protocol layer
  (`coconut_tpu_torch.ps`) derives the r_i and bisects on a rejection.

  encode_grouped_batch / fused_verify_grouped: the attribute-grouped
  combination, ONE bool a batch from q+2 Miller pairs whatever B is. All
  per-credential work is q+2 shared-point MSMs over the signature group
  (_grouped_msms); the verkey's points and g_tilde are fixed inputs.

Every field product runs through gpu/fp.mul: the CUDA kernel on `cuda`,
its plain PyTorch version on `cpu`. Results are bit-identical to the
reference (tests/test_torch_verify.py holds them against JaxBackend and
the spec).

Every path runs under both signature assignments: ctx "G1" (signatures
in G1, the default) and "G2" (the roles of the groups swap).
"""

import os
import secrets
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..batchverify import derive_combiners, show_transcript, verify_transcript
from ..ops.curve import G1_COFACTOR, g1 as _g1, g2 as _g2
from ..ops.fields import P, R
from ..ops.hashing import DST_G1, expand_message_xmd
from . import curve as cv
from . import fp
from . import glv
from . import pairing as pr
from . import tower as tw
from .limbs import NLIMBS, fp_encode, fp_encode_raw_batch, fr_digits_signed_np

_SIGNED_NWIN = 52  # signed 5-bit windows covering the 255-bit Fr

# Bit length of the combiner exponents r_i of the combined checks. The
# signed 5-bit recode of a value below 2^128 fills 26 windows plus one carry
# window, so their MSMs run the last _R_NWIN of the 52 windows.
_R_RAND_BITS = 128
_R_NWIN = -(-_R_RAND_BITS // 5) + 1  # 27

# The grouped verify's schedule: signed 6-bit digits, 43 windows over Fr
# and 33-entry tables built on the device; the 128-bit combiners fill the
# last 23 windows.
_G_WINDOW = 6
_G_NWIN = -(-255 // _G_WINDOW)  # 43
_G_RNWIN = -(-_R_RAND_BITS // _G_WINDOW) + 1  # 23
_G_ENTRIES = (1 << (_G_WINDOW - 1)) + 1  # 33


def bucket_mode(device):
    """The distinct MSMs' schedule mode, resolved as the reference resolves
    it: COCONUT_MSM_WINDOW=w forces the bucketed schedule at window w
    (2..8), COCONUT_MSM_WINDOW=0 forces Horner; unset, the cost model
    chooses ("auto") on `cuda` and Horner runs ("off") elsewhere. One
    setting gives the same schedule in both packages."""
    v = os.environ.get("COCONUT_MSM_WINDOW")
    if v is None:
        return "auto" if device.type == "cuda" else "off"
    w = int(v)
    if w == 0:
        return "off"
    if not 2 <= w <= 8:
        raise ValueError(
            "COCONUT_MSM_WINDOW=%d unsupported: bucketed windows span 2..8 "
            "(uint8 digit magnitudes; 0 disables)" % w
        )
    return w


def _bucket_cost(k, nbits, w):
    # batch-width add-equivalents a row: nwin windows of (w doublings at
    # ~0.75 add each, k scatter adds, 2 nb running-sum adds, 1 Horner add);
    # no table build
    nwin = -(-nbits // w) + 1
    return nwin * (0.75 * w + k + 2 * (1 << (w - 1)) + 1)


def _horner_cost(k, nbits):
    # msm_distinct_signed: 16 chained table adds at k lanes, then nwin
    # windows of (5 doublings, k gathered adds)
    nwin = -(-nbits // 5) + 1
    return 16 * k + nwin * (0.75 * 5 + k)


def _bucket_window(k, nbits, mode):
    """The bucketed schedule's window for an effective (post-GLV) base
    count `k` a row and scalar width `nbits` under `mode` (bucket_mode), or
    None for Horner. The cost model's crossover sits near k ~ 64: below it
    the 17-entry-table Horner schedule is cheaper."""
    if mode == "off" or k <= 0:
        return None
    if mode != "auto":
        return mode
    best = min(range(2, 9), key=lambda w: _bucket_cost(k, nbits, w))
    if _bucket_cost(k, nbits, best) < _horner_cost(k, nbits):
        return best
    return None


def resolve_device(device=None):
    """torch.device for an entry point: `cuda` unless the caller names
    another. Asking for CUDA where no card is present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


def comb_schedule(window):
    """(window, nwin, entries) of the signed comb over 255-bit scalars:
    29 windows / 257 entries at 9 bits, 43 / 33 at 6 bits. The windows
    cover 256 bits, so the top signed digit always absorbs the carry."""
    return window, -(-256 // window), (1 << (window - 1)) + 1


def _signed_digits(scalars_batch, device, nwin=_SIGNED_NWIN, window=5):
    """[B][k] ints -> (mag, sgn bool) [B, k, nwin] signed window digits on
    `device`, msb first (mag uint8 up to window 8, int16 at 9). The default
    5-bit/52 schedule is the distinct MSM's; the comb paths pass the
    backend's comb schedule."""
    B = len(scalars_batch)
    k = len(scalars_batch[0]) if B else 0
    flat = [s for row in scalars_batch for s in row]
    mag, sgn = fr_digits_signed_np(flat, nwin=nwin, window=window)
    return (
        torch.from_numpy(mag.reshape(B, k, nwin)).to(device),
        torch.from_numpy(sgn.reshape(B, k, nwin)).to(device),
    )


def _build_tables(spec_ops, bases, entries, device):
    """Host-side: per-base projective multiples 0..entries-1 as spec
    coordinate tuples (identity = (0, 1, 0)), by chained spec adds, then
    encoded into a nested tuple with leading [k, entries]."""
    ident = (spec_ops.zero, spec_ops.one, spec_ops.zero)
    flat = []
    for b in bases:
        row = [None]
        for _ in range(1, entries):
            row.append(spec_ops.add(row[-1], b) if row[-1] else b)
        flat += [ident if p is None else (p[0], p[1], spec_ops.one) for p in row]
    tree = tw.encode_batch(flat, device)
    k = len(bases)
    return tw.tree_map(lambda t: t.reshape((k, entries) + t.shape[1:]), tree)


def device_slot(device):
    """The card a tensor made for `device` lands on: the index of a CUDA
    device, the current CUDA device's for a bare `cuda` (so tensors
    follow `torch.cuda.device(...)`, the serve layer's placement seam),
    None for the CPU. The backend's caches carry it in their keys, so an
    entry made on one card never serves another."""
    if device.type != "cuda":
        return None
    return device.index if device.index is not None else torch.cuda.current_device()


class _LRU:
    """Small least-recently-used map (dict insertion order + move-to-end),
    safe under the serve layer's executor threads."""

    def __init__(self, maxsize):
        self.maxsize = maxsize
        self._d = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            val = self._d.get(key)
            if val is not None:
                self._d.move_to_end(key)
            return val

    def put(self, key, val):
        with self._lock:
            while len(self._d) >= self.maxsize:
                self._d.popitem(last=False)
            self._d[key] = val


class PackedPoints(tuple):
    """A point program's packed affine output (x, y, inf): x and y are
    uint8 [..., 48] canonical digits of the MONTGOMERY value (+ 2p), from
    fp.pack_canon48. Not a wire operand: a raw-wire uint8 coordinate holds
    the STANDARD-domain value, and _pts_f32 moves it into the Montgomery
    domain. A program that consumes another's output on the device goes
    through _unpack_pt, which takes only this type; _pts_f32 refuses it."""


def _holds_packed(tree):
    return isinstance(tree, tuple) and (
        isinstance(tree, PackedPoints) or any(_holds_packed(t) for t in tree)
    )


def _unpack_pt(packed):
    """A PackedPoints handle -> (x, y, inf) with f32 limb coordinates: the
    digits 0..255 are valid LAZY limbs of the Montgomery value (the +2p is
    absorbed mod p downstream), and limbs 48..51 come back as zeros. No
    domain change."""
    if not isinstance(packed, PackedPoints):
        raise TypeError("_unpack_pt takes a program's PackedPoints output")
    x, y, inf = packed

    def f(t):
        return torch.nn.functional.pad(t.float(), (0, NLIMBS - t.shape[-1]))

    return tw.tree_map(f, x), tw.tree_map(f, y), inf


def _pts_f32(tree):
    """Uploaded point operands enter the field arithmetic here, by dtype:
    uint8 [..., 48] raw canonical digits -> fp.to_mont (one multiply by
    R^2); int16 [..., 52] balanced Montgomery limbs -> float32; float32
    unchanged. A program's packed output is refused (see PackedPoints)."""
    if _holds_packed(tree):
        raise TypeError("a program's packed output is not a wire operand; use _unpack_pt")

    def conv(t):
        if t.dtype == torch.uint8:
            return fp.to_mont(t)
        return t.float()

    return tw.tree_map(conv, tree)


def _fields(sig_is_g1):
    """(signature-group field, other-group field) of an assignment."""
    return (cv.FP, cv.FP2) if sig_is_g1 else (cv.FP2, cv.FP)


def verify_tail(sig_is_g1, acc, s1, s2n, gtx, gty, inf1, inf2):
    """Post-MSM half of the fused verify: normalize the accumulator and run
    the two-pair pairing product e(s1, acc) * e(-s2, g_tilde) == 1, and-ed
    with "sigma_1 is not the identity".

    The G1 assignment runs the two-pair loop with g_tilde's shared ladder
    (pr.miller_two_pairs_shared_q2). Under G2 the accumulator and g_tilde
    are the G1 side, and the generic pair set [B, 2] runs: P = (acc,
    g_tilde), Q = (sigma_1, -sigma_2), g_tilde broadcast over the batch."""
    s1, s2n, gtx, gty = _pts_f32((s1, s2n, gtx, gty))
    ax, ay, ainf = cv.to_affine(_fields(sig_is_g1)[1], acc)
    if sig_is_g1:
        f = pr.miller_two_pairs_shared_q2(
            s1[0], s1[1], ax, ay, ~inf1 & ~ainf,
            s2n[0], s2n[1], gtx, gty, ~inf2,
        )
        one = tw.fp12_is_one(pr.final_exp(f))
        return one & ~inf1

    def stack2(a, b):  # [B] lanes and [B] or constant -> [B, 2]
        return tw.tree_map(
            lambda x, y: torch.stack(torch.broadcast_tensors(x, y), dim=-2), a, b
        )

    pinf = torch.stack([ainf, torch.zeros_like(ainf)], dim=-1)
    qinf = torch.stack([inf1, inf2], dim=-1)
    one = pr.pairing_product_is_one(
        stack2(ax, gtx), stack2(ay, gty), stack2(s1[0], s2n[0]),
        stack2(s1[1], s2n[1]), ~(pinf | qinf),
    )
    return one & ~inf1


def fused_verify(sig_is_g1, wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2):
    """Fused batch verify: comb MSM accumulator + 2-pair pairing product.

    sig_is_g1: signatures in G1 (ctx "G1"), the accumulator in G2; the
    roles swap otherwise. wtables: per-verkey comb tables
    (cv.build_comb_tables) in the other group; mag/sgn: signed comb digits
    [B, k, nwin]; s1/s2n: sigma_1 and -sigma_2 coordinate pairs [B];
    gtx/gty: g_tilde's affine coordinates; inf1/inf2: identity masks for
    sigma_1 / sigma_2. Returns bool [B]."""
    acc = cv.msm_shared_comb(_fields(sig_is_g1)[1], wtables, mag, sgn)
    return verify_tail(sig_is_g1, acc, s1, s2n, gtx, gty, inf1, inf2)


def fused_show_verify(
    sig_is_g1, vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j,
    commx, commy, comminf, acc_wtables, acc_mag, acc_sgn, s1, s2n, gtx, gty,
    inf1, inf2,
):
    """Batched PoKOfSignatureProof.verify (BASELINE config 3). Two checks
    per proof:

      1. Schnorr: prod_k bases_k^{resp_ik} * J_i^{c_i} == t_i, bases =
         [g_tilde, hidden Y_tilde]: a comb MSM plus the k = 1 distinct MSM
         J^c, compared in affine form with the commitment t (both
         identities is a match, one identity is not);
      2. pairing: e(sigma'_1, J * X_tilde * prod_rev Y_tilde^m) *
         e(-sigma'_2, g_tilde) == 1 — the comb MSM over [X_tilde,
         revealed Y_tilde] with scalars [1, m_rev..], J joined by one add,
         then verify_tail.

    jpt: J as (x, y) coordinate pairs [B] and jinf its identity mask;
    cmag_j/csgn_j: the challenges' signed 5-bit digits [B, 1, 52];
    commx/commy/comminf: the commitment t. The rest as in fused_verify.
    All proofs share one revealed-index set. Under G2 the Schnorr MSMs, J
    and the accumulator are over G1. Returns bool [B]."""
    oth_fl = _fields(sig_is_g1)[1]
    jpt, commx, commy = _pts_f32((jpt, commx, commy))
    schnorr_ok = _schnorr_check(
        oth_fl, vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j,
        commx, commy, comminf,
    )
    acc = _show_accumulator(oth_fl, acc_wtables, acc_mag, acc_sgn, jpt, jinf)
    pair_ok = verify_tail(sig_is_g1, acc, s1, s2n, gtx, gty, inf1, inf2)
    return schnorr_ok & pair_ok


def _schnorr_check(
    fl, vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j, commx, commy,
    comminf,
):
    """The Schnorr half of the show programs, per lane, over the other
    group's field `fl`: comb MSM over [g_tilde, hidden Y_tilde] plus the
    distinct MSM J^c, compared in affine form with the commitment t. Points
    are field elements already (_pts_f32). Its to_affine inversion stays
    separate from the pairing half's, as in the reference."""
    vc = cv.msm_shared_comb(fl, vc_wtables, resp_mag, resp_sgn)
    lift = lambda t: t[:, None]
    jterm = cv.msm_distinct_signed(
        fl, tw.tree_map(lift, jpt[0]), tw.tree_map(lift, jpt[1]),
        jinf[:, None], cmag_j, csgn_j,
    )
    lx, ly, linf = cv.to_affine(fl, cv.jadd(fl, vc, jterm))
    return (
        fl.eq(lx, commx) & fl.eq(ly, commy) & ~linf & ~comminf
    ) | (linf & comminf)


def _show_accumulator(fl, acc_wtables, acc_mag, acc_sgn, jpt, jinf):
    """J * X_tilde * prod_rev Y_tilde^m over the other group's field `fl`:
    the comb MSM plus one add of J."""
    acc = cv.msm_shared_comb(fl, acc_wtables, acc_mag, acc_sgn)
    return cv.jadd(fl, acc, cv.affine_to_jacobian(fl, jpt[0], jpt[1], jinf))


def _tree_fold_fp12(f, n):
    """Product of an [n]-leading Fp12 element (n a power of two) by pairwise
    halving, lo * hi, as the reference folds it. Returns [1]-leading."""
    assert n & (n - 1) == 0
    while n > 1:
        half = n // 2
        f = tw.fp12_mul(
            tw.tree_map(lambda t: t[:half], f), tw.tree_map(lambda t: t[half:n], f)
        )
        n = half
    return f


def _combined_pairing(sig_is_g1, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2):
    """The RLC-combined pairing half shared by both combined programs:

      prod_i e(r_i sigma_1_i, acc_i) * e(sum_i r_i (-sigma_2_i), g_tilde) == 1

    B+1 Miller pairs on a [B+1, 1] pair set and ONE final exponentiation.
    Points are field elements already (_pts_f32). Dead lanes (identity
    sigma or accumulator) are masked to the identity before the sum and
    out of the Miller product. Under G2 the r-MSMs, the fold and their
    affines run over G2, and the signature side of each pair is its Q.
    Returns (the batch's bool [1], dead [B])."""
    fl, acc_fl = _fields(sig_is_g1)
    B = inf1.shape[0]
    ax, ay, ainf = cv.to_affine(acc_fl, acc)
    lift = lambda t: t[:, None]
    lift_pt = lambda pt: tw.tree_map(lift, pt)
    # r_i sigma_1_i and r_i (-sigma_2_i): k = 1 distinct MSMs over the
    # 27-window schedule
    s1r = cv.msm_distinct_signed(
        fl, lift_pt(s1[0]), lift_pt(s1[1]), inf1[:, None], rmag, rsgn
    )
    s2rn = cv.msm_distinct_signed(
        fl, lift_pt(s2n[0]), lift_pt(s2n[1]), inf2[:, None], rmag, rsgn
    )
    dead = inf1 | inf2 | ainf
    s2rn = tuple(
        fl.select(dead, i_, c)
        for i_, c in zip(cv.jinfinity(fl, (B,), dead.device), s2rn)
    )
    s2sum = cv.fold_points(fl, s2rn, B)
    sx, sy, sinf = cv.to_affine(fl, s1r)
    zx, zy, zinf = cv.to_affine(fl, s2sum)

    # (r_i sigma_1_i, acc_i) for each lane, then (the sum, g_tilde) as one
    # more lane
    def cat(a, b):
        return tw.tree_map(lambda x, y: torch.cat([x, y[None]]), a, b)

    px, py = cat(sx, zx), cat(sy, zy)
    qx, qy = cat(ax, gtx), cat(ay, gty)
    if not sig_is_g1:
        px, py, qx, qy = qx, qy, px, py
    valid = torch.cat([~dead & ~sinf, ~zinf[None]])
    f = pr.multi_miller_loop(
        lift_pt(px), lift_pt(py), lift_pt(qx), lift_pt(qy), valid[:, None]
    )  # [B+1]
    head = tw.tree_map(lambda t: t[:B], f)
    tail = tw.tree_map(lambda t: t[B:], f)
    prod = tw.fp12_mul(_tree_fold_fp12(head, B), tail)
    return tw.fp12_is_one(pr.final_exp(prod)), dead


def fused_verify_combined(
    sig_is_g1, wtables, mag, sgn, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2
):
    """Combined batch verify: ONE bool for the whole batch. With 128-bit
    combiners r_i (digits rmag/rsgn [B, 1, 27], from _combiner_digits),

      prod_i [e(sigma_1_i, acc_i) * e(-sigma_2_i, g_tilde)]^{r_i} == 1,

    a forged credential passing with probability <= 2^-128. B must be a
    power of two (the host pads). Any dead lane (identity sigma or
    accumulator) fails the whole batch; the host rejects identity sigmas
    before it gets here. Other operands as in fused_verify. Returns bool
    [] on the device."""
    s1, s2n, gtx, gty = _pts_f32((s1, s2n, gtx, gty))
    acc = cv.msm_shared_comb(_fields(sig_is_g1)[1], wtables, mag, sgn)
    ok, dead = _combined_pairing(
        sig_is_g1, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2
    )
    return ok[0] & ~dead.any()


def fused_show_verify_combined(
    sig_is_g1, vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j,
    commx, commy, comminf, acc_wtables, acc_mag, acc_sgn, s1, s2n, rmag,
    rsgn, gtx, gty, inf1, inf2,
):
    """Combined batch show verify: per-lane Schnorr bits plus ONE pairing
    bool for the whole batch. The Schnorr half is fused_show_verify's; the
    B pairing checks fold under the combiners r_i as in
    fused_verify_combined. Dead lanes (identity sigma' or accumulator) are
    masked out of the fold and fail only their own bit. Returns (bits [B]
    = Schnorr ok and not dead, pairing bool []); a lane's verdict is
    bits_i & pairing."""
    oth_fl = _fields(sig_is_g1)[1]
    jpt, commx, commy = _pts_f32((jpt, commx, commy))
    s1, s2n, gtx, gty = _pts_f32((s1, s2n, gtx, gty))
    schnorr_ok = _schnorr_check(
        oth_fl, vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j,
        commx, commy, comminf,
    )
    acc = _show_accumulator(oth_fl, acc_wtables, acc_mag, acc_sgn, jpt, jinf)
    pair_ok, dead = _combined_pairing(
        sig_is_g1, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2
    )
    return schnorr_ok & ~dead, pair_ok[0]


def _combiner_digits(rs, device):
    """Combiner exponents -> their signed 5-bit digits on the combined
    programs' short schedule, (mag, sgn) [B, 1, _R_NWIN]. Refuses an
    exponent of _R_RAND_BITS bits or more: the schedule would drop its top
    windows."""
    for r in rs:
        if not 0 <= r < (1 << _R_RAND_BITS):
            raise ValueError("combiner exponent exceeds %d bits" % _R_RAND_BITS)
    rmag, rsgn = _signed_digits([[r] for r in rs], device)
    # only the last _R_NWIN msb-first windows can be nonzero
    return rmag[:, :, _SIGNED_NWIN - _R_NWIN :], rsgn[:, :, _SIGNED_NWIN - _R_NWIN :]


def _pow2_lanes(n):
    """The combined programs' lane count: n padded to a power of two, at
    least 2."""
    return 1 << max(1, (n - 1).bit_length())


def _grouped_msms(fl, x, y, inf, mag, sgn):
    """M MSMs over the SAME [B] points: signed 6-bit window digits mag/sgn
    [M, B, nwin] (msb first, digit = (-1)^sgn * mag, mag <= 32) ->
    projective accumulators [M].

      1. one 33-entry table build on the device (32 adds over [B]);
      2. ONE gather of the [M, nwin, B] table entries and the fold over B
         (_grouped_window_sums);
      3. Horner over the nwin window sums (_grouped_horner)."""
    tables = cv.build_tables_device(fl, x, y, inf, entries=_G_ENTRIES)
    return _grouped_horner(fl, _grouped_window_sums(fl, tables, mag, sgn))


def _grouped_window_sums(fl, tables, mag, sgn):
    """The table entry of every (msm, window, point), gathered per lane
    (the reference's broadcast of the table to [M, nwin, B, 33] is never
    made) with the sign applied as a Y-flip, then summed over B, pairing
    lanes as the reference's fold_points(..., axis_offset=2) does ->
    window sums [M, nwin]."""
    M, B, nwin = mag.shape
    dw = mag.permute(0, 2, 1).long()  # [M, nwin, B]; a uint8 index would mask
    sw = sgn.permute(0, 2, 1)
    lanes = torch.arange(B, device=dw.device)

    def leaf(t):  # [B, 33, L] -> [M, nwin, B, L]
        return t[lanes, dw]

    X, Y, Z = (tw.tree_map(leaf, t) for t in tables)
    Y = fl.select(sw, fl.neg(Y), Y)
    return cv.fold_points(fl, (X, Y, Z), B, axis_offset=2)


def _grouped_horner(fl, sums):
    """Horner over window sums [M, nwin], msb first, from the identity: 6
    doublings and one add on [M] lanes a window."""
    lead = tw.leaves(sums)[0]  # [M, nwin, L]
    M, nwin = lead.shape[:2]
    acc = cv.jinfinity(fl, (M,), lead.device)
    for w in range(nwin):
        for _ in range(_G_WINDOW):
            acc = cv.jdouble(fl, acc)
        acc = cv.jadd(fl, acc, tw.tree_map(lambda t: t[:, w], sums))
    return acc


def grouped_accumulators(sig_fl, s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn):
    """The per-credential half of the grouped verify: q+1 MSMs over
    sigma_1 (scalars r_i, then r_i m_ij) and one over -sigma_2 (scalars
    r_i, on the 23-window short schedule) -> projective accumulators
    [q+2]."""
    s1, s2n = _pts_f32((s1, s2n))
    acc1 = _grouped_msms(sig_fl, s1[0], s1[1], inf1, cmag, csgn)  # [q+1]
    acc2 = _grouped_msms(sig_fl, s2n[0], s2n[1], inf2, rmag, rsgn)  # [1]
    return tw.tree_map(lambda a, b: torch.cat([a, b]), acc1, acc2)


def grouped_tail(sig_is_g1, allacc, ox, oy, gtx, gty, any_dead):
    """Post-MSM half of the grouped verify: the q+2 accumulators against
    the fixed other-group points (X_tilde, Y_tilde_j, then g_tilde), one
    Miller pair each, the Fp12 values folded (padded to a power of two
    with ones), ONE final exponentiation, one bool."""
    ox, oy, gtx, gty = _pts_f32((ox, oy, gtx, gty))
    px, py, pinf = cv.to_affine(_fields(sig_is_g1)[0], allacc)  # [q+2]
    cat = lambda a, b: torch.cat([a, b[None]])
    qx, qy = tw.tree_map(cat, ox, gtx), tw.tree_map(cat, oy, gty)
    valid = ~pinf  # a zero accumulator contributes the factor 1
    npair = valid.shape[0]
    f = _grouped_tail_miller(sig_is_g1, px, py, qx, qy, valid)
    pow2 = 1 << (npair - 1).bit_length()
    if pow2 != npair:
        pad = tw.fp12_ones((pow2 - npair,), valid.device)
        f = tw.tree_map(lambda a, b: torch.cat([a, b]), f, pad)
    ok = tw.fp12_is_one(pr.final_exp(_tree_fold_fp12(f, pow2)))[0]
    return ok & ~any_dead


def _grouped_tail_miller(sig_is_g1, px, py, qx, qy, valid):
    """multi_miller_loop on the [q+2, 1] pair set, the G1 points first:
    the signature-group accumulators under G1, the verkey's under G2."""
    if not sig_is_g1:
        px, py, qx, qy = qx, qy, px, py
    lift = lambda t: t[:, None]
    return pr.multi_miller_loop(
        tw.tree_map(lift, px), tw.tree_map(lift, py),
        tw.tree_map(lift, qx), tw.tree_map(lift, qy), valid[:, None],
    )


def fused_verify_grouped(
    sig_is_g1, s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn, ox, oy, gtx, gty
):
    """Attribute-grouped combined batch verify: ONE bool, q+2 Miller pairs
    whatever the batch size. With 128-bit combiners r_i and messages m_ij,

      prod_i [e(s1_i, X * prod_j Y_j^{m_ij}) * e(-s2_i, g)]^{r_i}
      = e(sum_i r_i s1_i, X) * prod_j e(sum_i (r_i m_ij) s1_i, Y_j)
        * e(sum_i r_i (-s2_i), g),

    so the verkey's points X, Y_j and g are fixed inputs and all
    per-credential work is q+2 shared-point MSMs over the signature group
    (grouped_accumulators). A forged credential passes with probability
    <= 2^-128.

    s1/s2n: sigma_1 and -sigma_2 coordinate pairs [B] (B a power of two);
    inf1/inf2: their identity masks (any identity fails the batch);
    cmag/csgn [q+1, B, 43]: signed 6-bit digits of r_i, then r_i m_ij mod
    R; rmag/rsgn [1, B, 23]: r_i's; ox/oy [q+1]: X_tilde then Y_tilde_j,
    affine; gtx/gty: g_tilde. Returns bool [] on the device."""
    sig_fl = _fields(sig_is_g1)[0]
    allacc = grouped_accumulators(sig_fl, s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn)
    return grouped_tail(sig_is_g1, allacc, ox, oy, gtx, gty, (inf1 | inf2).any())


def _pack_pts(pts):
    """(x, y) affine coordinate trees -> the same trees of uint8 [..., 48]
    canonical digits (fp.pack_canon48), every leaf of every point packed by
    ONE carry scan. The contract holds for the programs' outputs: G1
    coordinates are fp.mul outputs (|limb| <= 132, |value| < 0.66p), G2
    ones 2- and 3-term sums of them (|limb| <= 396, |value| < 1.98p)."""
    leaves = tw.leaves(pts)
    rows = [t.reshape(-1, t.shape[-1]) for t in leaves]
    packed = iter(torch.split(fp.pack_canon48(torch.cat(rows)), [r.shape[0] for r in rows]))
    return tw.tree_map(lambda t: next(packed).reshape(t.shape[:-1] + (fp.CANON_BYTES,)), pts)


def msm_shared_many_program(fl, jobs):
    """Several shared-base comb MSMs in one program: jobs [(wtables, mag,
    sgn)] -> [(x, y, inf)] a job, the affine results packed to uint8
    digits. Jobs over the same tables run as one comb MSM over their
    stacked lanes, and every job's accumulator shares one to_affine and one
    pack; each lane's limbs are those of a job alone."""
    by_tables = {}
    for n, (wt, _, _) in enumerate(jobs):
        by_tables.setdefault(id(wt), []).append(n)
    parts = [None] * len(jobs)
    for idxs in by_tables.values():
        wt = jobs[idxs[0]][0]
        mag = torch.cat([jobs[n][1] for n in idxs])
        sgn = torch.cat([jobs[n][2] for n in idxs])
        acc = cv.msm_shared_comb(fl, wt, mag, sgn)
        off = 0
        for n in idxs:
            size = jobs[n][1].shape[0]
            parts[n] = tw.tree_map(lambda t: t[off : off + size], acc)
            off += size
    acc = tw.tree_map(lambda *ts: torch.cat(ts), *parts)
    x, y, inf = cv.to_affine(fl, acc)
    x, y = _pack_pts((x, y))
    outs, off = [], 0
    for _, mag, _ in jobs:
        size = mag.shape[0]
        outs.append(PackedPoints(tw.tree_map(lambda t: t[off : off + size], (x, y, inf))))
        off += size
    return outs


def _distinct_acc(fl, x, y, inf, mag, sgn, window):
    """The distinct MSM's projective accumulator on the Horner schedule
    (window None: signed 5-bit digits) or the bucketed one at `window`."""
    x, y = _pts_f32((x, y))
    if window is None:
        return cv.msm_distinct_signed(fl, x, y, inf, mag, sgn)
    return cv.msm_distinct_bucketed(fl, x, y, inf, mag, sgn, window)


def _affine_packed(fl, acc):
    ax, ay, ainf = cv.to_affine(fl, acc)
    return PackedPoints(_pack_pts((ax, ay)) + (ainf,))


def msm_distinct_affine_program(fl, x, y, inf, mag, sgn, window=None):
    """Distinct-base MSM program: per-row points x, y, inf [B, k] (wire or
    field limbs), signed digits mag/sgn [B, k, nwin] -> PackedPoints [B],
    the affine results packed to uint8 digits. `window` None runs the
    Horner schedule (curve.msm_distinct_signed, 5-bit digits); an int runs
    the bucketed one at that window (curve.msm_distinct_bucketed)."""
    return _affine_packed(fl, _distinct_acc(fl, x, y, inf, mag, sgn, window))


def msm_distinct_plus_offset_program(fl, x, y, inf, mag, sgn, offset, window=None):
    """affine(offset_i + MSM_i): the distinct MSM of msm_distinct_affine_program
    with a per-lane affine offset added before the affine conversion.
    `offset` is another program's PackedPoints [B] (one job of a
    shared-many handle), consumed on the device through _unpack_pt: the
    prepare step's c2 = pk^k + h^m is assembled here instead of on the
    host."""
    acc = _distinct_acc(fl, x, y, inf, mag, sgn, window)
    ox, oy, oinf = _unpack_pt(offset)
    off = cv.affine_to_jacobian(fl, ox, oy, oinf)
    return _affine_packed(fl, cv.jadd(fl, acc, off))


def hash_to_g1_program(u_digits, u_par):
    """The device half of hash_to_g1: u_digits uint8 [B, 2, 48] raw
    canonical (standard-domain) digits of the two field candidates of each
    message, u_par bool [B, 2] their sgn0 bits from the host. Enters the
    Montgomery domain (fp.to_mont), maps both candidates stacked
    (curve.svdw_map_fp), adds them with one complete add, clears the
    cofactor (curve.scalar_mul_static), then one affine and the packed
    readback -> PackedPoints [B]. Bit-identical to ops.hashing.hash_to_g1."""
    u = fp.to_mont(u_digits)  # [B, 2, L]
    x, y = cv.svdw_map_fp(u, u_par)
    ones = fp.ones_mont(u_par.shape, u.device)
    p0, p1 = ((x[:, i], y[:, i], ones[:, i]) for i in range(2))
    h = cv.scalar_mul_static(cv.FP, cv.jadd(cv.FP, p0, p1), G1_COFACTOR)
    return _affine_packed(cv.FP, h)


def _decode_points(x, y, inf):
    """A program's packed affine output -> spec points (None = identity)."""
    xs, ys = tw.decode_batch(x), tw.decode_batch(y)
    return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, inf.cpu().tolist())]


class TorchBackend:
    """Batched PyTorch/CUDA backend with the verify, show-verify and
    CurveBackend MSM surface of JaxBackend.

    Reads its inputs by duck typing: sig.sigma_1 / sig.sigma_2 (affine int
    tuples or None), the proof fields of encode_show_verify_batch,
    vk.X_tilde / vk.Y_tilde, params.g, params.g_tilde and params.ctx.name —
    the JAX package's own objects work unchanged.

    device: `cuda` by default (raises without a card); `cpu` runs the
    plain PyTorch multiply. comb_window: signed comb window, 9 on cuda
    (29 windows, 257-entry tables), 6 on cpu (43 / 33). raw_wire: ship
    points as 48 raw bytes per Fp and enter the Montgomery domain on the
    device (default on cuda) instead of as int16 balanced limbs.

    `bucket_mode` is the distinct MSMs' schedule: bucket_mode(device) at
    construction ("auto" on cuda, "off" on cpu, or COCONUT_MSM_WINDOW's);
    assign "auto", "off" or a window 2..8 to change it.

    Counters: `combined_checks` (calls of the combined methods),
    `grouped_checks` (calls of the grouped methods), `final_exps`
    (final-exponentiation lanes: B a batch on the exact paths, one a
    combined or grouped check), `msm_horner_dispatches` /
    `msm_bucketed_dispatches` (distinct-MSM programs by schedule, the
    plus-offset ones included; `msm_bucket_window` is the last bucketed
    window), `msm_offset_dispatches` (plus-offset programs) and
    `device_hash_batches` / `device_hash_points` (hash_to_g1 programs and
    their messages)."""

    name = "torch"

    _COMB_CACHE_MAX = 64
    _STATIC_CACHE_MAX = 32

    def __init__(self, device=None, comb_window=None, raw_wire=None):
        self.device = resolve_device(device)
        on_cpu = self.device.type == "cpu"
        window = comb_window if comb_window is not None else (6 if on_cpu else 9)
        if not 1 <= window <= 9:
            raise ValueError("comb_window=%r unsupported (1..9)" % (window,))
        self.window, self.nwin, self.entries = comb_schedule(window)
        self.raw_wire = (not on_cpu) if raw_wire is None else bool(raw_wire)
        self._comb_cache = _LRU(self._COMB_CACHE_MAX)
        self._static_cache = _LRU(self._STATIC_CACHE_MAX)
        self.encode_cache_hits = 0
        self.encode_cache_misses = 0
        self.bucket_mode = bucket_mode(self.device)
        self.combined_checks = 0
        self.grouped_checks = 0
        self.final_exps = 0
        self.msm_horner_dispatches = 0
        self.msm_bucketed_dispatches = 0
        self.msm_bucket_window = None
        self.msm_offset_dispatches = 0
        self.device_hash_batches = 0
        self.device_hash_points = 0

    # -- point encoding ------------------------------------------------------

    def _encode_g1_points(self, points):
        xs = [(0 if p is None else p[0]) for p in points]
        ys = [(0 if p is None else p[1]) for p in points]
        inf = torch.from_numpy(np.array([p is None for p in points])).to(self.device)
        return self._encode_coords(xs, ys), inf

    def _encode_g2_points(self, points):
        zero2 = (0, 0)
        xs = [(zero2 if p is None else p[0]) for p in points]
        ys = [(zero2 if p is None else p[1]) for p in points]
        inf = torch.from_numpy(np.array([p is None for p in points])).to(self.device)
        return self._encode_coords(xs, ys), inf

    def _encode_sigs(self, params, sigma_1s, sigma_2s):
        """sigma_1 and -sigma_2 of each lane, in the signature group of
        whichever assignment params.ctx names -> (s1, s2n, inf1, inf2): the
        per-batch half of an encode."""
        if params.ctx.name == "G1":
            enc, neg = self._encode_g1_points, _g1.neg
        else:
            enc, neg = self._encode_g2_points, _g2.neg
        s1, inf1 = enc(sigma_1s)
        s2n, inf2 = enc([None if p is None else neg(p) for p in sigma_2s])
        return s1, s2n, inf1, inf2

    def _encode_coords(self, xs, ys):
        if self.raw_wire:
            return (
                tw.encode_raw_batch(xs, self.device),
                tw.encode_raw_batch(ys, self.device),
            )
        return (
            tw.encode_batch(xs, self.device, dtype=np.int16),
            tw.encode_batch(ys, self.device, dtype=np.int16),
        )

    def _encode_gt(self, params):
        """g_tilde (the other group's generator of params), invariant per
        params: an Fp2 pair under G1, an Fp pair under G2."""
        gt = params.g_tilde
        if params.ctx.name == "G1":
            enc = lambda c: tw.fp2_encode_const(c, self.device)
        else:
            enc = lambda c: torch.from_numpy(fp_encode(c)).to(self.device)
        return enc(gt[0]), enc(gt[1])

    # -- caches --------------------------------------------------------------

    def _comb_tables(self, is_fp2, bases):
        """Per-base-set comb tables in G2 (is_fp2) or G1, LRU-cached (the
        hot users verify many batches under one verkey)."""
        key = (self.window, is_fp2, tuple(bases), device_slot(self.device))
        wt = self._comb_cache.get(key)
        if wt is None:
            spec, fl = (_g2, cv.FP2) if is_fp2 else (_g1, cv.FP)
            t_e = _build_tables(spec, bases, self.entries, self.device)
            wt = cv.build_comb_tables(fl, t_e, self.nwin, self.window)
            self._comb_cache.put(key, wt)
        return wt

    def _static_operands(self, kind, vk, params, extra, build):
        """The per-(verkey, params) invariant half of an encode, LRU-cached
        under the program kind ("verify" / "show" / "grouped"), the verkey
        and params coordinate ints, the comb window and `extra` (the show
        path's revealed-index set): each program and each revealed set gets
        its own entry, as in the reference — and each card its own
        (`device_slot`)."""
        key = (
            kind,
            params.ctx.name,
            vk.X_tilde,
            tuple(vk.Y_tilde),
            params.g,
            params.g_tilde,
            self.window,
            extra,
            device_slot(self.device),
        )
        val = self._static_cache.get(key)
        if val is not None:
            self.encode_cache_hits += 1
            return val
        self.encode_cache_misses += 1
        val = build()
        self._static_cache.put(key, val)
        return val

    def _comb_digits(self, scalars_batch):
        """Signed digits on the backend's comb schedule."""
        return _signed_digits(
            scalars_batch, self.device, nwin=self.nwin, window=self.window
        )

    # -- fused hot path ------------------------------------------------------

    def encode_verify_batch(self, sigs, messages_list, vk, params):
        """Host-side encoding of a verify batch into the fused operand tuple
        (wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2), under either
        signature assignment."""
        is_g1 = params.ctx.name == "G1"

        def build():
            bases = [vk.X_tilde] + list(vk.Y_tilde)
            return (self._comb_tables(is_g1, bases),) + self._encode_gt(params)

        wtables, gtx, gty = self._static_operands("verify", vk, params, None, build)
        mag, sgn = self._comb_digits(
            [[1] + [m % R for m in msgs] for msgs in messages_list]
        )
        s1, s2n, inf1, inf2 = self._encode_sigs(
            params, [s.sigma_1 for s in sigs], [s.sigma_2 for s in sigs]
        )
        return (wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2)

    def batch_verify_async(self, sigs, messages_list, vk, params):
        """Encode and enqueue the fused verify on the device; returns a
        zero-arg finalizer that waits for the bits."""
        if not sigs:
            return lambda: []
        operands = self.encode_verify_batch(sigs, messages_list, vk, params)
        bits = fused_verify(params.ctx.name == "G1", *operands)
        self.final_exps += len(sigs)
        return _finalizer(bits)

    def batch_verify(self, sigs, messages_list, vk, params):
        """Fully fused batched PS verification: one bool per credential."""
        return self.batch_verify_async(sigs, messages_list, vk, params)()

    def encode_show_verify_batch(
        self, proofs, vk, params, revealed_msgs_list, challenges
    ):
        """Host-side encoding of a show-verify batch into the
        fused_show_verify operand tuple (everything after sig_is_g1).

        Reads proofs by duck typing: p.sigma_prime_1, p.sigma_prime_2, p.J,
        p.proof_vc.t, p.proof_vc.responses, p.revealed_msg_indices; the
        revealed set is proofs[0]'s. revealed_msgs_list holds one
        {index: message} map per proof. J, t and the comb tables are in the
        other group of params.ctx: G2 under "G1", G1 under "G2"."""
        is_g1 = params.ctx.name == "G1"
        enc_other = self._encode_g2_points if is_g1 else self._encode_g1_points
        shown = proofs[0].revealed_msg_indices
        revealed = sorted(shown)
        hidden = [i for i in range(len(vk.Y_tilde)) if i not in shown]

        def build():
            vc_bases = [params.g_tilde] + [vk.Y_tilde[i] for i in hidden]
            acc_bases = [vk.X_tilde] + [vk.Y_tilde[i] for i in revealed]
            return (
                self._comb_tables(is_g1, vc_bases),
                self._comb_tables(is_g1, acc_bases),
            ) + self._encode_gt(params)

        vc_wtables, acc_wtables, gtx, gty = self._static_operands(
            "show", vk, params, tuple(revealed), build
        )

        # Schnorr operands
        resp_mag, resp_sgn = self._comb_digits(
            [[r % R for r in p.proof_vc.responses] for p in proofs]
        )
        jpt, jinf = enc_other([p.J for p in proofs])
        cmag_j, csgn_j = _signed_digits([[c % R] for c in challenges], self.device)
        (commx, commy), comminf = enc_other([p.proof_vc.t for p in proofs])

        # pairing operands
        acc_mag, acc_sgn = self._comb_digits(
            [[1] + [rm[i] % R for i in revealed] for rm in revealed_msgs_list]
        )
        s1, s2n, inf1, inf2 = self._encode_sigs(
            params, [p.sigma_prime_1 for p in proofs], [p.sigma_prime_2 for p in proofs]
        )
        return (
            vc_wtables, resp_mag, resp_sgn, jpt, jinf, cmag_j, csgn_j,
            commx, commy, comminf, acc_wtables, acc_mag, acc_sgn,
            s1, s2n, gtx, gty, inf1, inf2,
        )

    def batch_show_verify_async(
        self, proofs, vk, params, revealed_msgs_list, challenges
    ):
        """Encode and enqueue the fused show verify on the device; returns a
        zero-arg finalizer that waits for the bits."""
        if not proofs:
            return lambda: []
        operands = self.encode_show_verify_batch(
            proofs, vk, params, revealed_msgs_list, challenges
        )
        bits = fused_show_verify(params.ctx.name == "G1", *operands)
        self.final_exps += len(proofs)
        return _finalizer(bits)

    def batch_show_verify(self, proofs, vk, params, revealed_msgs_list, challenges):
        """Batched selective-disclosure proof verification (BASELINE config
        3): one bool per proof. All proofs must share proofs[0]'s
        revealed-index set; the protocol layer recomputes the Fiat-Shamir
        challenges and verifies ragged batches proof by proof."""
        return self.batch_show_verify_async(
            proofs, vk, params, revealed_msgs_list, challenges
        )()

    # -- CurveBackend MSM primitives ----------------------------------------

    def _msm_shared_many_dispatch(self, is_fp2, jobs):
        """Encode and enqueue the shared-base MSMs of `jobs` [(bases [k],
        scalars [B][k])] as ONE program (the comb tables from the LRU, so
        the prover's tables over [g_tilde, hidden Y_tilde] are the
        verifier's Schnorr tables); returns its handle without waiting."""
        operands = [
            (self._comb_tables(is_fp2, bases),) + self._comb_digits(scalars_batch)
            for bases, scalars_batch in jobs
        ]
        return msm_shared_many_program(cv.FP2 if is_fp2 else cv.FP, operands)

    @staticmethod
    def msm_shared_many_wait(handle):
        """Wait for a shared-many handle -> one list of spec points a job."""
        return [_decode_points(*out) for out in handle]

    def msm_g1_shared_many_async(self, jobs):
        return self._msm_shared_many_dispatch(False, jobs)

    def msm_g2_shared_many_async(self, jobs):
        return self._msm_shared_many_dispatch(True, jobs)

    def msm_g1_shared_many(self, jobs):
        """jobs [(bases, scalars_batch)] -> per-job lists of G1 points."""
        return self.msm_shared_many_wait(self.msm_g1_shared_many_async(jobs))

    def msm_g2_shared_many(self, jobs):
        return self.msm_shared_many_wait(self.msm_g2_shared_many_async(jobs))

    def msm_g1_shared(self, bases, scalars_batch):
        """sum_j scalars[i][j] * bases[j] in G1 for each row i -> [B]
        affine points (None = identity)."""
        return self.msm_g1_shared_many([(bases, scalars_batch)])[0]

    def msm_g2_shared(self, bases, scalars_batch):
        return self.msm_g2_shared_many([(bases, scalars_batch)])[0]

    def _encode_distinct(self, is_fp2, points_batch, scalars_batch, window=5):
        """Distinct-MSM operands (x, y, inf [B, k'], mag, sgn [B, k', nwin]).
        G1 splits each scalar by GLV over (P, phi(P)) (k' = 2k, the 128-bit
        halves; the points must lie in the r-order subgroup); G2 runs over
        the 255-bit Fr (k' = k). Signed `window`-bit digits, nwin =
        ceil(bits / window) + 1: 27 / 52 windows at the Horner schedule's
        5 bits, the bucketed schedule's window otherwise."""
        B = len(points_batch)
        k = len(points_batch[0])
        if any(len(row) != k for row in points_batch):
            raise ValueError("ragged distinct-MSM batch")
        if is_fp2:
            bits = 255
        else:
            points_batch = [[q for p in row for q in (p, glv.phi(p))] for row in points_batch]
            scalars_batch = [[h for s in row for h in glv.decompose(s)] for row in scalars_batch]
            k *= 2
            bits = glv.HALF_BITS
        flat = [p for row in points_batch for p in row]
        enc = self._encode_g2_points if is_fp2 else self._encode_g1_points
        (x, y), inf = enc(flat)
        x, y = tw.tree_map(lambda t: t.reshape((B, k) + t.shape[1:]), (x, y))
        mag, sgn = _signed_digits(
            scalars_batch, self.device, nwin=-(-bits // window) + 1, window=window
        )
        return x, y, inf.reshape(B, k), mag, sgn

    def _distinct_window(self, is_fp2, points_batch):
        """The schedule of a distinct-MSM batch: None for Horner, else the
        bucketed window (_bucket_window over the post-GLV base count and
        scalar width)."""
        k0 = len(points_batch[0]) if points_batch else 0
        if is_fp2:
            return _bucket_window(k0, 255, self.bucket_mode)
        return _bucket_window(2 * k0, glv.HALF_BITS, self.bucket_mode)

    def _distinct_operands(self, is_fp2, points_batch, scalars_batch):
        """(window, operands) of a distinct MSM on its schedule, counted."""
        w = self._distinct_window(is_fp2, points_batch)
        if w is None:
            self.msm_horner_dispatches += 1
            return None, self._encode_distinct(is_fp2, points_batch, scalars_batch)
        self.msm_bucketed_dispatches += 1
        self.msm_bucket_window = w
        return w, self._encode_distinct(is_fp2, points_batch, scalars_batch, window=w)

    def _msm_distinct_dispatch(self, is_fp2, points_batch, scalars_batch):
        w, ops = self._distinct_operands(is_fp2, points_batch, scalars_batch)
        return msm_distinct_affine_program(cv.FP2 if is_fp2 else cv.FP, *ops, window=w)

    @staticmethod
    def msm_distinct_wait(handle):
        """Wait for a distinct-MSM handle -> [B] spec points."""
        return _decode_points(*handle)

    def msm_g1_distinct_async(self, points_batch, scalars_batch):
        return self._msm_distinct_dispatch(False, points_batch, scalars_batch)

    def msm_g2_distinct_async(self, points_batch, scalars_batch):
        return self._msm_distinct_dispatch(True, points_batch, scalars_batch)

    def msm_g1_distinct(self, points_batch, scalars_batch):
        """sum_j scalars[i][j] * points[i][j] in G1 per row i (rows of one
        length) -> [B] affine points."""
        return self.msm_distinct_wait(self.msm_g1_distinct_async(points_batch, scalars_batch))

    def msm_g2_distinct(self, points_batch, scalars_batch):
        return self.msm_distinct_wait(self.msm_g2_distinct_async(points_batch, scalars_batch))

    def _msm_distinct_plus_offset(self, is_fp2, points_batch, scalars_batch, offset_handle):
        w, ops = self._distinct_operands(is_fp2, points_batch, scalars_batch)
        self.msm_offset_dispatches += 1
        return msm_distinct_plus_offset_program(
            cv.FP2 if is_fp2 else cv.FP, *ops, offset_handle, window=w
        )

    def msm_g1_distinct_plus_offset_async(self, points_batch, scalars_batch, offset_handle):
        """affine(offset_i + MSM_i), `offset_handle` a PackedPoints triple
        of shape [B] (one job of a msm_g1_shared_many_async handle),
        consumed on the device. Settle with msm_distinct_wait."""
        return self._msm_distinct_plus_offset(False, points_batch, scalars_batch, offset_handle)

    def msm_g2_distinct_plus_offset_async(self, points_batch, scalars_batch, offset_handle):
        return self._msm_distinct_plus_offset(True, points_batch, scalars_batch, offset_handle)

    # -- device hash-to-G1 ---------------------------------------------------

    def device_hash_enabled(self):
        """Whether protocol callers hash to G1 on this backend's device: on
        `cuda`, not on `cpu` (there the host spec hashes, as on the
        reference's CPU)."""
        return self.device.type == "cuda"

    def hash_to_g1_async(self, datas, dst=None):
        """Enqueue hash_to_g1 of a batch of messages: expand_message_xmd on
        the host (SHA-256), the two reduced field candidates of each
        message uploaded as raw digits with their sgn0 bits
        (hash_operands), the map, add and cofactor clear as one program
        (hash_to_g1_program). Settle with hash_to_g1_wait."""
        self.device_hash_batches += 1
        self.device_hash_points += len(datas)
        return hash_to_g1_program(*self.hash_operands(datas, dst))

    def hash_operands(self, datas, dst=None):
        """The host half of hash_to_g1: each message's two field candidates
        (expand_message_xmd, 128 bytes, reduced mod p) as uint8 [B, 2, 48]
        raw digits and their sgn0 bits bool [B, 2], on the device."""
        dst = DST_G1 if dst is None else dst
        us = []
        for m in datas:
            b = expand_message_xmd(m, dst, 128)
            us.append(int.from_bytes(b[:64], "big") % P)
            us.append(int.from_bytes(b[64:], "big") % P)
        B = len(datas)
        dig = torch.from_numpy(fp_encode_raw_batch(us).reshape(B, 2, -1).copy())
        par = torch.from_numpy(np.array([u & 1 for u in us], dtype=bool).reshape(B, 2))
        return dig.to(self.device), par.to(self.device)

    @staticmethod
    def hash_to_g1_wait(handle):
        """Wait for a hash_to_g1_async handle -> [B] affine points. Raises
        as the spec does on the identity output (probability ~2^-255)."""
        if bool(handle[2].any()):
            raise ValueError("hash_to_g1 hit the identity (probability ~2^-255)")
        return _decode_points(*handle)

    def hash_to_g1_batch(self, datas, dst=None):
        """Synchronous device hash-to-G1 (dispatch and wait)."""
        if not datas:
            return []
        return self.hash_to_g1_wait(self.hash_to_g1_async(datas, dst))

    # -- combined (RLC) checks ----------------------------------------------

    def _combiners(self, rs, n, transcript):
        """`rs` as given (its count checked), or n combiners derived from
        the batch transcript (built only then)."""
        if rs is None:
            return derive_combiners(transcript(), n)
        if len(rs) != n:
            raise ValueError(
                "combiner count mismatch: %d exponents, %d lanes" % (len(rs), n)
            )
        return list(rs)

    def _combined_dispatch(self, sigs, messages_list, vk, params, rs, epoch):
        """Encode and enqueue the combined verify; returns the device bool.
        Derives the combiners from the batch transcript when `rs` is None,
        then pads to a power of two with clones of lane 0, each reusing r_0
        (lane 0's total exponent r_0 (1 + pad) stays nonzero mod R).
        Callers have rejected empty batches and identity sigmas."""
        B = len(sigs)
        rs = self._combiners(
            rs, B,
            lambda: verify_transcript(sigs, messages_list, vk, params, epoch=epoch),
        )
        pad = _pow2_lanes(B) - B
        sigs = list(sigs) + [sigs[0]] * pad
        messages_list = list(messages_list) + [messages_list[0]] * pad
        rs = rs + [rs[0]] * pad
        wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = self.encode_verify_batch(
            sigs, messages_list, vk, params
        )
        rmag, rsgn = _combiner_digits(rs, self.device)
        ok = fused_verify_combined(
            params.ctx.name == "G1", wtables, mag, sgn, s1, s2n, rmag, rsgn,
            gtx, gty, inf1, inf2,
        )
        self.final_exps += 1
        return ok

    def batch_verify_combined_async(
        self, sigs, messages_list, vk, params, rs=None, epoch=None
    ):
        """Enqueue the combined verify of the whole batch; returns a
        zero-arg finalizer that waits for its ONE bool. An empty batch is
        True (the empty product), a batch holding an identity sigma False
        (rejected on the host, before any transcript)."""
        self.combined_checks += 1
        if not sigs:
            return lambda: True
        if any(s.sigma_1 is None or s.sigma_2 is None for s in sigs):
            return lambda: False
        ok = self._combined_dispatch(sigs, messages_list, vk, params, rs, epoch)
        return lambda: bool(ok)

    def batch_verify_combined(
        self, sigs, messages_list, vk, params, rs=None, epoch=None
    ):
        """ONE bool for the whole batch by small-exponents combination
        (fused_verify_combined): B+1 Miller pairs and one final
        exponentiation. A forged credential passes with probability <=
        2^-lambda over the combiners, which `rs=None` derives from the
        batch transcript (batchverify.derive_combiners, the JAX package's
        draw); pass `rs` to pin them. `epoch` joins the transcript's domain
        separation."""
        return self.batch_verify_combined_async(
            sigs, messages_list, vk, params, rs=rs, epoch=epoch
        )()

    def batch_show_verify_combined(
        self, proofs, vk, params, revealed_msgs_list, challenges, rs=None,
        epoch=None,
    ):
        """Combined show verify -> (per-lane Schnorr bits, ONE batch
        pairing bool); a lane's verdict is bits[i] & pairing. The combiners
        come as in batch_verify_combined (from show_transcript; a dead
        proof is absorbed with its identity sigma' as zero bytes). Padding
        clones lane 0 with its challenge and combiner. All proofs share
        proofs[0]'s revealed-index set."""
        self.combined_checks += 1
        B = len(proofs)
        if B == 0:
            return [], True
        rs = self._combiners(
            rs, B,
            lambda: show_transcript(
                proofs, vk, params, revealed_msgs_list, challenges, epoch=epoch
            ),
        )
        pad = _pow2_lanes(B) - B
        proofs = list(proofs) + [proofs[0]] * pad
        revealed_msgs_list = list(revealed_msgs_list) + [revealed_msgs_list[0]] * pad
        challenges = list(challenges) + [challenges[0]] * pad
        rs = rs + [rs[0]] * pad
        ops = self.encode_show_verify_batch(
            proofs, vk, params, revealed_msgs_list, challenges
        )
        rmag, rsgn = _combiner_digits(rs, self.device)
        bits, pair_ok = fused_show_verify_combined(
            # ops[:15] ends with s1, s2n; ops[15:] is gtx, gty, inf1, inf2
            params.ctx.name == "G1", *ops[:15], rmag, rsgn, *ops[15:]
        )
        self.final_exps += 1
        return [bool(b) for b in bits.cpu().tolist()[:B]], bool(pair_ok)

    # -- attribute-grouped check ---------------------------------------------

    @staticmethod
    def _validate_grouped_inputs(sigs, messages_list, vk):
        B = len(sigs)
        q = len(vk.Y_tilde)
        if len(messages_list) != B:
            raise ValueError(
                "batch size mismatch: %d sigs, %d message vectors"
                % (B, len(messages_list))
            )
        for msgs in messages_list:
            if len(msgs) != q:
                raise ValueError(
                    "message vector length %d != msg_count %d" % (len(msgs), q)
                )

    def encode_grouped_batch(self, sigs, messages_list, vk, params):
        """Host-side encoding of a grouped verify batch into the
        fused_verify_grouped operand tuple (everything after sig_is_g1):
        pads the batch to a power of two with clones of lane 0, draws the
        combiners r_i from the CSPRNG (`secrets`, as the reference does:
        they are the check's soundness), builds the scalar rows r_i and
        r_i m_ij mod R and recodes them on the signed 6-bit / 43-window
        schedule. Callers have rejected empty batches and identity
        sigmas."""
        B = len(sigs)
        q = len(vk.Y_tilde)
        Bp = _pow2_lanes(B)
        pad = Bp - B
        sigs = list(sigs) + [sigs[0]] * pad
        messages_list = list(messages_list) + [messages_list[0]] * pad
        rs = [secrets.randbits(_R_RAND_BITS) for _ in range(Bp)]
        rows = [rs] + [
            [r * (msgs[j] % R) % R for r, msgs in zip(rs, messages_list)]
            for j in range(q)
        ]
        recoded = [fr_digits_signed_np(row, nwin=_G_NWIN, window=_G_WINDOW) for row in rows]
        # r_i have _R_RAND_BITS bits, so only the last _G_RNWIN msb-first
        # windows of the r-row may be nonzero; a wider draw must not lose
        # its top windows
        if recoded[0][0][:, : _G_NWIN - _G_RNWIN].any():
            raise ValueError(
                "combiner scalar exceeds %d bits: top windows nonzero" % _R_RAND_BITS
            )
        cmag = torch.from_numpy(np.stack([m for m, _ in recoded])).to(self.device)
        csgn = torch.from_numpy(np.stack([g for _, g in recoded])).to(self.device)
        rmag = cmag[:1, :, _G_NWIN - _G_RNWIN :]
        rsgn = csgn[:1, :, _G_NWIN - _G_RNWIN :]
        s1, s2n, inf1, inf2 = self._encode_sigs(
            params, [s.sigma_1 for s in sigs], [s.sigma_2 for s in sigs]
        )

        def build():
            others = [vk.X_tilde] + list(vk.Y_tilde)
            ox = tw.encode_batch([p[0] for p in others], self.device)
            oy = tw.encode_batch([p[1] for p in others], self.device)
            return (ox, oy) + self._encode_gt(params)

        ox, oy, gtx, gty = self._static_operands("grouped", vk, params, None, build)
        return (s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn, ox, oy, gtx, gty)

    def batch_verify_grouped_async(self, sigs, messages_list, vk, params):
        """Enqueue the grouped verify of the whole batch; returns a zero-arg
        finalizer that waits for its ONE bool. Mismatched inputs raise; an
        empty batch is True and a batch holding an identity sigma False,
        both before any device work."""
        self._validate_grouped_inputs(sigs, messages_list, vk)
        self.grouped_checks += 1
        if not sigs:
            return lambda: True
        if any(s.sigma_1 is None or s.sigma_2 is None for s in sigs):
            return lambda: False
        operands = self.encode_grouped_batch(sigs, messages_list, vk, params)
        ok = fused_verify_grouped(params.ctx.name == "G1", *operands)
        self.final_exps += 1
        return lambda: bool(ok)

    def batch_verify_grouped(self, sigs, messages_list, vk, params):
        """ONE bool for the whole batch by the attribute-grouped
        combination (fused_verify_grouped): q+2 Miller pairs and one final
        exponentiation whatever B is, all per-credential work in
        shared-point MSMs over the signature group. A forged credential
        passes with probability <= 2^-128."""
        return self.batch_verify_grouped_async(sigs, messages_list, vk, params)()

    # -- generic pairing product --------------------------------------------

    def pairing_product_is_one(self, pairs_batch):
        """[[(P in G1 or None, Q in G2 or None), ...] per row] -> one bool
        per row: prod e(P, Q) == 1. Rows must have one length; a None point
        makes its pair the identity factor."""
        B = len(pairs_batch)
        n = len(pairs_batch[0])
        if any(len(row) != n for row in pairs_batch):
            raise ValueError("ragged pairing batch")
        (px, py), pinf = self._encode_g1_points([p for row in pairs_batch for p, _ in row])
        (qx, qy), qinf = self._encode_g2_points([q for row in pairs_batch for _, q in row])
        reshape = lambda t: t.reshape((B, n) + t.shape[1:])
        px, py, qx, qy = _pts_f32(tw.tree_map(reshape, (px, py, qx, qy)))
        valid = ~(pinf | qinf).reshape(B, n)
        self.final_exps += B
        return _finalizer(pr.pairing_product_is_one(px, py, qx, qy, valid))()


def _finalizer(bits):
    """Zero-arg function that waits for a device bool [B] and returns it as
    a list of Python bools."""
    return lambda: [bool(b) for b in bits.cpu().tolist()]
