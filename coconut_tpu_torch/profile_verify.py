"""Where the time of one batched verify or show verify goes, on the GPU.

    python3 -m coconut_tpu_torch.profile_verify
        [--path verify|show|verify_combined|show_combined|grouped|prove|issue]
        [--batch 1024] [--out FILE]

Builds the path's entry fixture (B credentials, 6 attributes, one lane in 8
forged; for `show`, shows revealing attributes {2, 3, 4, 5}; the combined
paths take the honest fixture, all lanes true, through ps.batch_verify /
ps.batch_show_verify in mode "batched"; `grouped` the honest fixture
through TorchBackend.batch_verify_grouped, one bool; `prove` the honest
fixture through pok_sig.batch_show, revealing {2, 3, 4, 5}, its proofs
checked by the spec verifier on 4 lanes; `issue` one threshold issuance
round under G1 on entry.issue_fixture: prepare, blind-sign by the 5
signers, unblind, aggregate over {1, 3, 5}, the credentials verified on the
card), warms TorchBackend up once, then measures a warm batch three ways:

  stages    host wall time (synchronized) and kernel launches of each stage
            of the path: for `verify` host encode, comb MSM, affine
            normalization, Miller loop, final exponentiation, GT == 1
            test; for `show` host encode, the Schnorr comb MSM, the
            distinct MSM J^c, the Schnorr affine normalization and compare,
            the pairing comb MSM + the add of J, then affine, Miller, final
            exponentiation and GT test as for `verify`; for the combined
            paths the same front (encode with the combiners' transcript and
            digits, comb MSM, for show the Schnorr stages), then the
            accumulator's affine, the two r-MSMs over G1, the fold of the
            r (-sigma_2) points, the two G1 affines, the Miller loop over
            B+1 pairs, the tree fold of the Fp12 values, ONE final
            exponentiation and the test; for `grouped` host encode (the
            combiners, their digit rows and the sigma points), then for
            sigma_1 (q+1 MSMs) and for -sigma_2 (one MSM) the 33-entry
            table build, the gather and fold over B, and the Horner pass,
            then the affine of the q+2 accumulators, the Miller loop over
            q+2 pairs, the fold of the Fp12 values, ONE final
            exponentiation and the test; for `prove` the host draw and
            encode (the GLV split of the sigma scalars, the comb digits),
            the distinct MSM over G1 ([2B, 4] rows, 27 windows), the two
            comb MSMs over G2 (stacked into one), the affines of both, the
            pack of every coordinate (one carry scan), the decode, and
            Fiat-Shamir with the responses; for `issue` the prepare step's
            host draw and encode, the commitment and ElGamal programs, the
            commitments' readback, expand_message_xmd and the upload of
            the field candidates, the hash program, its readback, the h^m
            encode, the h^m + offset program and the decode of g^k and c2,
            then blind-sign (the 5 signers' encode, MSM and decode
            summed), unblind and aggregate; and the field kernel's
            launches of that batch by width (lanes);
  profile   torch.profiler over one warm batch: device time by kernel name,
            the field kernel's device time and launches, total device-busy
            time, and the device's idle share of the wall time;
  card      nvidia-smi's name and power limit.

Prints one JSON object (and writes it to --out when given). Needs a CUDA
card.
"""

import argparse
import json
import subprocess
import time

import torch

from . import entry, pok_sig, ps
from . import signature as sig
from .batchverify import derive_combiners, show_transcript, verify_transcript
from .gpu import cuda_fp
from .gpu import curve as cv
from .gpu import pairing as pr
from .gpu import tower as tw
from .gpu.backend import (
    _G_ENTRIES, TorchBackend, _combiner_digits, _decode_points, _grouped_horner,
    _grouped_tail_miller, _grouped_window_sums, _pack_pts, _pts_f32, _tree_fold_fp12,
    affine_stage, comb_msm_stage, hash_to_g1_program, miller_stage, msm_distinct_affine_program,
    msm_distinct_plus_offset_program, msm_shared_many_program,
)
from .ops.fields import R
from .sss import rand_fr


def _stage(fn):
    torch.cuda.synchronize()
    before = cuda_fp.LAUNCHES
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t0, "launches": cuda_fp.LAUNCHES - before}


def _tail_stages(out, acc, s1, s2n, gtx, gty, inf1, inf2, ok=None):
    """verify_tail's stages (G1 assignment), one after another, into `out`;
    `ok` is and-ed into the bits (the show path's Schnorr verdicts)."""
    pts, out["affine"] = _stage(lambda: affine_stage(True, acc, s1, s2n, gtx, gty))
    f, out["miller"] = _stage(lambda: miller_stage(True, pts, inf1, inf2))
    fe, out["final_exp"] = _stage(lambda: pr.final_exp(f))

    def is_one():
        bits = tw.fp12_is_one(fe) & ~inf1
        return (bits if ok is None else bits & ok).cpu().tolist()

    bits, out["is_one"] = _stage(is_one)
    return bits


def stages(be, sigs, msgs, vk, params):
    """The fused verify's stages, run one after another as fused_verify and
    verify_tail run them, each timed to a device synchronize."""
    out = {}
    ops, out["encode"] = _stage(lambda: be.encode_verify_batch(sigs, msgs, vk, params))
    wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = ops
    acc, out["comb_msm"] = _stage(lambda: comb_msm_stage(True, wtables, mag, sgn))
    return _tail_stages(out, acc, s1, s2n, gtx, gty, inf1, inf2), out


def _combined_tail_stages(out, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2):
    """The combined pairing half's stages (gpu.backend._combined_pairing),
    one after another, into `out`. Returns (the batch's pairing bool, dead
    lanes [B])."""
    fl = cv.FP
    B = inf1.shape[0]
    lift = lambda t: t[:, None]

    def affine():
        pts = _pts_f32((s1, s2n, gtx, gty))
        return pts, cv.to_affine(cv.FP2, acc)

    ((s1, s2n, gtx, gty), (ax, ay, ainf)), out["acc_affine"] = _stage(affine)
    (s1r, s2rn), out["r_msms"] = _stage(lambda: tuple(
        cv.msm_distinct_signed(fl, lift(p[0]), lift(p[1]), inf[:, None], rmag, rsgn)
        for p, inf in ((s1, inf1), (s2n, inf2))
    ))
    dead = inf1 | inf2 | ainf

    def fold():
        ident = cv.jinfinity(fl, (B,), dead.device)
        return cv.fold_points(
            fl, tuple(fl.select(dead, i_, c) for i_, c in zip(ident, s2rn)), B
        )

    s2sum, out["fold"] = _stage(fold)
    ((sx, sy, sinf), (zx, zy, zinf)), out["g1_affine"] = _stage(
        lambda: (cv.to_affine(fl, s1r), cv.to_affine(fl, s2sum))
    )

    def miller():
        cat = lambda a, b: tw.tree_map(lambda x, y: torch.cat([x, y[None]]), a, b)
        valid = torch.cat([~dead & ~sinf, ~zinf[None]])
        return pr.multi_miller_loop(
            *(tw.tree_map(lift, t) for t in (cat(sx, zx), cat(sy, zy), cat(ax, gtx), cat(ay, gty))),
            valid[:, None],
        )

    f, out["miller"] = _stage(miller)
    prod, out["tree_fold"] = _stage(lambda: tw.fp12_mul(
        _tree_fold_fp12(tw.tree_map(lambda t: t[:B], f), B),
        tw.tree_map(lambda t: t[B:], f),
    ))
    fe, out["final_exp"] = _stage(lambda: pr.final_exp(prod))
    ok, out["is_one"] = _stage(lambda: bool(tw.fp12_is_one(fe)[0]))
    return ok, dead


def combined_stages(be, sigs, msgs, vk, params):
    """The combined verify's stages (fused_verify_combined), B a power of
    two. The encode stage derives the combiners from the transcript."""
    out = {}

    def encode():
        rs = derive_combiners(verify_transcript(sigs, msgs, vk, params), len(sigs))
        return be.encode_verify_batch(sigs, msgs, vk, params), _combiner_digits(rs, be.device)

    (ops, (rmag, rsgn)), out["encode"] = _stage(encode)
    wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = ops
    acc, out["comb_msm"] = _stage(lambda: cv.msm_shared_comb(cv.FP2, wtables, mag, sgn))
    ok, dead = _combined_tail_stages(out, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2)
    return [ok and not bool(dead.any())] * len(sigs), out


def show_stages(be, proofs, vk, params, rmsgs, challenges):
    """The fused show verify's stages, run one after another as
    fused_show_verify runs them, each timed to a device synchronize. The
    wire points J and t enter the field arithmetic in the first device
    stage."""
    out = {}
    ops, out["encode"] = _stage(
        lambda: be.encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
    )
    schnorr_ok, acc = _schnorr_stages(out, ops)
    s1, s2n, gtx, gty, inf1, inf2 = ops[13:]
    bits = _tail_stages(out, acc, s1, s2n, gtx, gty, inf1, inf2, ok=schnorr_ok)
    return bits, out


def show_combined_stages(be, proofs, vk, params, rmsgs, challenges):
    """The combined show verify's stages (fused_show_verify_combined), B a
    power of two: the Schnorr stages of `show`, then the combined pairing
    half."""
    out = {}

    def encode():
        rs = derive_combiners(
            show_transcript(proofs, vk, params, rmsgs, challenges), len(proofs)
        )
        ops = be.encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
        return ops, _combiner_digits(rs, be.device)

    (ops, (rmag, rsgn)), out["encode"] = _stage(encode)
    schnorr_ok, acc = _schnorr_stages(out, ops)
    s1, s2n, gtx, gty, inf1, inf2 = ops[13:]
    ok, dead = _combined_tail_stages(out, acc, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2)
    bits = (schnorr_ok & ~dead).cpu().tolist()
    return [bool(b) and ok for b in bits], out


def grouped_stages(be, sigs, msgs, vk, params):
    """The grouped verify's stages (fused_verify_grouped), one after
    another, each timed to a device synchronize. Returns ([the batch's
    bool], stages)."""
    out = {}
    ops, out["encode"] = _stage(lambda: be.encode_grouped_batch(sigs, msgs, vk, params))
    s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn, ox, oy, gtx, gty = ops
    fl = cv.FP if params.ctx.name == "G1" else cv.FP2
    accs = []
    for name, pt, inf, mag, sgn in (("s1", s1, inf1, cmag, csgn), ("s2", s2n, inf2, rmag, rsgn)):
        tables, out[name + "_tables"] = _stage(
            lambda: cv.build_tables_device(fl, *_pts_f32(pt), inf, entries=_G_ENTRIES)
        )
        sums, out[name + "_gather_fold"] = _stage(
            lambda: _grouped_window_sums(fl, tables, mag, sgn)
        )
        acc, out[name + "_horner"] = _stage(lambda: _grouped_horner(fl, sums))
        accs.append(acc)

    def affine():
        allacc = tw.tree_map(lambda a, b: torch.cat([a, b]), *accs)
        return _pts_f32((ox, oy, gtx, gty)), cv.to_affine(fl, allacc)

    ((ox, oy, gtx, gty), (px, py, pinf)), out["acc_affine"] = _stage(affine)
    cat = lambda a, b: torch.cat([a, b[None]])
    qx, qy = tw.tree_map(cat, ox, gtx), tw.tree_map(cat, oy, gty)
    f, out["miller"] = _stage(
        lambda: _grouped_tail_miller(params.ctx.name == "G1", px, py, qx, qy, ~pinf)
    )
    npair = pinf.shape[0]
    pow2 = 1 << (npair - 1).bit_length()

    def fold():
        pad = tw.fp12_ones((pow2 - npair,), pinf.device)
        return _tree_fold_fp12(tw.tree_map(lambda a, b: torch.cat([a, b]), f, pad), pow2)

    prod, out["fold"] = _stage(fold)
    fe, out["final_exp"] = _stage(lambda: pr.final_exp(prod))
    ok, out["is_one"] = _stage(
        lambda: bool(tw.fp12_is_one(fe)[0] & ~(inf1 | inf2).any())
    )
    return [ok], out


def prove_stages(be, sigs, msgs, vk, params, revealed):
    """The batched prover's stages under G1 (pok_sig.batch_show over
    msm_distinct_affine_program and msm_shared_many_program), one after
    another, each timed to a device synchronize. Returns (proofs, stages)."""
    out = {}
    B = len(sigs)

    def encode():
        draw = pok_sig.prover_draw(B, len(vk.Y_tilde) - len(revealed))
        rows, scal, jobs = pok_sig.msm_inputs(sigs, vk, params, msgs, revealed, draw)
        dist = be._encode_distinct(False, rows, scal)
        wt = be._comb_tables(True, jobs[0][0])
        digits = be._comb_digits(jobs[0][1] + jobs[1][1])
        return draw, jobs, dist, wt, digits

    (draw, jobs, dist, wt, (mag, sgn)), out["encode"] = _stage(encode)
    x, y, inf, dmag, dsgn = dist
    sacc, out["distinct_msm"] = _stage(
        lambda: cv.msm_distinct_signed(cv.FP, *_pts_f32((x, y)), inf, dmag, dsgn)
    )
    cacc, out["comb_msms"] = _stage(lambda: cv.msm_shared_comb(cv.FP2, wt, mag, sgn))
    (saff, caff), out["affines"] = _stage(
        lambda: (cv.to_affine(cv.FP, sacc), cv.to_affine(cv.FP2, cacc))
    )
    packed, out["pack"] = _stage(lambda: _pack_pts((saff[:2], caff[:2])))

    def decode():
        sig_out = _decode_points(*packed[0], saff[2])
        comb = _decode_points(*packed[1], caff[2])
        return sig_out[:B], sig_out[B:], comb[:B], comb[B:]

    (s1p, s2p, Js, comms), out["decode"] = _stage(decode)
    res, out["fiat_shamir_responses"] = _stage(
        lambda: pok_sig.finish_proofs(
            params, jobs[0][0], s1p, s2p, Js, comms, draw, msgs, set(revealed)
        )
    )
    return res[0], out


def issue_stages(be, fix):
    """One G1 issuance round (batch_prepare_blind_sign's offset schedule,
    then batch_blind_sign by each signer, batch_unblind of all of them,
    batch_aggregate over {1, 3, 5}), stage by stage, each timed to a device
    synchronize. Returns (the credentials, stages)."""
    params, signers, esk, epk, msgs = fix
    ctx, B, H = params.ctx, len(msgs), entry.ISSUANCE_HIDDEN
    out = {}

    def draw_encode():
        rs = [rand_fr() for _ in range(B)]
        ks = [[rand_fr() for _ in range(H)] for _ in range(B)]
        flat_k = [[k] for row in ks for k in row]
        jobs = [
            [(list(params.h[:H]) + [params.g], [list(m[:H]) + [r] for m, r in zip(msgs, rs)])],
            [([params.g], flat_k), ([epk], flat_k)],
        ]
        ops = [
            [(be._comb_tables(False, b),) + be._comb_digits(sc) for b, sc in group]
            for group in jobs
        ]
        return rs, ks, ops

    (rs, ks, (commit_ops, elg_ops)), out["draw_encode"] = _stage(draw_encode)
    (ch, eh), out["commit_elgamal_programs"] = _stage(
        lambda: (msm_shared_many_program(cv.FP, commit_ops), msm_shared_many_program(cv.FP, elg_ops))
    )
    comms, out["commit_readback"] = _stage(lambda: be.msm_shared_many_wait(ch)[0])
    known = [list(m[H:]) for m in msgs]
    hops, out["expand_message_xmd"] = _stage(lambda: be.hash_operands([
        sig.SignatureRequest.hash_input(c, kn, ctx) for c, kn in zip(comms, known)
    ]))
    hh, out["hash_program"] = _stage(lambda: hash_to_g1_program(*hops))
    hs, out["hash_readback"] = _stage(lambda: be.hash_to_g1_wait(hh))

    def hm_encode():
        pts = [[h] for h in hs for _ in range(H)]
        return be._distinct_operands(False, pts, [[m % R] for ms in msgs for m in ms[:H]])

    (w, hm_ops), out["hm_encode"] = _stage(hm_encode)
    c2h, out["hm_offset_program"] = _stage(
        lambda: msm_distinct_plus_offset_program(cv.FP, *hm_ops, eh[1], window=w)
    )

    def decode():
        gk = _decode_points(*eh[0])
        c2s = be.msm_distinct_wait(c2h)
        reqs = []
        for i in range(B):
            f = range(i * H, (i + 1) * H)
            req = sig.SignatureRequest(known[i], comms[i], [(gk[j], c2s[j]) for j in f])
            req._h_cache = hs[i]
            reqs.append(req)
        return reqs

    reqs, out["prepare_decode"] = _stage(decode)
    blind = {}
    for s in signers:
        rows, st_enc = _stage(lambda: sig.blind_sign_rows(reqs, s.sigkey, ctx))
        (w, bops), st_enc2 = _stage(lambda: be._distinct_operands(False, rows[1], rows[2]))
        handle, st_msm = _stage(lambda: msm_distinct_affine_program(cv.FP, *bops, window=w))

        def bdecode():
            pts = be.msm_distinct_wait(handle)
            return [sig.BlindSignature(h, (a, b)) for h, a, b in zip(rows[0], pts[:B], pts[B:])]

        blind[s.id], st_dec = _stage(bdecode)
        for name, st in (("encode", st_enc), ("encode", st_enc2), ("msm", st_msm), ("decode", st_dec)):
            acc = out.setdefault("blind_sign_" + name, {"s": 0.0, "launches": 0})
            acc["s"] += st["s"]
            acc["launches"] += st["launches"]
    flat = [b for s in signers for b in blind[s.id]]
    unblinded, out["unblind"] = _stage(lambda: sig.batch_unblind(flat, esk, ctx, be))
    sub = (1, 3, 5)
    rows = [[(j, unblinded[(j - 1) * B + i]) for j in sub] for i in range(B)]
    creds, out["aggregate"] = _stage(
        lambda: sig.batch_aggregate(entry.ISSUANCE_THRESHOLD, rows, ctx, be)
    )
    return creds, out


def issue_round(be, fix, subsets=((1, 3, 5),)):
    """One issuance round through the public batch functions on `be`:
    prepare, blind-sign by every signer, unblind all of them in one call,
    aggregate over each subset. Returns (outputs, walls in s, kernel
    launches), each by stage, every stage ended by a device synchronize."""
    params, signers, esk, epk, msgs = fix
    ctx, B = params.ctx, len(msgs)
    out, walls, launches = {}, {}, {}

    def stage(name, fn):
        out[name], st = _stage(fn)
        walls[name], launches[name] = st["s"], st["launches"]

    stage("prepare", lambda: sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epk, params, be))
    reqs = [r for r, _ in out["prepare"]]
    for s in signers:
        stage("blind_sign_%d" % s.id, lambda: sig.batch_blind_sign(reqs, s.sigkey, params, be))
    flat = [b for s in signers for b in out["blind_sign_%d" % s.id]]
    stage("unblind", lambda: sig.batch_unblind(flat, esk, ctx, be))
    for sub in subsets:
        rows = [[(j, out["unblind"][(j - 1) * B + i]) for j in sub] for i in range(B)]
        stage("aggregate_%s" % "".join(map(str, sub)),
              lambda: sig.batch_aggregate(entry.ISSUANCE_THRESHOLD, rows, ctx, be))
    return out, walls, launches


def _schnorr_stages(out, ops):
    """The show programs' Schnorr stages and the pairing accumulator, into
    `out`. Returns (Schnorr bits [B], the accumulator)."""
    (vc_wt, rmag, rsgn, jpt, jinf, cmag, csgn, commx, commy, comminf,
     acc_wt, amag, asgn) = ops[:13]
    fl = cv.FP2

    def schnorr_comb():
        pts = _pts_f32((jpt, commx, commy))
        return pts, cv.msm_shared_comb(fl, vc_wt, rmag, rsgn)

    ((jpt, commx, commy), vc), out["schnorr_comb_msm"] = _stage(schnorr_comb)
    lift = lambda t: t[:, None]
    jterm, out["distinct_msm"] = _stage(
        lambda: cv.msm_distinct_signed(
            fl, tw.tree_map(lift, jpt[0]), tw.tree_map(lift, jpt[1]),
            jinf[:, None], cmag, csgn,
        )
    )

    def schnorr_compare():
        lx, ly, linf = cv.to_affine(fl, cv.jadd(fl, vc, jterm))
        return (fl.eq(lx, commx) & fl.eq(ly, commy) & ~linf & ~comminf) | (
            linf & comminf
        )

    schnorr_ok, out["schnorr_affine_compare"] = _stage(schnorr_compare)
    acc, out["pairing_comb_msm_jadd"] = _stage(
        lambda: cv.jadd(
            fl, cv.msm_shared_comb(fl, acc_wt, amag, asgn),
            cv.affine_to_jacobian(fl, jpt[0], jpt[1], jinf),
        )
    )
    return schnorr_ok, acc


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(run):
    """torch.profiler over one warm batch, `run()`: the device's kernels by
    name, and its busy time as the union of their intervals. GPU-side spans
    of operators and annotations (`aten::*`), which cover the kernels they
    launched, are left out so no kernel is counted twice. The idle share is
    taken against the wall time of an unprofiled warm batch (the profiler
    slows the host, not the device) and, for comparison, of the profiled
    one. Only the device is traced: the host's operator events would cost
    seconds to collect and are not read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_wall = time.perf_counter() - t0
    spans, by_kernel = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        if ev.name.startswith("aten::"):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        k = by_kernel.setdefault(ev.name, {"device_ms": 0.0, "count": 0})
        k["device_ms"] += (end - start) / 1e3
        k["count"] += 1
    busy_ms = _union_us(spans) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1]["device_ms"])[:10]
    ours = [v for k, v in by_kernel.items() if "fp_mul_kernel" in k]
    return {
        "wall_s": wall,
        "profiled_wall_s": profiled_wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_idle_share_profiled": 1.0 - busy_ms / (profiled_wall * 1e3),
        "device_launches": len(spans),
        "fp_mul": {
            "device_ms": sum(v["device_ms"] for v in ours),
            "count": sum(v["count"] for v in ours),
        },
        "top_kernels": [{"name": k[:80], **v} for k, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--path",
        choices=("verify", "show", "verify_combined", "show_combined", "grouped", "prove", "issue"),
        default="verify",
    )
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_verify: no CUDA device available")

    be = TorchBackend()
    timed = None
    combined = args.path.endswith("_combined")
    if combined and args.batch & (args.batch - 1):
        raise SystemExit("profile_verify: the combined paths take a power-of-two batch")
    if args.path == "issue":
        fix = entry.issue_fixture(args.batch)
        params, signers, _, _, msgs = fix
        vk = sig.Verkey.aggregate(
            entry.ISSUANCE_THRESHOLD, [(j, signers[j - 1].verkey) for j in (1, 3, 5)], params.ctx
        )
        expect = [True] * args.batch

        def timed():  # the profiled batch: the round alone
            return issue_round(be, fix)[0]["aggregate_135"]

        run = lambda: be.batch_verify(timed(), msgs, vk, params)

        def staged():
            creds, st = issue_stages(be, fix)
            return be.batch_verify(creds, msgs, vk, params), st
    elif args.path == "prove":
        params, _, vk, sigs, msgs = entry.fixture(args.batch)
        revealed = set(entry.SHOW_REVEALED)
        expect = [True] * 4

        def spec_check(proofs, rms):
            return [pok_sig.show_verify(p, vk, params, rm) for p, rm in zip(proofs[:4], rms[:4])]

        def timed():  # the profiled batch: the prover alone
            return pok_sig.batch_show(sigs, vk, params, msgs, revealed, be)

        def run():
            proofs, _, rms = timed()
            return spec_check(proofs, rms)

        def staged():
            proofs, st = prove_stages(be, sigs, msgs, vk, params, revealed)
            return spec_check(proofs, [{j: m[j] for j in revealed} for m in msgs]), st
    elif args.path == "grouped":
        params, _, vk, sigs, msgs = entry.fixture(args.batch)
        expect = [True]
        run = lambda: [be.batch_verify_grouped(sigs, msgs, vk, params)]
        staged = lambda: grouped_stages(be, sigs, msgs, vk, params)
    elif args.path.startswith("verify"):
        params, _, vk, sigs, msgs = entry.fixture(args.batch)
        if combined:
            expect = [True] * args.batch
            run = lambda: ps.batch_verify(sigs, msgs, vk, params, be, mode="batched")
            staged = lambda: combined_stages(be, sigs, msgs, vk, params)
        else:
            sigs, msgs, expect = entry.forge(params, sigs, msgs, every=8)
            run = lambda: be.batch_verify(sigs, msgs, vk, params)
            staged = lambda: stages(be, sigs, msgs, vk, params)
    else:
        params, _, vk, proofs, rmsgs, chals = entry.show_fixture(args.batch)
        if combined:
            expect = [True] * args.batch
            run = lambda: ps.batch_show_verify(
                proofs, vk, params, rmsgs, chals, be, mode="batched"
            )
            staged = lambda: show_combined_stages(be, proofs, vk, params, rmsgs, chals)
        else:
            proofs, rmsgs, expect = entry.forge_shows(params, proofs, rmsgs, every=8)
            run = lambda: be.batch_show_verify(proofs, vk, params, rmsgs, chals)
            staged = lambda: show_stages(be, proofs, vk, params, rmsgs, chals)
    if run() != expect:
        raise AssertionError("verdicts differ from expected")
    cuda_fp.LAUNCH_WIDTHS.clear()
    bits, st = staged()
    if bits != expect:
        raise AssertionError("staged verdicts differ from expected")
    widths = dict(sorted(cuda_fp.LAUNCH_WIDTHS.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result = {
        "path": args.path,
        "batch": args.batch,
        "window": be.window,
        "stages": st,
        "stages_total_s": sum(v["s"] for v in st.values()),
        "stages_launches": sum(v["launches"] for v in st.values()),
        "launch_widths": widths,
        "profile": profile(timed or run),
        "card": card,
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        # lint: allow(durability, a one-shot report the same JSON as stdout;
        # a torn file is rerun, no state is recovered from it)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
