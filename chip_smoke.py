"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each (plus the kernel table and the result line):
  1. environment: torch / CUDA / nvcc versions and the card's name and
     power limit (nvidia-smi);
  2. build: nvcc compiles coconut_tpu_torch/csrc/fp_mul.cu into build/;
     ptxas' registers, spills and shared memory of the kernel;
  3. kernel: the CUDA Montgomery multiply against its plain PyTorch
     version on 55,296 lanes (the fp12_mul shape at B = 1024) of random
     LAZY inputs plus adversarial rows, and at ragged widths that straddle
     a lane group and a block (1, G-1, G+1, 127, 129, 3,073) — exact
     equality required, sampled lanes checked against Python-int
     Montgomery products; kernel device times and bounds at 3,072, 18,432
     and 55,296 lanes (fp2_mul, fp6_mul, fp12_mul at B = 1024) and the
     plain version's time;
  4. main path: TorchBackend().batch_verify at B = 1024, 6 attributes,
     window 9, raw wire, one lane in 8 forged three ways — bits must
     equal the expected verdicts, the main-path run must launch the
     kernel and never the plain version; warm wall time, verifies/s and
     the kernel's launches of one warm batch by width;
  5. show path: TorchBackend().batch_show_verify at B = 1024 (BASELINE
     config 3: 6 attributes, {2, 3, 4, 5} revealed), window 9, raw wire,
     one show in 8 forged four ways — the same checks on the cold call and
     three warm calls; warm wall time, show-verifies/s and the launches of
     one warm batch by width;
  6. verify_combined: the main path's honest batch (before forging)
     through ps.batch_verify(mode="batched") — 1,024 true bits from ONE
     combined check and ONE final exponentiation a call, the same checks
     as above; combined verifies/s beside the exact rate. Then the
     bisection ladder on a batch with lanes 511 (tampered sigma_2) and
     1023 (wrong message) forged: its bits, leaves, combined checks and
     wall time;
  7. show_combined: the same for ps.batch_show_verify(mode="batched") on
     the show path's honest batch, and its ladder on a batch with one show
     in 256 forged (lanes 255 and 767 fail the pairing check and must be
     the ladder's leaves; 511, a corrupted response, and 1023, an identity
     sigma'_1, fail through their own bits);
  8. grouped: TorchBackend().batch_verify_grouped (the attribute-grouped
     one-bool check, q+2 Miller pairs) on the main path's honest batch —
     True from ONE final exponentiation a call (the backend's counters),
     cold and three warm calls; grouped verifies/s beside the exact rate
     of phase 4 (window 9); then False on a batch with lane 511's sigma_2
     doubled and on one with lane 1023's message bumped, and False on an
     identity sigma_1 with no device work;
  9. g2_verify: B = 1024, 6 attributes under the G2 assignment
     (signatures in G2, the verkey and g_tilde in G1): exact verify with
     one lane in 8 forged (every bit the expected verdict), the combined
     check of ps.batch_verify(mode="batched") on the honest batch (1,024
     true bits, one combined check a call) and the grouped check (True on
     the honest batch, False with lane 511's sigma_2 doubled), each cold
     and warm with its rate, beside the G1 rates of this process.
 10. prove: pok_sig.batch_show (the batched prover: one distinct MSM over
     G1 with GLV for the sigma pair, one program of two comb MSMs over G2
     for J and the Schnorr commitments, the packed uint8 readback,
     Fiat-Shamir on the host) on the main path's honest credentials,
     revealing {2, 3, 4, 5}, cold and three warm calls: proofs/s and the
     launches of one warm batch by width. Every challenge equals the one
     recomputed from its proof's transcript; ps.batch_show_verify with
     challenges=None gives 1,024 true bits in exact mode and in batched
     mode (one combined check a call), each cold and warm, FS
     show-verifies/s beside the show_path rate; the batch forged one show
     in 8 gives the expected bits; 8 sampled proofs pass the host spec
     verifier (pok_sig.show_verify); with a seeded rand_fr, the sigma'
     points, J and the commitments of 16 sampled lanes equal the host spec
     MSMs of the same scalars;
 11. show_g2: the same prover on phase 9's G2 credentials, cold and warm,
     then exact show verify (challenges recomputed) with one show in 8
     forged four ways and the combined check on the honest batch (1,024
     true bits, one combined check a call), each cold and warm with its
     rate beside the G1 show rates of this process;
 12. ragged: 16 shows over the revealed sets {2, 3, 4, 5} and {0, 1}, two
     forged, through ps.batch_show_verify in exact and batched mode: the
     expected bits from the spec verifier proof by proof, the ragged
     counters 1 and 16, and no call of the backend.
 13. issue: threshold issuance (BASELINE config 4) under G1 at B = 1024,
     6 attributes, 2 hidden, 3-of-5 (entry.issue_fixture: label-derived
     params, trusted-dealer keys, one ElGamal key): the round
     batch_prepare_blind_sign (device hash and the offset program, shown
     by the backend's counters), batch_blind_sign by each of the 5
     signers, batch_unblind of all 5 signers' batches in one call,
     batch_aggregate over {1, 3, 5} and {2, 4, 5}, cold and three times
     warm; Verkey.aggregate of each subset; TorchBackend.batch_verify of
     the 1,024 credentials under both verkeys (all true) and with one lane
     in 8 forged (the expected bits). 16 lanes of the device hash equal
     the host spec's hash_to_g1; lanes 0 and B-1 of prepare and of one
     blind-sign equal SignatureRequest.new / BlindSignature.new replayed
     from the same draws on the host spec. Warm medians: prepare/s,
     blind-sign/s (one signer's batch), unblind/s (blind signatures),
     aggregate/s, issued credentials/s for the whole round; the kernel's
     launches of each stage; the device's idle share over one warm round
     (torch.profiler);
 14. issue_g2: the same round once under G2 at B = 16 (the host hashes to
     G2): every credential verifies and the forged lanes fail;
 15. bucketed: G1 distinct MSMs at B = 64 and 32 bases a row, scalars over
     Fr: "auto" takes the bucketed schedule at window 5 (64 bases after
     GLV); its points equal the Horner schedule's and 8 lanes of the host
     spec MSM; then a G2 batch ([16, 4] rows) forced through the bucketed
     schedule at window 5 against the spec.

Each path's first call runs with the kernel's counts set to 0 just before
it and read just after; the kernel table's `launches` is their sum, and
`launches_by_path` holds each (g2_verify: the sum of its three paths';
prove: the prover's and its two FS verifies'; show_g2: the prover's and
its two verifies'; issue: the round's four stages'; issue_g2: the same;
bucketed: its three MSMs').

Any failed check raises (non-zero exit). After the phases, a `done` line
gives the script's seconds since start; then the kernel table, and last
the JSON result {"ok": true, "device": {...}}.
Needs a CUDA card: without one it exits non-zero before printing results.
"""

import collections
import json
import random
import secrets
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from coconut_tpu_torch import entry, pok_sig, ps, sss
from coconut_tpu_torch import bench_fp_mul as kb
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.gpu.limbs import MONT_R
from coconut_tpu_torch.ops import hashing
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import P, R
from coconut_tpu_torch.profile_verify import issue_round, profile
from coconut_tpu_torch.signature import fiat_shamir_challenge

LANES = kb.MAIN_WIDTHS[-1]  # one fp12_mul at B = 1024: 54 base products per lane
BATCH = kb.BATCH
FORGE_EVERY = 8
LADDER_EVERY = 512  # verify ladder: lanes 511 and 1023 forged
SHOW_LADDER_EVERY = 256  # show ladder: lanes 255, 511, 767 and 1023 forged


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvcc_version():
    out = subprocess.run(
        [cuda_fp._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout
    return out.strip().splitlines()[-1]


def limbs_value(row):
    return sum(int(v) << (8 * i) for i, v in enumerate(row))


def kernel_phase(dev):
    rng = np.random.default_rng(0xC0C0)
    a_np, b_np, nrand = kb.operands(rng, LANES)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)

    got = cuda_fp.mul(a, b)
    torch.cuda.synchronize()
    want = cuda_fp.mul_plain(a, b)
    max_abs_err = float((got - want).abs().max())
    if max_abs_err != 0.0:
        bad = int((got != want).any(dim=1).sum())
        raise AssertionError("kernel != plain version on %d lanes" % bad)

    out = got.cpu().numpy()
    rinv = pow(MONT_R, -1, P)
    for i in rng.choice(nrand, size=256, replace=False):
        av, bv, ov = limbs_value(a_np[i]), limbs_value(b_np[i]), limbs_value(out[i])
        if (ov - av * bv * rinv) % P:
            raise AssertionError("lane %d does not decode to a*b/R mod p" % i)
    if np.abs(out[:nrand]).max() > 132:
        raise AssertionError("kernel output left the NORMALIZED class")

    # ragged widths, each the last rows (adversarial pairs included)
    ragged = kb.ragged_widths(cuda_fp.group())
    kb.check_exact(lambda x, y, o: lambda: cuda_fp.launch(x, y, o), a, b, ragged)

    out_buf = torch.empty_like(a)
    ms_by_lanes, bound_by_lanes = {}, {}
    for w in kb.MAIN_WIDTHS:
        aw, bw, ow = a[:w], b[:w], out_buf[:w]
        ms_by_lanes[str(w)] = kb.time_cuda(lambda: cuda_fp.launch(aw, bw, ow))
        bound_by_lanes[str(w)] = kb.bound(w)
    plain_ms = kb.time_cuda(lambda: cuda_fp.mul_plain(a, b), reps=3, inner=2)
    full = bound_by_lanes[str(LANES)]
    log(
        "kernel", lanes=LANES, group=cuda_fp.group(), max_abs_err=max_abs_err,
        decoded_lanes=256, ragged_widths_exact=ragged, ms=ms_by_lanes[str(LANES)],
        plain_ms=plain_ms, ms_by_lanes=ms_by_lanes, bounds_by_lanes=bound_by_lanes,
        fma_per_lane=kb.FMA_PER_LANE, bytes=kb.BYTES_PER_LANE * LANES,
    )
    return {
        "name": "fp_mul",
        "route": "cuda",
        "source": "coconut_tpu_torch/csrc/fp_mul.cu",
        "replaces": "coconut_tpu/tpu/pallas_fp.py:301",
        "launches": None,
        "max_abs_err": max_abs_err,
        "ms": ms_by_lanes[str(LANES)],
        "plain_ms": plain_ms,
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        "ms_by_lanes": ms_by_lanes,
        "bound_ms_by_lanes": {w: v["bound_ms"] for w, v in bound_by_lanes.items()},
    }


def drive(run, expect):
    """Run a path once cold, with the kernel's counts set to 0 just before
    and read just after, then three times warm. Every run's bits must equal
    `expect` (or, if `expect` is a function, pass it); the cold run must
    launch the kernel and never the plain version. Returns the cold call's
    time and counts and the warm walls."""
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    bits = run()
    first_s = time.perf_counter() - t0
    launches, plain_calls = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if callable(expect):
        expect(bits)
    elif bits != expect:
        wrong = [i for i, (g, w) in enumerate(zip(bits, expect)) if g != w]
        raise AssertionError("verdicts differ from expected at lanes %s" % wrong[:16])
    if launches == 0 or plain_calls != 0:
        raise AssertionError(
            "the path ran %d kernel launches and %d plain calls" % (launches, plain_calls)
        )

    walls = []
    for _ in range(3):
        before = cuda_fp.LAUNCHES
        cuda_fp.LAUNCH_WIDTHS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = run()
        walls.append(time.perf_counter() - t0)
        warm_launches = cuda_fp.LAUNCHES - before
        if callable(expect):
            expect(again)
        elif again != expect:
            raise AssertionError("warm verdicts differ from expected")
    return {
        "verdicts_match": True,
        "first_call_s": first_s,
        "launches_first_call": launches,
        "plain_calls": plain_calls,
        "launches_per_warm_batch": warm_launches,
        "launch_widths_per_warm_batch": dict(sorted(cuda_fp.LAUNCH_WIDTHS.items())),
        "warm_wall_s": statistics.median(walls),
        "warm_walls_s": walls,
    }


def main_path_phase(card):
    """Exact verify. Returns the kernel's launches, the backend, the honest
    fixture (before forging) and verifies/s."""
    t0 = time.perf_counter()
    honest = entry.fixture(BATCH)
    params, _, vk, sigs, msgs = honest
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=FORGE_EVERY)
    fixture_s = time.perf_counter() - t0

    be = TorchBackend()  # cuda, window 9, raw wire
    res = drive(lambda: be.batch_verify(sigs, msgs, vk, params), expect)
    rate = BATCH / res["warm_wall_s"]
    log(
        "main_path", batch=BATCH, attrs=entry.MSG_COUNT, window=be.window,
        raw_wire=be.raw_wire, forged=expect.count(False), fixture_s=fixture_s,
        **res, verifies_per_s=rate, card=card,
    )
    return res["launches_first_call"], be, honest, rate


def show_path_phase(card):
    """Exact show verify; returns as main_path_phase does."""
    t0 = time.perf_counter()
    honest = entry.show_fixture(BATCH)
    params, _, vk, proofs, rmsgs, challenges = honest
    proofs, rmsgs, expect = entry.forge_shows(params, proofs, rmsgs, every=FORGE_EVERY)
    fixture_s = time.perf_counter() - t0

    be = TorchBackend()  # cuda, window 9, raw wire
    res = drive(
        lambda: be.batch_show_verify(proofs, vk, params, rmsgs, challenges), expect
    )
    rate = BATCH / res["warm_wall_s"]
    log(
        "show_path", batch=BATCH, attrs=entry.MSG_COUNT,
        revealed=list(entry.SHOW_REVEALED), window=be.window, raw_wire=be.raw_wire,
        forged=expect.count(False), forged_kinds=list(entry.SHOW_FORGERIES),
        fixture_s=fixture_s, **res, show_verifies_per_s=rate, card=card,
    )
    return res["launches_first_call"], be, honest, rate


class _Recorder:
    """Forwards to a backend and records each combined check: (first lane
    of the sub-batch, its lanes, its pairing bool)."""

    def __init__(self, be, lanes):
        self._be = be
        self._index = {id(x): i for i, x in enumerate(lanes)}
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._be, name)

    def batch_verify_combined(self, sigs, *args, **kw):
        ok = self._be.batch_verify_combined(sigs, *args, **kw)
        self.calls.append((self._index[id(sigs[0])], len(sigs), ok))
        return ok

    def batch_show_verify_combined(self, proofs, *args, **kw):
        bits, ok = self._be.batch_show_verify_combined(proofs, *args, **kw)
        self.calls.append((self._index[id(proofs[0])], len(proofs), ok))
        return bits, ok


def _one_check_per_call(be, res, counter="combined_checks"):
    """drive()'s four calls must each have made one check (`counter`:
    combined or grouped) and one final exponentiation; `res` holds the
    counters' values before them."""
    checks = getattr(be, counter) - res.pop("checks_before")
    final_exps = be.final_exps - res.pop("final_exps_before")
    if (checks, final_exps) != (4, 4):
        raise AssertionError(
            "4 calls made %d %s and %d final exponentiations"
            % (checks, counter, final_exps)
        )
    res[counter + "_per_call"] = checks // 4
    res["final_exps_per_call"] = final_exps // 4


def _ladder(run, rec, expect, leaves):
    """One bisection ladder: its bits must equal `expect` and its leaves
    (single-lane checks that failed) must be `leaves`; no plain call."""
    plain = cuda_fp.PLAIN_CALLS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bits = run()
    wall = time.perf_counter() - t0
    if bits != expect:
        wrong = [i for i, (g, w) in enumerate(zip(bits, expect)) if g != w]
        raise AssertionError("ladder verdicts differ from expected at lanes %s" % wrong)
    got_leaves = sorted(lo for lo, n, ok in rec.calls if n == 1 and not ok)
    if got_leaves != leaves or cuda_fp.PLAIN_CALLS != plain:
        raise AssertionError(
            "ladder leaves %s (expected %s), %d plain calls"
            % (got_leaves, leaves, cuda_fp.PLAIN_CALLS - plain)
        )
    return {
        "ladder_batch": len(expect),
        "ladder_forged": [i for i, e in enumerate(expect) if not e],
        "ladder_leaves": got_leaves,
        "ladder_combined_checks": len(rec.calls),
        "ladder_checks_by_width": dict(
            sorted(collections.Counter(n for _, n, _ in rec.calls).items())
        ),
        "ladder_wall_s": wall,
    }


def verify_combined_phase(card, be, honest, exact_rate):
    params, _, vk, sigs, msgs = honest
    res = {"checks_before": be.combined_checks, "final_exps_before": be.final_exps}
    res.update(drive(
        lambda: ps.batch_verify(sigs, msgs, vk, params, be, mode="batched"),
        [True] * BATCH,
    ))
    _one_check_per_call(be, res)
    rate = BATCH / res["warm_wall_s"]

    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=LADDER_EVERY)
    rec = _Recorder(be, fsigs)
    ladder = _ladder(
        lambda: ps.batch_verify(fsigs, fmsgs, vk, params, rec, mode="batched"),
        rec, expect, [i for i, e in enumerate(expect) if not e],
    )
    log(
        "verify_combined", batch=BATCH, attrs=entry.MSG_COUNT, **res,
        combined_verifies_per_s=rate, exact_verifies_per_s=exact_rate,
        ratio_to_exact=rate / exact_rate, **ladder, card=card,
    )
    return res["launches_first_call"], rate


def show_combined_phase(card, be, honest, exact_rate):
    params, _, vk, proofs, rmsgs, challenges = honest
    res = {"checks_before": be.combined_checks, "final_exps_before": be.final_exps}
    res.update(drive(
        lambda: ps.batch_show_verify(
            proofs, vk, params, rmsgs, challenges, be, mode="batched"
        ),
        [True] * BATCH,
    ))
    _one_check_per_call(be, res)
    rate = BATCH / res["warm_wall_s"]

    fproofs, frmsgs, expect = entry.forge_shows(
        params, proofs, rmsgs, every=SHOW_LADDER_EVERY
    )
    # the pairing check fails on the wrong revealed value and the doubled
    # sigma'_2 only: the ladder's leaves
    kinds = entry.SHOW_FORGERIES
    pairing_lanes = [
        i for n, i in enumerate(range(SHOW_LADDER_EVERY - 1, BATCH, SHOW_LADDER_EVERY))
        if kinds[n % len(kinds)] in ("wrong_revealed_value", "doubled_sigma_prime_2")
    ]
    rec = _Recorder(be, fproofs)
    ladder = _ladder(
        lambda: ps.batch_show_verify(
            fproofs, vk, params, frmsgs, challenges, rec, mode="batched"
        ),
        rec, expect, pairing_lanes,
    )
    log(
        "show_combined", batch=BATCH, attrs=entry.MSG_COUNT,
        revealed=list(entry.SHOW_REVEALED), **res,
        combined_show_verifies_per_s=rate, exact_show_verifies_per_s=exact_rate,
        ratio_to_exact=rate / exact_rate, **ladder, card=card,
    )
    return res["launches_first_call"], rate


def _forged_sigma_2(params, sigs, lane):
    sigs = list(sigs)
    s = sigs[lane]
    sigs[lane] = type(s)(s.sigma_1, params.ctx.sig.mul(s.sigma_2, 2))
    return sigs


def _quiet(run, want, what):
    """One call that must return `want` and launch no plain version."""
    plain = cuda_fp.PLAIN_CALLS
    got = run()
    if got != want or cuda_fp.PLAIN_CALLS != plain:
        raise AssertionError(
            "%s: got %r (expected %r), %d plain calls"
            % (what, got, want, cuda_fp.PLAIN_CALLS - plain)
        )


def grouped_phase(card, be, honest, exact_rate):
    """The grouped check on the main path's honest batch and on batches
    forged one way each."""
    params, _, vk, sigs, msgs = honest
    res = {"checks_before": be.grouped_checks, "final_exps_before": be.final_exps}
    res.update(drive(lambda: [be.batch_verify_grouped(sigs, msgs, vk, params)], [True]))
    _one_check_per_call(be, res, "grouped_checks")
    rate = BATCH / res["warm_wall_s"]

    run = lambda s, m: be.batch_verify_grouped(s, m, vk, params)
    mid, last = BATCH // 2 - 1, BATCH - 1  # 511, 1023
    _quiet(lambda: run(_forged_sigma_2(params, sigs, mid), msgs), False, "sigma_2 doubled")
    wrong = [list(m) for m in msgs]
    wrong[last][0] = (wrong[last][0] + 1) % R
    _quiet(lambda: run(sigs, wrong), False, "wrong message")
    launches, final_exps = cuda_fp.LAUNCHES, be.final_exps
    ident = list(sigs)
    ident[mid] = type(sigs[mid])(None, sigs[mid].sigma_2)
    _quiet(lambda: run(ident, msgs), False, "identity sigma_1")
    if (cuda_fp.LAUNCHES, be.final_exps) != (launches, final_exps):
        raise AssertionError("an identity sigma_1 reached the device")
    log(
        "grouped", batch=BATCH, attrs=entry.MSG_COUNT, **res,
        grouped_verifies_per_s=rate, exact_verifies_per_s=exact_rate,
        exact_window=be.window, ratio_to_exact=rate / exact_rate,
        forged_batches_false={"sigma_2 doubled": mid, "wrong message": last},
        identity_sigma_1_false_without_device_work=True, card=card,
    )
    return res["launches_first_call"], rate


def g2_verify_phase(card, g1_rates):
    """Exact, combined and grouped verify under the G2 assignment."""
    t0 = time.perf_counter()
    params, _, vk, sigs, msgs = entry.fixture(BATCH, ctx="G2")
    fixture_s = time.perf_counter() - t0
    be = TorchBackend()  # cuda, window 9, raw wire
    out, launches = {}, 0

    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=FORGE_EVERY)
    res = drive(lambda: be.batch_verify(fsigs, fmsgs, vk, params), expect)
    out["exact"] = dict(res, forged=expect.count(False), verifies_per_s=BATCH / res["warm_wall_s"])

    res = {"checks_before": be.combined_checks, "final_exps_before": be.final_exps}
    res.update(drive(
        lambda: ps.batch_verify(sigs, msgs, vk, params, be, mode="batched"),
        [True] * BATCH,
    ))
    _one_check_per_call(be, res)
    out["combined"] = dict(res, verifies_per_s=BATCH / res["warm_wall_s"])

    res = {"checks_before": be.grouped_checks, "final_exps_before": be.final_exps}
    res.update(drive(lambda: [be.batch_verify_grouped(sigs, msgs, vk, params)], [True]))
    _one_check_per_call(be, res, "grouped_checks")
    forged = _forged_sigma_2(params, sigs, BATCH // 2 - 1)
    _quiet(
        lambda: be.batch_verify_grouped(forged, msgs, vk, params), False, "G2 sigma_2 doubled"
    )
    out["grouped"] = dict(res, verifies_per_s=BATCH / res["warm_wall_s"])
    for name, v in out.items():
        launches += v["launches_first_call"]
        v["ratio_to_g1"] = v["verifies_per_s"] / g1_rates[name]
    log(
        "g2_verify", batch=BATCH, attrs=entry.MSG_COUNT, ctx="G2", window=be.window,
        raw_wire=be.raw_wire, fixture_s=fixture_s, **out,
        g1_verifies_per_s=g1_rates, card=card,
    )
    return launches, (params, vk, sigs, msgs)


def _proofs_valid(params, vk, n):
    """A check for drive(): the prover's output of n proofs whose every
    challenge is the one recomputed from the proof's transcript."""

    def check(out):
        proofs, chals, rms = out
        if len(proofs) != n or len(rms) != n:
            raise AssertionError("the prover returned %d proofs" % len(proofs))
        redo = [fiat_shamir_challenge(p.to_bytes_for_challenge(vk, params)) for p in proofs]
        if redo != chals:
            bad = [i for i, (a, b) in enumerate(zip(redo, chals)) if a != b]
            raise AssertionError("challenges differ from the transcripts' at %s" % bad[:16])

    return check


def _seeded_rand_fr(seed):
    """A rand_fr drawing from random.Random(seed) (for the spec checks)."""
    rng = random.Random(seed)
    return lambda: rng.randrange(R)


def _spec_lanes(params, vk, sigs, msgs, revealed, be, lanes):
    """Run the prover with a seeded rand_fr and hold sigma'_1, sigma'_2, J
    and the commitment of `lanes` against the host spec MSMs of the same
    scalars (replayed from the same seed)."""
    seed = 0x5EED
    pok_sig.rand_fr = _seeded_rand_fr(seed)
    try:
        proofs, _, _ = pok_sig.batch_show(sigs, vk, params, msgs, revealed, be)
        pok_sig.rand_fr = _seeded_rand_fr(seed)
        rs, ts, blindings = pok_sig.prover_draw(len(sigs), len(vk.Y_tilde) - len(revealed))
    finally:
        pok_sig.rand_fr = sss.rand_fr
    ctx = params.ctx
    bases = ps.show_bases(vk, params, revealed)
    hidden = [i for i in range(len(vk.Y_tilde)) if i not in revealed]
    for i in lanes:
        s, p = sigs[i], proofs[i]
        want = (
            ctx.sig.msm([s.sigma_1], [rs[i]]),
            ctx.sig.msm([s.sigma_2, s.sigma_1], [rs[i], ts[i] * rs[i] % R]),
            ctx.other.msm(bases, [ts[i]] + [msgs[i][j] for j in hidden]),
            ctx.other.msm(bases, blindings[i]),
        )
        if (p.sigma_prime_1, p.sigma_prime_2, p.J, p.proof_vc.t) != want:
            raise AssertionError("lane %d differs from the host spec MSMs" % i)
    return len(lanes)


def prove_phase(card, honest, show_rate):
    """The batched prover on the main path's credentials, then its proofs
    through the FS show verify; returns the phase's launches and rates."""
    params, _, vk, sigs, msgs = honest
    revealed = set(entry.SHOW_REVEALED)
    be = TorchBackend()  # cuda, window 9, raw wire
    made = {}

    def prove():
        made["out"] = pok_sig.batch_show(sigs, vk, params, msgs, revealed, be)
        return made["out"]

    res = drive(prove, _proofs_valid(params, vk, BATCH))
    proofs, _, rms = made["out"]
    launches = res["launches_first_call"]
    out = {"prove": dict(res, proofs_per_s=BATCH / res["warm_wall_s"])}

    res = drive(lambda: ps.batch_show_verify(proofs, vk, params, rms, backend=be), [True] * BATCH)
    launches += res["launches_first_call"]
    fs_rate = BATCH / res["warm_wall_s"]
    out["fs_exact"] = dict(res, show_verifies_per_s=fs_rate)
    res = {"checks_before": be.combined_checks, "final_exps_before": be.final_exps}
    res.update(drive(
        lambda: ps.batch_show_verify(proofs, vk, params, rms, backend=be, mode="batched"),
        [True] * BATCH,
    ))
    _one_check_per_call(be, res)
    launches += res["launches_first_call"]
    out["fs_batched"] = dict(res, show_verifies_per_s=BATCH / res["warm_wall_s"])

    t0 = time.perf_counter()
    for p in proofs:
        fiat_shamir_challenge(p.to_bytes_for_challenge(vk, params))
    recompute_s = time.perf_counter() - t0
    fproofs, frms, expect = entry.forge_shows(params, proofs, rms, every=FORGE_EVERY)
    _quiet(
        lambda: ps.batch_show_verify(fproofs, vk, params, frms, backend=be), expect,
        "forged FS show verify",
    )
    t0 = time.perf_counter()
    sample = range(0, BATCH, BATCH // 8)
    if not all(pok_sig.show_verify(proofs[i], vk, params, rms[i]) for i in sample):
        raise AssertionError("a sampled proof fails the host spec verifier")
    spec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nspec = _spec_lanes(params, vk, sigs, msgs, revealed, be, range(7, BATCH, BATCH // 16))
    log(
        "prove", batch=BATCH, attrs=entry.MSG_COUNT, revealed=sorted(revealed),
        window=be.window, **out, forged=expect.count(False), spec_verified_proofs=len(sample),
        spec_verify_s=spec_s, spec_msm_lanes=nspec, spec_msm_s=time.perf_counter() - t0,
        challenge_recompute_s=recompute_s, fs_show_verifies_per_s=fs_rate,
        show_path_show_verifies_per_s=show_rate,
        fs_ratio_to_show_path=fs_rate / show_rate, card=card,
    )
    return launches, out["fs_batched"]["show_verifies_per_s"]


def show_g2_phase(card, g2_creds, g1_show_rates):
    """The prover, exact show verify and the combined check under G2."""
    params, vk, sigs, msgs = g2_creds
    revealed = set(entry.SHOW_REVEALED)
    be = TorchBackend()  # cuda, window 9, raw wire
    made = {}

    def prove():
        made["out"] = pok_sig.batch_show(sigs, vk, params, msgs, revealed, be)
        return made["out"]

    res = drive(prove, _proofs_valid(params, vk, BATCH))
    proofs, _, rms = made["out"]
    out = {"prove": dict(res, proofs_per_s=BATCH / res["warm_wall_s"])}
    fproofs, frms, expect = entry.forge_shows(params, proofs, rms, every=FORGE_EVERY)
    res = drive(lambda: ps.batch_show_verify(fproofs, vk, params, frms, backend=be), expect)
    out["exact"] = dict(res, forged=expect.count(False), show_verifies_per_s=BATCH / res["warm_wall_s"])
    res = {"checks_before": be.combined_checks, "final_exps_before": be.final_exps}
    res.update(drive(
        lambda: ps.batch_show_verify(proofs, vk, params, rms, backend=be, mode="batched"),
        [True] * BATCH,
    ))
    _one_check_per_call(be, res)
    out["combined"] = dict(res, show_verifies_per_s=BATCH / res["warm_wall_s"])
    launches = 0
    for name, v in out.items():
        launches += v["launches_first_call"]
        if name in g1_show_rates:
            v["ratio_to_g1"] = v["show_verifies_per_s"] / g1_show_rates[name]
    log(
        "show_g2", batch=BATCH, attrs=entry.MSG_COUNT, ctx="G2", revealed=sorted(revealed),
        window=be.window, **out, g1_show_verifies_per_s=g1_show_rates, card=card,
    )
    return launches


class _NoBackend:
    """A backend that fails any use: the ragged path must not touch it."""

    def __getattr__(self, name):
        raise AssertionError("the ragged batch reached the backend (%s)" % name)


def ragged_phase(card, honest):
    """16 shows over two revealed sets, two forged, proof by proof."""
    params, _, vk, sigs, msgs = honest
    be = TorchBackend()
    halves = []
    for lo, revealed in ((0, set(entry.SHOW_REVEALED)), (8, {0, 1})):
        proofs, _, rms = pok_sig.batch_show(
            sigs[lo : lo + 8], vk, params, msgs[lo : lo + 8], revealed, be
        )
        # the last show of each set gets a wrong revealed value
        halves.append(entry.forge_shows(params, proofs, rms, every=8))
    # interleaved: even lanes reveal {2, 3, 4, 5}, odd ones {0, 1}
    proofs, rmsgs, expect = (
        [x for pair in zip(a, b) for x in pair] for a, b in zip(*halves)
    )
    out, launches = {}, cuda_fp.LAUNCHES
    for mode in ("exact", "batched"):
        ps.COUNTS.clear()
        t0 = time.perf_counter()
        bits = ps.batch_show_verify(proofs, vk, params, rmsgs, backend=_NoBackend(), mode=mode)
        wall = time.perf_counter() - t0
        counts = dict(ps.COUNTS)
        if bits != expect:
            raise AssertionError("ragged %s verdicts %s, expected %s" % (mode, bits, expect))
        want = {"show_verify_ragged_fallback": 1, "show_verify_ragged_proofs": 16}
        if counts != want:
            raise AssertionError("ragged counters read %s" % counts)
        out[mode] = {"wall_s": wall, "counters": counts}
    if cuda_fp.LAUNCHES != launches:
        raise AssertionError("the ragged path launched the kernel")
    log(
        "ragged", proofs=len(proofs), revealed_sets=[sorted(entry.SHOW_REVEALED), [0, 1]],
        forged=[i for i, e in enumerate(expect) if not e], **out, card=card,
    )


SUBSETS = ((1, 3, 5), (2, 4, 5))  # the two 3-of-5 aggregation subsets


def _replayed(fn, draws):
    """fn() with every rand_fr returning the given draws, in order."""
    it = iter(draws)
    saved = secrets.randbelow
    secrets.randbelow = lambda n: next(it)
    try:
        return fn()
    finally:
        secrets.randbelow = saved


def _round_points(out):
    """A round's outputs as points, stage by stage: each request's
    commitment, ciphertexts and draws, each blind signature's h and
    (c_tilde_1, c_tilde_2), each signature's (sigma_1, sigma_2)."""

    def pts(x):
        if isinstance(x, tuple):
            return x[0].commitment, x[0].ciphertexts, x[1]
        if isinstance(x, sig.BlindSignature):
            return x.h, x.blinded
        return x.sigma_1, x.sigma_2

    return {k: [pts(x) for x in v] for k, v in out.items()}


def _check_round(fix, out, be, every):
    """The issued credentials verify on the card under each subset's
    aggregated verkey and give the expected bits with one lane in `every`
    forged; no plain call. Returns the verkeys."""
    params, signers, _, _, msgs = fix
    vks = []
    for sub in SUBSETS:
        creds = out["aggregate_%s" % "".join(map(str, sub))]
        vk = sig.Verkey.aggregate(
            entry.ISSUANCE_THRESHOLD, [(j, signers[j - 1].verkey) for j in sub], params.ctx
        )
        _quiet(lambda: be.batch_verify(creds, msgs, vk, params), [True] * len(msgs),
               "issued credentials under %s" % (sub,))
        vks.append(vk)
    fsigs, fmsgs, expect = entry.forge(params, creds, msgs, every=every)
    _quiet(lambda: be.batch_verify(fsigs, fmsgs, vk, params), expect, "forged issued credentials")
    return vks, expect.count(False)


def _seeded_round(be, fix, subsets=SUBSETS):
    """issue_round with the user's draws from one seed, so every run of the
    round gives the same bytes."""
    with entry.seeded_draws(0x5EED):
        return issue_round(be, fix, subsets)


def _drive_round(be, fix):
    """The round cold, with the kernel's counts set to 0 just before and
    read just after (no plain call allowed), then three times warm, each
    byte-equal to the cold one. Returns (cold outputs, cold launches by
    stage, warm median walls by stage, their launches)."""
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    out, walls, cold = _seeded_round(be, fix)
    if cuda_fp.LAUNCHES == 0 or cuda_fp.PLAIN_CALLS != 0:
        raise AssertionError(
            "the round ran %d launches and %d plain calls" % (cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS)
        )
    want = _round_points(out)
    runs = [_seeded_round(be, fix) for _ in range(3)]
    if any(_round_points(again) != want for again, _, _ in runs):
        raise AssertionError("a warm round's outputs differ from the cold round's")
    med = {k: statistics.median(w[k] for _, w, _ in runs) for k in walls}
    return out, cold, med, runs[-1][2]


def issue_phase(card):
    """Threshold issuance under G1 at B = 1024 (BASELINE config 4)."""
    t0 = time.perf_counter()
    fix = entry.issue_fixture(BATCH)
    params, signers, esk, epk, msgs = fix
    fixture_s = time.perf_counter() - t0
    be = TorchBackend()  # cuda, window 9, raw wire, device hash
    if not be.device_hash_enabled():
        raise AssertionError("the cuda backend does not hash on its device")
    hashes, offsets = be.device_hash_batches, be.msm_offset_dispatches
    t0 = time.perf_counter()
    out, cold, med, warm_launches = _drive_round(be, fix)
    parts_s = {"four_rounds": time.perf_counter() - t0}
    if (be.device_hash_batches - hashes, be.msm_offset_dispatches - offsets) != (4, 4):
        raise AssertionError(
            "4 prepares made %d device hashes and %d offset programs"
            % (be.device_hash_batches - hashes, be.msm_offset_dispatches - offsets)
        )
    plain = cuda_fp.PLAIN_CALLS
    t0 = time.perf_counter()
    vks, forged = _check_round(fix, out, be, FORGE_EVERY)
    parts_s["three_verifies"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # spot lanes against the host spec
    ctx = params.ctx
    reqs = out["prepare"]
    lanes = range(0, BATCH, BATCH // 16)
    datas = [
        sig.SignatureRequest.hash_input(reqs[i][0].commitment, reqs[i][0].known_messages, ctx)
        for i in lanes
    ]
    if [reqs[i][0].get_h(ctx) for i in lanes] != [hashing.hash_to_g1(d) for d in datas]:
        raise AssertionError("a device hash differs from the host spec")
    for i in (0, BATCH - 1):
        req, rnd = reqs[i]
        one, _ = _replayed(lambda: sig.SignatureRequest.new(msgs[i], entry.ISSUANCE_HIDDEN, epk, params), rnd)
        bs = sig.BlindSignature.new(req, signers[0].sigkey, params)
        if one.to_bytes(ctx) != req.to_bytes(ctx) or bs.to_bytes(ctx) != out["blind_sign_1"][i].to_bytes(ctx):
            raise AssertionError("lane %d differs from the host spec holders" % i)
    if cuda_fp.PLAIN_CALLS != plain:
        raise AssertionError("the checks ran the plain version")
    parts_s["spec_checks"] = time.perf_counter() - t0

    stages = {"prepare": ["prepare"], "blind_sign": ["blind_sign_1"], "unblind": ["unblind"],
              "aggregate": ["aggregate_135"]}
    n = {"prepare": BATCH, "blind_sign": BATCH, "unblind": len(signers) * BATCH, "aggregate": BATCH}
    rates = {k + "_per_s": n[k] / sum(med[s] for s in v) for k, v in stages.items()}
    round_s = sum(med[k] for k in med if k != "aggregate_245")  # one subset a round
    rates["issued_credentials_per_s"] = BATCH / round_s
    t0 = time.perf_counter()
    prof = profile(lambda: _seeded_round(be, fix, SUBSETS[:1]))
    parts_s["profile_two_rounds"] = time.perf_counter() - t0
    log(
        "issue", batch=BATCH, attrs=entry.MSG_COUNT, hidden=entry.ISSUANCE_HIDDEN,
        threshold="%d-of-%d" % (entry.ISSUANCE_THRESHOLD, entry.ISSUANCE_SIGNERS),
        subsets=[list(s) for s in SUBSETS], window=be.window, fixture_s=fixture_s,
        launches_first_round=cold, launches_warm_round=warm_launches, warm_walls_s=med,
        warm_round_s=round_s, **rates, parts_s=parts_s, forged=forged, verified_under_subsets=len(vks),
        device_hash_batches=be.device_hash_batches, offset_programs=be.msm_offset_dispatches,
        horner_dispatches=be.msm_horner_dispatches, bucketed_dispatches=be.msm_bucketed_dispatches,
        spec_hash_lanes=len(datas), spec_holder_lanes=[0, BATCH - 1], plain_calls=0,
        device_idle_share=prof["device_idle_share"], device_busy_ms=prof["device_busy_ms"],
        device_launches=prof["device_launches"], profiled_round_s=prof["wall_s"],
        fp_mul_profiled=prof["fp_mul"], card=card,
    )
    return sum(cold.values()), rates


def issue_g2_phase(card):
    """One issuance round under G2 at B = 16 (the host hashes to G2), with
    the kernel's counts set to 0 just before it and read just after."""
    fix = entry.issue_fixture(16, ctx="G2")
    be = TorchBackend()
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    out, walls, launches = _seeded_round(be, fix)
    if cuda_fp.LAUNCHES == 0 or cuda_fp.PLAIN_CALLS != 0:
        raise AssertionError("the G2 round ran the plain version or no kernel")
    if be.device_hash_batches or be.msm_offset_dispatches != 1:
        raise AssertionError("G2 prepare hashed on the device or skipped the offset program")
    _, forged = _check_round(fix, out, be, FORGE_EVERY)
    log("issue_g2", batch=16, ctx="G2", launches=launches, walls_s=walls, forged=forged, card=card)
    return sum(launches.values())


def bucketed_phase(card):
    """The bucketed distinct-MSM schedule against Horner and the spec."""
    rng = random.Random(0xB0C)
    B, k = 64, 32

    def points(ops, gen, rows, cols):  # a chain of adds of one random step
        p, step = ops.mul(gen, rng.randrange(1, R)), ops.mul(gen, rng.randrange(1, R))
        out = []
        for _ in range(rows * cols):
            p = ops.add(p, step)
            out.append(p)
        return [out[i * cols : (i + 1) * cols] for i in range(rows)]

    g1_pts = points(g1, G1_GEN, B, k)
    g1_scal = [[rng.randrange(R) for _ in range(k)] for _ in range(B)]
    g2_pts = points(g2, G2_GEN, 16, 4)
    g2_scal = [[rng.randrange(R) for _ in range(4)] for _ in range(16)]
    for pts, scal in ((g1_pts, g1_scal), (g2_pts, g2_scal)):
        pts[1][0] = None  # an identity base and a zero scalar
        scal[2][1] = 0
    be = TorchBackend()  # cuda: bucket_mode "auto"
    if be.bucket_mode != "auto" or be._distinct_window(False, g1_pts) != 5:
        raise AssertionError("auto does not take the bucketed schedule at window 5")
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        walls[name] = time.perf_counter() - t0
        return res

    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    bucketed = timed("g1_bucketed_w5", lambda: be.msm_g1_distinct(g1_pts, g1_scal))
    if (be.msm_bucketed_dispatches, be.msm_bucket_window) != (1, 5):
        raise AssertionError("the auto schedule was not the bucketed one at window 5")
    be.bucket_mode = "off"
    horner = timed("g1_horner", lambda: be.msm_g1_distinct(g1_pts, g1_scal))
    be.bucket_mode = 5
    g2_got = timed("g2_bucketed_w5", lambda: be.msm_g2_distinct(g2_pts, g2_scal))
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain or (be.msm_bucketed_dispatches, be.msm_horner_dispatches) != (2, 1):
        raise AssertionError("bucketed phase: %d launches, %d plain calls" % (launches, plain))
    lanes = range(0, B, B // 8)
    if bucketed != horner or [bucketed[i] for i in lanes] != [g1.msm(g1_pts[i], g1_scal[i]) for i in lanes]:
        raise AssertionError("the bucketed G1 MSM differs from Horner or the spec")
    if g2_got != [g2.msm(p, s) for p, s in zip(g2_pts, g2_scal)]:
        raise AssertionError("the bucketed G2 MSM differs from the spec")
    log("bucketed", g1_rows=[B, k], g1_window=5, g2_rows=[16, 4], g2_window=5,
        spec_lanes=len(lanes), launches=launches, walls_s=walls, card=card)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    dev = torch.device("cuda")
    started = time.perf_counter()
    card = kb.card()
    log(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc_version(),
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = cuda_fp.build()
    build_s = time.perf_counter() - t0
    log("build", seconds=build_s, library=str(lib.name),
        ptxas=kb.ptxas_report(cuda_fp.BUILD_LOG))

    kern = kernel_phase(dev)
    by_path = {}
    by_path["verify"], vbe, vhonest, vrate = main_path_phase(card)
    by_path["show"], sbe, shonest, srate = show_path_phase(card)
    by_path["verify_combined"], crate = verify_combined_phase(card, vbe, vhonest, vrate)
    by_path["show_combined"], scrate = show_combined_phase(card, sbe, shonest, srate)
    by_path["grouped"], grate = grouped_phase(card, vbe, vhonest, vrate)
    by_path["g2_verify"], g2_creds = g2_verify_phase(
        card, {"exact": vrate, "combined": crate, "grouped": grate}
    )
    by_path["prove"], _ = prove_phase(card, vhonest, srate)
    by_path["show_g2"] = show_g2_phase(card, g2_creds, {"exact": srate, "combined": scrate})
    ragged_phase(card, vhonest)
    by_path["issue"], _ = issue_phase(card)
    by_path["issue_g2"] = issue_g2_phase(card)
    by_path["bucketed"] = bucketed_phase(card)
    log("done", seconds=time.perf_counter() - started, card=card)
    kern["launches"] = sum(by_path.values())
    kern["launches_by_path"] = by_path
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
