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
     bisection ladder on the batch's first 64 lanes with lanes 62
     (tampered sigma_2) and 63 (wrong message) forged: its bits, leaves,
     combined checks and wall time;
  7. show_combined: the same for ps.batch_show_verify(mode="batched") on
     the show path's honest batch, and its ladder on the batch's first 64
     shows with lanes 60-63 forged (60, a wrong revealed value, and 62, a
     doubled sigma'_2, fail the pairing check and must be the ladder's
     leaves; 61, a corrupted response, and 63, an identity sigma'_1, fail
     through their own bits);
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
 16. serve: the online verify service and the checkpointed stream over a
     fresh TorchBackend, on phase 4's credentials (one lane in 8 forged):
     per_credential — CredentialService(max_batch=1024, max_wait_ms=50)
     answers phase 4's batch once cold, then 4,096 requests (the batch
     four times, shuffled, bulk lane) queued before start: every verdict
     the expected one, no watchdog timeout, every executor HEALTHY;
     served verifies/s beside phase 4's batch_verify rate and p50/p99 of
     serve_latency_s; grouped — an honest batch all True from ONE grouped
     check, then its first 64 requests with lane 63 forged: the dead-letter
     JSONL names exactly that request, the rest True (wall, checks, bisections); batched — an
     honest batch all True from ONE combined check; faults —
     FaultyBackend(raise_on={0}) under RetryPolicy(max_attempts=2,
     base_delay=0): exact bits, retries 1; lone request — one interactive
     request on an idle service with pad_partial True and False, median
     of 3 each; stream — verify_stream over 4 batches with a checkpoint,
     pipeline_depth 1 and 2 (tallies 3,584 / 512 exact), and a run
     stopped after 2 batches resumed to the same tallies; pool — served
     verifies/s of half the backlog with one executor against two on the
     same card.
 17. issue_service: the threshold-issuance service (BASELINE config 4,
     G1, 1,024 users with an ElGamal key pair each, 3-of-5): requests from
     batch_prepare_blind_sign with the 1,024 public keys on the card, then
     IssuanceService(backend=None, max_batch=1024, max_wait_ms=50) — five
     authorities over one cuda TorchBackend — mints them in one cold
     fan-out, then a backlog of the 1,024 orders again, shuffled,
     queued before start: served issued credentials/s beside phase 13's
     bare round in the same process, issue_latency_s p50 / p99, the
     authorities' dispatches, minted and hedge counts, the verkey-table
     builds of the subsets. Gates: all 2,048 credentials verify on the
     card under the subsets' aggregated verkey, 16 lanes equal the host
     spec's Signature.aggregate of BlindSignature.new partials under a
     subset no fan-out used, no watchdog timeout, every authority
     HEALTHY. Faults at B = 64: authority 2 crashing and authority 3
     hanging (a 15 s watchdog budget expires the hang) — all 64 mint and
     verify, one crash, both QUARANTINED; a corrupt partial from
     authority 2 while 4 and 5 wait — lane 0 held back, the partial
     attributed, every credential verifies; authorities 1-3 crashing —
     every future fails with QuorumUnreachableError. Mixed load:
     run_loadgen, open loop at half the bare issuance rate for 1 s, half
     the arrivals to the issuance service (its window the load's 1 s and
     0.5 s more: one fan-out), half to a CredentialService
     (None, max_batch=1024) over phase 17's first 1,024 credentials (one
     in 8 forged): 0 mismatches, 0 drops, 0 terminal errors; both
     sections' p50 / p99 and goodput.
 18. keylife_session: config 4 without a trusted dealer (G1, 6
     attributes, 2 hidden, {2, 3, 4, 5} revealed): entry.keylife_fixture
     bootstraps epoch 1 by a seeded DKG in which dealer 2 corrupts its
     share to authority 4 (the complaint must name exactly dealer 2, who
     is excluded); ProtocolEngine(backend="torch", max_batch=1024,
     max_wait_ms=50, keychain=the registry) with the manager attached, and
     1,024 users with a key pair each. 1,024 full sessions (prepare ->
     mint -> verify -> show_prove -> show_verify, each hop one batch), cold
     then warm: every verdict True, every credential of epoch 1, 16 lanes
     True on the host spec (ps_verify, pok_sig.show_verify). A refresh with
     1,024 mints in flight (verkey bytes unchanged, every share moved, the
     straddlers of epoch 1 verify), a reshare to 2-of-5 with 1,024 mints
     in flight (epoch 2, a new verkey, the straddlers verify under their
     stamp), 1,024 mints under epoch 2, then one batch of 512 epoch-1 and
     512 epoch-2 credentials verified (two dispatches of 512, counted),
     proved and show-verified (two epoch groups each); the epoch-1
     credentials presented as epoch 2 verify False, epoch 42 refuses with
     EpochUnknownError, two more reshares retire epoch 1 (EpochRetiredError
     naming live epochs [2, 3, 4]) while epoch 2 still verifies; then
     run_session_loadgen for 4 s, closed loop, 64 clients over the 1,024
     identities. Prints the key rounds' walls, every hop's wall, the warm
     hops' rates beside the bare rates of phases main_path, show_path,
     prove and issue, sessions/s with p50 / p99 and per-program goodput,
     the keylife_* counters, pins (0), dangling futures (0), launches and
     plain calls (0).
 19. ct_probe: batch_blind_sign at B = 1024 on phase 18's requests under
     the five secret-key patterns of probes/probe_ct.py (zeros, ones,
     dense maximal digits, r - 1, random), after an untimed warm-up, the
     patterns in turn 5 times: each pattern's median wall and the host
     encode of its secret scalars (GLV split, signed digits uploaded), the
     max/min of the medians beside the run-to-run spread (the largest
     max/min of one pattern's walls); two lanes a pattern equal
     BlindSignature.new on the host spec.
 20. nullifier: double-spend detection on phase 18's key manager and
     users. A StateStore (WAL segments of 1 GiB) is prefilled with 2^20
     seeded digests in the active epoch's keyspace, 16 group commits
     (timed, and the RSS it adds). The table is built (host) and uploaded,
     and the membership probe runs on the card for 1,024 queries (512
     spent, 171 fresh, 171 one bit off a spent digest in the last limb,
     170 with every limb's top bit set): its mask must equal the plain
     version's on CPU tensors and the expected one; CUDA-event median of
     5, torch launches (torch.profiler). A ProtocolEngine over the store
     (keychain attached) mints 1,024 credentials under the active epoch
     and proves three rounds of shows; an unguarded engine on the same
     backend verifies the first round cold and warm; then, guarded: the
     round fresh (all True, 1,024 commits, one WAL fsync), the same round
     again (every lane DoubleSpendError with its nullifier, 1,024 probe
     hits, 1,024 schema-4 dead letters), a mixed batch of 512 fresh, 256
     replays and 128 duplicate pairs (each pair accepted once) in exact
     mode and again in batched mode (a combined check), a re-randomised
     re-show refused in domain "ecash" under its spend tag while another
     domain accepts the credential. The store is reopened from the WAL
     alone, compacted, reopened from the snapshot (each timed; every
     acknowledged digest present, every replay a probe hit on the card); a
     child python3 committing batches of 1,024 through
     NullifierGuard.commit is SIGKILLed mid-stream (every acknowledged
     digest present after reopening, at most one torn tail); reshares
     retire the epoch, and the retire hook of an engine over the reopened
     store drops its keyspaces (state_nullifiers_compacted equals their
     size). Gates: no probe or commit error, no watchdog timeout, launches
     and no plain call. Prints the guarded and unguarded walls, the
     guard's probe / commit / table walls, and every time above.
 21. gateway: the fleet gateway (net/) on the card. Verify: a
     CredentialService over a fresh TorchBackend (config 2 widths, the main
     path's 1,024 credentials with lane 1023 forged, max_batch=1024),
     warmed with one batch, then run_loadgen closed loop at 2,048 clients
     for 8 s direct and for 20 s through net.Replica.serve() on 127.0.0.1
     and a GatewayClient(SocketTransport) — the 2,048 requests in flight
     at the deadline are awaited, so each run carries at least two full
     batches. Gates: 0 dropped futures, 0 verdict mismatches, 0 errors,
     the forged credential False over the wire. Prints both goodputs,
     their ratio beside the reference's 0.8 bar (not a gate),
     rpc_overhead_s and the replica's mean decode_request ms. Fleet: two
     ProtocolEngines (config 3/4 widths: 6 attributes, 2 hidden, {2, 3,
     4, 5} revealed, 3-of-5 trusted-dealer keys, max_batch 64 with a
     1.5 s window, a StateStore each) behind two replicas on their own
     sockets with tenant tables, a ReplicaRouter with a live GossipLoop:
     64 full sessions through router.bound on the cold fleet, one replica
     killed 1 s after their mints went out, its 40 on the wire and in its
     queue (every mint settles on the survivor, the victim DOWN); the victim
     re-served on a new port, rejoining by beacon; 16 of the credentials
     shown again, with affinity back on it; there the greedy tenant's
     third request is refused with TenantQuotaError while
     the fleet tenant's verify beside it passes. State: StateReplicators
     over pull_state carry a show the rejoined replica (the witness)
     accepted to the other, the witness is killed without a drain, the
     replay is refused with DoubleSpendError (the nullifier restored from
     the envelope), and again by the survivor reopened from its WAL.
     Gates: every show True, 0 dangling futures, no
     watchdog timeout, launches and no plain call.

Each path's first call runs with the kernel's counts set to 0 just before
it and read just after; the kernel table's `launches` is their sum, and
`launches_by_path` holds each (g2_verify: the sum of its three paths';
prove: the prover's and its two FS verifies'; show_g2: the prover's and
its two verifies'; issue: the round's four stages'; issue_g2: the same;
bucketed: its three MSMs'; serve, issue_service, keylife_session,
ct_probe, nullifier and gateway: every run of the phase, counted from its
start to its end, with no plain call allowed).

Any failed check raises (non-zero exit). After the phases, a `done` line
gives the script's seconds since start and each phase's; then the kernel table, and last
the JSON result {"ok": true, "device": {...}}.
Needs a CUDA card: without one it exits non-zero before printing results.
"""

import collections
import concurrent.futures
import hashlib
import itertools
import json
import os
import random
import secrets
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from coconut_tpu_torch import entry, metrics, pok_sig, ps, sss
from coconut_tpu_torch import bench_fp_mul as kb
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.gpu.limbs import MONT_R
from coconut_tpu_torch.ops import hashing
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import P, R
from coconut_tpu_torch.errors import QuorumUnreachableError
from coconut_tpu_torch.faults import DeadLetterLog, FaultyBackend
from coconut_tpu_torch.issue import IssuanceService
from coconut_tpu_torch.profile_verify import issue_round, profile
from coconut_tpu_torch.retry import RetryPolicy
from coconut_tpu_torch.serve import CredentialService, run_loadgen, run_session_loadgen
from coconut_tpu_torch.serve.health import HealthPolicy, Watchdog
from coconut_tpu_torch.signature import fiat_shamir_challenge
from coconut_tpu_torch.stream import verify_stream

LANES = kb.MAIN_WIDTHS[-1]  # one fp12_mul at B = 1024: 54 base products per lane
BATCH = kb.BATCH
FORGE_EVERY = 8
# the bisection ladders run on the first 64 lanes with the last ones forged
# (verify: lanes 62 and 63; show: lanes 60-63, one of each kind), cut from
# 1,024 lanes forged apart: a check is launch-bound, ~1.3 s at any width,
# and the cut takes a ladder from 39 checks to 13 (verify) or 15 (show)
LADDER_BATCH = 64


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

    n = LADDER_BATCH - 2
    tsigs, tmsgs, texpect = entry.forge(params, sigs[n:LADDER_BATCH], msgs[n:LADDER_BATCH], every=1)
    fsigs, fmsgs = list(sigs[:n]) + tsigs, [list(m) for m in msgs[:n]] + tmsgs
    expect = [True] * n + texpect
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

    kinds = entry.SHOW_FORGERIES
    n = LADDER_BATCH - len(kinds)
    tproofs, trmsgs, texpect = entry.forge_shows(
        params, proofs[n:LADDER_BATCH], rmsgs[n:LADDER_BATCH], every=1
    )
    fproofs = list(proofs[:n]) + tproofs
    frmsgs = [dict(m) for m in rmsgs[:n]] + trmsgs
    expect = [True] * n + texpect
    lchallenges = challenges[:LADDER_BATCH]
    # the pairing check fails on the wrong revealed value and the doubled
    # sigma'_2 only: the ladder's leaves
    pairing_lanes = [
        n + k for k, kind in enumerate(kinds)
        if kind in ("wrong_revealed_value", "doubled_sigma_prime_2")
    ]
    rec = _Recorder(be, fproofs)
    ladder = _ladder(
        lambda: ps.batch_show_verify(
            fproofs, vk, params, frmsgs, lchallenges, rec, mode="batched"
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
    return launches, out["prove"]["proofs_per_s"]


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


SERVE_WAIT_MS = 50
SERVE_COPIES = 4  # the serve phase's backlog: phase 4's batch four times


class _Stop(Exception):
    """Stops a stream between two batches."""


def _served(svc, reqs, lane="bulk"):
    """Queue every (sig, messages) request on a service that is not started,
    start it, wait for every verdict and drain: (verdicts, seconds from
    start to the last verdict, seconds spent submitting)."""
    t0 = time.perf_counter()
    futs = [svc.submit(s, m, lane=lane) for s, m in reqs]
    submit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.start()
    got = [f.result(600.0) for f in futs]
    wall = time.perf_counter() - t0
    if not svc.drain(timeout=60.0):
        raise AssertionError("the service did not drain")
    return got, wall, submit_s


def _expect_verdicts(got, want, what):
    if got != want:
        wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError("%s: verdicts differ at requests %s" % (what, wrong[:16]))


def _healthy(svc, what):
    """No watchdog timeout since the last metrics reset, and every executor
    of `svc` HEALTHY; returns the executors' states."""
    states = {label: h.state for label, h in svc._healths.items()}
    timeouts = metrics.get_count("serve_watchdog_timeouts")
    if timeouts or any(st != "healthy" for st in states.values()):
        raise AssertionError("%s: %d watchdog timeouts, executors %s" % (what, timeouts, states))
    return states


def serve_phase(card, honest, exact_rate):
    """The online verify service and the checkpointed stream over a fresh
    TorchBackend, on phase 4's credentials."""
    params, _, vk, sigs, msgs = honest
    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=FORGE_EVERY)
    lanes = list(range(BATCH)) * SERVE_COPIES
    random.Random(0x5E7E).shuffle(lanes)
    backlog = [(fsigs[i], fmsgs[i]) for i in lanes]
    backlog_expect = [expect[i] for i in lanes]
    be = TorchBackend()  # cuda, window 9, raw wire
    started = time.perf_counter()
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    out = {}

    def service(**kw):
        kw.setdefault("max_batch", BATCH)
        kw.setdefault("max_wait_ms", SERVE_WAIT_MS)
        kw.setdefault("max_depth", 2 * len(backlog))
        return CredentialService(kw.pop("backend", be), vk, params, **kw)

    # per_credential: the batch once cold, then the shuffled backlog
    metrics.reset()
    svc = service()
    got, cold_s, _ = _served(svc, zip(fsigs, fmsgs))
    _expect_verdicts(got, expect, "cold batch")
    _healthy(svc, "cold batch")
    metrics.reset()
    svc = service()
    got, wall, submit_s = _served(svc, backlog)
    _expect_verdicts(got, backlog_expect, "backlog")
    states = _healthy(svc, "backlog")
    lat = metrics.snapshot()["histograms"]["serve_latency_s"]
    rate = len(backlog) / wall
    out["per_credential"] = {
        "cold_batch_s": cold_s, "requests": len(backlog), "wall_s": wall,
        "submit_s": submit_s, "served_verifies_per_s": rate,
        "batch_verify_per_s": exact_rate, "ratio_to_batch_verify": rate / exact_rate,
        "latency_p50_s": lat["p50_s"], "latency_p99_s": lat["p99_s"],
        "latency_max_s": lat["max_s"], "batches": metrics.get_count("serve_batches"),
        "pad_lanes": metrics.get_count("serve_pad_lanes"), "executors": states,
    }

    # grouped: an honest batch, then the ladders' 64 requests with the last
    # forged (cut from lane 511 of 1,024: 13 grouped checks instead of 21)
    mid = LADDER_BATCH - 1
    with tempfile.TemporaryDirectory() as tmp:
        dl = os.path.join(tmp, "dead.jsonl")
        metrics.reset()
        checks0 = be.grouped_checks
        svc = service(mode="grouped", dead_letter_path=dl)
        got, honest_s, _ = _served(svc, zip(sigs, msgs))
        _expect_verdicts(got, [True] * BATCH, "grouped, honest")
        honest_checks = be.grouped_checks - checks0
        checks0 = be.grouped_checks
        svc = service(mode="grouped", dead_letter_path=dl)
        got, forged_s, _ = _served(
            svc, zip(_forged_sigma_2(params, sigs[:LADDER_BATCH], mid), msgs[:LADDER_BATCH]))
        _expect_verdicts(got, [i != mid for i in range(LADDER_BATCH)], "grouped, lane 63 forged")
        named = [(r["credential"], r["program"]) for r in DeadLetterLog.read(dl)]
    if honest_checks != 1 or named != [(mid, "verify")]:
        raise AssertionError(
            "grouped: %d checks on the honest batch, dead letters %s" % (honest_checks, named)
        )
    _healthy(svc, "grouped")
    out["grouped"] = {
        "honest_wall_s": honest_s, "honest_grouped_checks": honest_checks,
        "forged_lane": mid, "forged_wall_s": forged_s,
        "forged_grouped_checks": be.grouped_checks - checks0,
        "bisections": metrics.get_count("bisections"), "dead_letters": named,
    }

    # batched: one combined check for an honest batch
    metrics.reset()
    checks0 = be.combined_checks
    svc = service(mode="batched")
    got, batched_s, _ = _served(svc, zip(sigs, msgs))
    _expect_verdicts(got, [True] * BATCH, "batched, honest")
    if be.combined_checks - checks0 != 1:
        raise AssertionError("batched: %d combined checks" % (be.combined_checks - checks0))
    _healthy(svc, "batched")
    out["batched"] = {"wall_s": batched_s, "combined_checks": 1}

    # faults: the first dispatch raises, the retry serves the batch
    metrics.reset()
    fb = FaultyBackend(be, raise_on={0})
    svc = service(backend=fb, retry_policy=RetryPolicy(max_attempts=2, base_delay=0))
    got, faults_s, _ = _served(svc, zip(fsigs, fmsgs))
    _expect_verdicts(got, expect, "faults")
    if metrics.get_count("retries") != 1 or fb.dispatches != 2:
        raise AssertionError(
            "faults: %d retries over %d dispatches" % (metrics.get_count("retries"), fb.dispatches)
        )
    _healthy(svc, "faults")
    out["faults"] = {"wall_s": faults_s, "retries": 1, "dispatches": fb.dispatches}

    # one interactive request on an idle service, padded and not
    out["lone_request"] = {"max_wait_ms": SERVE_WAIT_MS}
    for pad in (True, False):
        metrics.reset()
        svc = service(pad_partial=pad).start()
        walls = []
        for k in range(3):
            lane = (FORGE_EVERY - 2 + k) % BATCH  # lanes 6-8: lane 7 forged
            t0 = time.perf_counter()
            ok = svc.submit(fsigs[lane], fmsgs[lane]).result(600.0)
            walls.append(time.perf_counter() - t0)
            if ok != expect[lane]:
                raise AssertionError("lone request on lane %d: wrong verdict" % lane)
        if not svc.drain(timeout=60.0):
            raise AssertionError("the service did not drain")
        _healthy(svc, "lone request")
        out["lone_request"]["padded" if pad else "unpadded"] = {
            "median_s": statistics.median(walls), "walls_s": walls,
            "pad_lanes": metrics.get_count("serve_pad_lanes"),
        }

    # stream: 4 batches with a checkpoint at depths 1 and 2, then a stop
    # after 2 batches and a resume
    tallies = (SERVE_COPIES * expect.count(True), SERVE_COPIES * expect.count(False))
    source = lambda i: (fsigs, fmsgs)
    out["stream"] = {"batches": SERVE_COPIES, "tallies": tallies}
    with tempfile.TemporaryDirectory() as tmp:
        for depth in (1, 2):
            t0 = time.perf_counter()
            st = verify_stream(
                source, SERVE_COPIES, vk, params, be,
                state_path=os.path.join(tmp, "depth%d.json" % depth), pipeline_depth=depth,
            )
            wall = time.perf_counter() - t0
            if (st.next_batch, st.verified, st.failed) != (SERVE_COPIES,) + tallies:
                raise AssertionError("stream at depth %d: tallies %s" % (depth, vars(st)))
            out["stream"]["depth_%d" % depth] = {
                "wall_s": wall, "verifies_per_s": SERVE_COPIES * BATCH / wall,
            }

        stop = SERVE_COPIES // 2

        def stopping(i):
            if i == stop:
                raise _Stop()
            return source(i)

        path = os.path.join(tmp, "resume.json")
        try:
            verify_stream(stopping, SERVE_COPIES, vk, params, be, state_path=path,
                          pipeline_depth=1)
            raise AssertionError("the stream did not stop")
        except _Stop:
            pass
        with open(path) as f:
            stopped_at = json.load(f)["payload"]["next_batch"]
        st = verify_stream(source, SERVE_COPIES, vk, params, be, state_path=path)
        if stopped_at != stop or (st.next_batch, st.verified, st.failed) != (SERVE_COPIES,) + tallies:
            raise AssertionError("resume from %d gave %s" % (stopped_at, vars(st)))
        out["stream"]["resumed_from"] = stopped_at

    # the pool: one executor against two on the same card, on half the
    # backlog (two batches)
    half = len(backlog) // 2
    out["pool"] = {"requests": half}
    for n in (1, 2):
        metrics.reset()
        svc = service(devices=[torch.device("cuda", 0)] * n)
        got, wall, _ = _served(svc, backlog[:half])
        _expect_verdicts(got, backlog_expect[:half], "pool of %d" % n)
        _healthy(svc, "pool of %d" % n)
        out["pool"]["devices_%d" % n] = {
            "wall_s": wall, "served_verifies_per_s": half / wall,
            "dispatches": {
                k: v for k, v in metrics.counters_with_prefix("serve_dev").items()
                if k.endswith("_dispatches")
            },
        }
    out["pool"]["ratio"] = (
        out["pool"]["devices_2"]["served_verifies_per_s"]
        / out["pool"]["devices_1"]["served_verifies_per_s"]
    )

    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain:
        raise AssertionError("serve phase: %d launches, %d plain calls" % (launches, plain))
    log("serve", batch=BATCH, attrs=entry.MSG_COUNT, window=be.window, **out,
        launches=launches, plain_calls=plain, seconds=time.perf_counter() - started,
        card=card)
    return launches


ISSUE_COPIES = 1  # the issuance backlog: the 1,024 orders once (cut from twice)
FAULT_BATCH = 64  # the fault gates' orders (a gate, not a rate)
HANG_BUDGET_S = 15.0  # the fault service's first watchdog budget
# cut from 10 s, then 3 s, to keep the script inside its time limit. The
# mixed load's settling does not follow its length (on an H100: 78.6 s
# after 3 s, 80.0 s after 1.5 s, four issuance fan-outs each time), so its
# issuance service also coalesces over the whole load: one fan-out
MIXED_SECONDS = 1.0


class _Gated:
    """An authority backend that signs on the card only once `release` is
    set: pins the first three partials to the other authorities."""

    def __init__(self, be, release):
        self.be, self.release = be, release

    def batch_blind_sign(self, reqs, sigkey, params):
        if not self.release.wait(600.0):
            raise AssertionError("gate never released")
        return sig.batch_blind_sign(reqs, sigkey, params, self.be)


def _minted(svc, orders, what):
    """Queue every order on a service that is not started, start it, wait
    for every credential: (credentials, seconds from start to the last)."""
    futs = [svc.submit(req, m, sk) for req, m, sk in orders]
    t0 = time.perf_counter()
    svc.start()
    creds = [f.result(900.0) for f in futs]
    wall = time.perf_counter() - t0
    if len(creds) != len(orders):
        raise AssertionError("%s: %d credentials" % (what, len(creds)))
    return creds, wall


def _drained(svc, what):
    if not svc.drain(timeout=120.0):
        raise AssertionError("%s: the service did not drain" % what)


def _verified(be, creds, msgs, vk, params, what):
    """Every credential verifies on the card under `vk`, 1,024 at a time."""
    for lo in range(0, len(creds), BATCH):
        got = be.batch_verify(creds[lo : lo + BATCH], msgs[lo : lo + BATCH], vk, params)
        if got != [True] * len(got):
            raise AssertionError("%s: %d credentials fail" % (what, got.count(False)))


def _auth_counts():
    return {
        k: v for k, v in sorted(metrics.counters_with_prefix("issue_auth").items())
        if k.endswith("_dispatches")
    }


def _issue_counts():
    return {k: metrics.get_count("issue_" + k) for k in (
        "minted", "hedges", "hedge_no_spare", "partials_discarded", "cancelled_signs",
        "sign_skips", "corrupt_partials", "authority_crashes", "watchdog_timeouts",
        "quorum_unreachable", "redispatched", "failed_requests", "batches",
    )}


def _wait_for(pred, what, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for %s" % what)
        time.sleep(0.01)


def issue_service_phase(card, bare_rate):
    """The threshold-issuance service (BASELINE config 4, G1, 1,024 users
    with a key pair each, 3-of-5) on the card: one cold fan-out, a backlog
    of 1,024 orders, the fault gates at B = 64 and the mixed verify + issue
    load."""
    started = time.perf_counter()
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    params, signers, esks, epks, msgs = entry.issue_fixture(BATCH, user_keys=True)
    fixture_s = time.perf_counter() - t0
    t = entry.ISSUANCE_THRESHOLD
    out = {"fixture_s": fixture_s}

    # the users' requests, each under its own ElGamal key, on the card
    pbe = TorchBackend()
    t0 = time.perf_counter()
    with entry.seeded_draws(0x0DE5):
        prepared = sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epks, params, pbe)
    out["prepare_s"] = time.perf_counter() - t0
    orders = [(req, m, sk) for (req, _), m, sk in zip(prepared, msgs, esks)]

    # one cold fan-out, then the backlog on a service over the warm backend
    metrics.reset()
    svc = IssuanceService(signers, params, t, backend=None, max_batch=BATCH,
                          max_wait_ms=SERVE_WAIT_MS)
    be = svc.minter.backend
    if be.device.type != "cuda" or any(a.backend is not be for a in svc._authorities):
        raise AssertionError("backend=None is not one cuda TorchBackend for every authority")
    cold, cold_s = _minted(svc, orders, "cold fan-out")
    _drained(svc, "cold fan-out")
    cold_counts = _issue_counts()
    cold_builds = be.encode_cache_misses
    lanes = list(range(BATCH)) * ISSUE_COPIES
    random.Random(0x155E).shuffle(lanes)
    metrics.reset()
    misses = be.encode_cache_misses
    svc = IssuanceService(signers, params, t, backend=be, max_batch=BATCH,
                          max_wait_ms=SERVE_WAIT_MS, max_depth=2 * len(lanes))
    creds, wall = _minted(svc, [orders[i] for i in lanes], "backlog")
    hists = metrics.snapshot()["histograms"]
    lat = hists["issue_latency_s"]
    quorum_wait = hists["issue_quorum_wait_s"]
    counts = _issue_counts()
    auth_counts = _auth_counts()
    auth_busy = metrics.timers_with_prefix("issue_auth")
    _drained(svc, "backlog")
    if counts["watchdog_timeouts"] or cold_counts["watchdog_timeouts"]:
        raise AssertionError("issuance watchdog timeouts: %s, %s" % (cold_counts, counts))
    states = {a.label: svc._health_of(a.label).state for a in svc._authorities}
    if any(st != "healthy" for st in states.values()):
        raise AssertionError("authorities %s" % states)
    rate = len(lanes) / wall

    # every credential verifies under the subsets' aggregated verkey (one
    # verkey whatever the subset), and 16 lanes equal the spec's aggregate
    # under a subset no fan-out used
    used = sorted(svc.minter._agg_cache)
    vks = list(svc.minter._agg_cache.values())
    if any(v != vks[0] for v in vks):
        raise AssertionError("the subsets' aggregated verkeys differ")
    vk = vks[0]
    all_creds = cold + creds
    all_msgs = msgs + [msgs[i] for i in lanes]
    t0 = time.perf_counter()
    _verified(be, all_creds, all_msgs, vk, params, "minted credentials")
    verify_s = time.perf_counter() - t0
    other = next(s for s in itertools.combinations(range(1, 6), t) if s not in used)
    ctx = params.ctx
    spot = list(range(0, BATCH, max(1, BATCH // 16)))
    for i in spot:
        req, m, sk = orders[i]
        parts = [(j, sig.BlindSignature.new(req, signers[j - 1].sigkey, params).unblind(sk, ctx))
                 for j in other]
        want = sig.Signature.aggregate(t, parts, ctx)
        if cold[i] != want or any(creds[k] != want for k, lane in enumerate(lanes) if lane == i):
            raise AssertionError("lane %d differs from the spec's aggregate under %s" % (i, other))
    out["served"] = {
        "cold_fanout_s": cold_s, "cold_counts": cold_counts, "requests": len(lanes),
        "wall_s": wall, "issued_credentials_per_s": rate, "bare_round_per_s": bare_rate,
        "ratio_to_bare_round": rate / bare_rate, "latency_p50_s": lat["p50_s"],
        "latency_p99_s": lat["p99_s"], "latency_max_s": lat["max_s"], "counts": counts,
        "quorum_wait_p50_s": quorum_wait["p50_s"], "quorum_wait_max_s": quorum_wait["max_s"],
        "authority_dispatches": auth_counts, "authority_busy_s": auth_busy, "authorities": states,
        "subsets_used": [list(s) for s in used],
        "verkey_table_builds": {"cold": cold_builds, "backlog": be.encode_cache_misses - misses},
        "verified": len(all_creds), "verify_s": verify_s, "spec_lanes": len(spot),
        "spec_subset": list(other),
    }

    # faults at B = 64: a crashed and a hung authority, a corrupt partial,
    # then three crashed authorities
    few = orders[:FAULT_BATCH]
    few_msgs = msgs[:FAULT_BATCH]
    patient = HealthPolicy(probe_after_s=600.0)
    metrics.reset()
    crash = FaultyBackend(be, crash_sign_on=(0,))
    hang = FaultyBackend(be, hang_sign_on=(0,), hang_max_s=600.0)
    svc = IssuanceService(
        signers, params, t, backend=be, backends=[be, crash, hang, be, be],
        max_batch=FAULT_BATCH, max_wait_ms=SERVE_WAIT_MS, health_policy=patient,
        watchdog=Watchdog(initial_timeout_s=HANG_BUDGET_S),
    )
    t0 = time.perf_counter()
    try:
        got, crash_s = _minted(svc, few, "crash and hang")
        _verified(be, got, few_msgs, vk, params, "crash and hang")
        _wait_for(lambda: metrics.get_count("issue_watchdog_timeouts") == 1, "the hang's expiry")
        expired_s = time.perf_counter() - t0
    finally:
        hang.hang_release.set()
    _drained(svc, "crash and hang")
    states = {a.label: svc._health_of(a.label).state for a in svc._authorities}
    if (crash.crashes, metrics.get_count("issue_authority_crashes"), states["2"], states["3"]) != (
        1, 1, "quarantined", "quarantined"
    ) or metrics.get_count("issue_minted") != FAULT_BATCH:
        raise AssertionError("crash and hang: %s, %s" % (states, _issue_counts()))
    out["crash_and_hang"] = {"wall_s": crash_s, "hang_expired_after_s": expired_s,
                             "states": states, "counts": _issue_counts()}

    metrics.reset()
    release = threading.Event()
    corrupt = FaultyBackend(be, corrupt_partial_on=(0,))
    svc = IssuanceService(
        signers, params, t, backend=be,
        backends=[be, corrupt, be, _Gated(be, release), _Gated(be, release)],
        max_batch=FAULT_BATCH, max_wait_ms=SERVE_WAIT_MS,
        health_policy=HealthPolicy(suspect_after=1, quarantine_after=1, probe_after_s=600.0),
    )
    futs = [svc.submit(req, m, sk) for req, m, sk in few]
    t0 = time.perf_counter()
    try:
        svc.start()
        _wait_for(lambda: metrics.get_count("issue_corrupt_partials") == 1, "attribution")
        # the corrupt partial is lane 0's: the round released the other
        # lanes (they verified) and held lane 0 back
        if futs[0].done():
            raise AssertionError("lane 0 left the corrupt round")
    finally:
        release.set()
    got = [f.result(900.0) for f in futs]
    corrupt_s = time.perf_counter() - t0
    _drained(svc, "corrupt partial")
    _verified(be, got, few_msgs, vk, params, "corrupt partial")
    if (corrupt.corrupted_partials, metrics.get_count("issue_corrupt_partials"),
            metrics.get_count("issue_minted"), svc._health_of("2").state) != (
            1, 1, FAULT_BATCH, "quarantined"):
        raise AssertionError("corrupt partial: %s" % _issue_counts())
    out["corrupt_partial"] = {"wall_s": corrupt_s, "counts": _issue_counts()}

    metrics.reset()
    crashes = [FaultyBackend(be, crash_sign_on=(0,)) for _ in range(3)]
    svc = IssuanceService(signers, params, t, backend=be, backends=crashes + [be, be],
                          max_batch=FAULT_BATCH, max_wait_ms=SERVE_WAIT_MS, health_policy=patient)
    futs = [svc.submit(req, m, sk) for req, m, sk in few]
    t0 = time.perf_counter()
    svc.start()
    errs = [f.exception(900.0) for f in futs]
    loss_s = time.perf_counter() - t0
    _drained(svc, "quorum loss")
    if not all(isinstance(e, QuorumUnreachableError) for e in errs) or not all(f.done() for f in futs):
        raise AssertionError("quorum loss: %s" % sorted({type(e).__name__ for e in errs}))
    out["quorum_loss"] = {"typed_failures": len(errs), "wall_s": loss_s, "counts": _issue_counts()}

    # mixed verify + issue load, open loop at half the bare issuance rate
    vsigs, vmsgs, expect = entry.forge(params, cold, msgs, every=FORGE_EVERY)
    pool = list(zip(vsigs, vmsgs, expect))
    metrics.reset()
    vsvc = CredentialService(None, vk, params, max_batch=BATCH).start()
    isvc = IssuanceService(signers, params, t, backend=be, max_batch=BATCH,
                           max_wait_ms=1000.0 * MIXED_SECONDS + 500.0, max_depth=4 * BATCH).start()
    try:
        report = run_loadgen(
            vsvc, pool, duration_s=MIXED_SECONDS, arrival="open", rate_per_s=bare_rate / 2,
            rng=random.Random(0x3117), result_timeout=900.0, issue_service=isvc,
            issue_pool=orders, issue_fraction=0.5,
        )
    finally:
        _drained(vsvc, "mixed verify")
        _drained(isvc, "mixed issue")
    iss = report["issue"]
    bad = {
        "verdict_mismatches": report["verdict_mismatches"], "mint_mismatches": iss["mint_mismatches"],
        "dropped": report["dropped_futures"] + iss["dropped_futures"],
        "terminal_errors": report["errors_terminal"] + iss["errors"],
    }
    if any(bad.values()) or not report["completed"] or not iss["minted"]:
        raise AssertionError("mixed load: %s" % bad)
    pick = lambda r: {k: r[k] for k in ("submitted", "goodput_per_s", "latency_s",
                                         "mean_batch_occupancy", "rejected", "shed")}
    out["mixed"] = {
        "seconds": report["duration_s"], "offered_per_s": bare_rate / 2, **bad,
        "verify": dict(pick(report), completed=report["completed"]),
        "issue": dict(pick(iss), minted=iss["minted"], fanouts=iss["fanouts"],
                      hedges=iss["hedges"], partials_discarded=iss["partials_discarded"]),
    }

    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain:
        raise AssertionError("issue_service phase: %d launches, %d plain calls" % (launches, plain))
    log("issue_service", batch=BATCH, attrs=entry.MSG_COUNT, hidden=entry.ISSUANCE_HIDDEN,
        threshold="%d-of-%d" % (t, entry.ISSUANCE_SIGNERS), window=be.window, **out,
        launches=launches, plain_calls=plain, seconds=time.perf_counter() - started, card=card)
    return launches


HOP_WAIT_MS = 600000.0  # a hop's requests flush as one full batch, never by deadline
SESSION_SECONDS = 4.0  # cut from 20 s, then 8 s, to keep the script inside its time limit
SESSION_CONCURRENCY = 64  # cut from 256: one wave of sessions either way
SPEC_LANES = 16
# the pool's hung-dispatch floor: one executor runs every pool program, so
# its EMA mixes 0.1 s prepare batches with 2 s show-verify ones
SESSION_WATCHDOG_FLOOR_S = 60.0


def _on_card(be, what):
    if be.device.type != "cuda":
        raise AssertionError("%s is not a cuda TorchBackend" % what)


def _tamper_one(dealer, recipient, dim=0):
    """run_dkg's fault hook: `dealer` corrupts its share for `recipient`."""

    def tamper(d, r, dm, share):
        if (d, r, dm) == (dealer, recipient, dim):
            return (share[0] + 1, share[1])
        return None

    return tamper


class _Hops:
    """Queues every request of a hop with a deadline it never reaches, so
    the batcher flushes them as one full batch; keeps every future."""

    def __init__(self):
        self.futures = []
        self.walls = {}

    def run(self, what, submits):
        t0 = time.perf_counter()
        futs = [submit(HOP_WAIT_MS) for submit in submits]
        self.futures.extend(futs)
        out = [f.result(900.0) for f in futs]
        self.walls.setdefault(what, []).append(time.perf_counter() - t0)
        return out


def _all_true(bits, what, want=True):
    if any(b is not want for b in bits):
        raise AssertionError("%s: %d of %d verdicts are not %s"
                             % (what, sum(b is not want for b in bits), len(bits), want))


def _counted_calls(obj, name, calls):
    """Wrap obj.name so each call appends its first argument to `calls`."""
    inner = getattr(obj, name)

    def counted(*args, **kw):
        calls.append(args[0] if args else None)
        return inner(*args, **kw)

    setattr(obj, name, counted)


def _session_round(eng, hops, users, tag):
    """Every user through prepare -> mint -> verify -> show_prove ->
    show_verify, each hop one batch of 1,024."""
    prepared = hops.run(tag + "prepare", [
        lambda w, m=m, pk=pk: eng.submit_prepare(m, pk, max_wait_ms=w) for m, pk, _ in users
    ])
    creds = hops.run(tag + "mint", [
        lambda w, r=r, m=m, sk=sk: eng.submit_mint(r, m, sk, max_wait_ms=w)
        for (r, _), (m, _, sk) in zip(prepared, users)
    ])
    bits = hops.run(tag + "verify", [
        lambda w, c=c, m=m: eng.submit_verify(c, m, max_wait_ms=w) for c, (m, _, _) in zip(creds, users)
    ])
    proofs = hops.run(tag + "show_prove", [
        lambda w, c=c, m=m: eng.submit_show_prove(c, m, max_wait_ms=w) for c, (m, _, _) in zip(creds, users)
    ])
    shows = hops.run(tag + "show_verify", [
        lambda w, p=p, c=c: eng.submit_show_verify(p[0], p[2], p[1], epoch=c.epoch, max_wait_ms=w)
        for p, c in zip(proofs, creds)
    ])
    _all_true(bits, tag + "verify")
    _all_true(shows, tag + "show_verify")
    return prepared, creds, proofs


def _verify_hop(eng, hops, what, creds, msgs):
    return hops.run(what, [
        lambda w, c=c, m=m: eng.submit_verify(c, m, max_wait_ms=w) for c, m in zip(creds, msgs)
    ])


def _mint_inflight(eng, hops, prepared, users, round_fn, what):
    """Queue a full mint hop, run a key round while it is in flight, then
    settle the mints: (credentials, the round's wall, its keyset)."""
    futs = [
        eng.submit_mint(r, m, sk, max_wait_ms=HOP_WAIT_MS)
        for (r, _), (m, _, sk) in zip(prepared, users)
    ]
    hops.futures.extend(futs)
    t0 = time.perf_counter()
    ks = round_fn()
    round_s = time.perf_counter() - t0
    creds = [f.result(900.0) for f in futs]
    hops.walls.setdefault(what, []).append(time.perf_counter() - t0)
    return creds, round_s, ks


def keylife_session_phase(card, bare):
    """Config 4 without a trusted dealer on one ProtocolEngine: DKG with a
    corrupt dealer named, 1,024 full sessions, a refresh and a reshare
    with 1,024 mints in flight, a batch over two epochs, wrong, unknown
    and retired epochs, then a closed-loop session load."""
    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.errors import EpochRetiredError, EpochUnknownError
    from coconut_tpu_torch.signature import Signature

    started = time.perf_counter()
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    metrics.reset()
    rounds_s = {}
    t0 = time.perf_counter()
    params, mgr, ks1 = entry.keylife_fixture(tamper=_tamper_one(2, 4))
    rounds_s["dkg"] = time.perf_counter() - t0
    if mgr.last_round.complaints != {2: (4,)} or ks1.excluded != (2,):
        raise AssertionError("DKG complaints %s, excluded %s"
                             % (mgr.last_round.complaints, ks1.excluded))
    t0 = time.perf_counter()
    _, _, esks, epks, msgs = entry.issue_fixture(BATCH, user_keys=True)
    users = list(zip(msgs, epks, esks))
    fixture_s = time.perf_counter() - t0
    ctx = params.ctx
    revealed = list(entry.SHOW_REVEALED)
    eng = ProtocolEngine(
        ks1.signers, params, entry.ISSUANCE_THRESHOLD, count_hidden=entry.ISSUANCE_HIDDEN,
        revealed_msg_indices=revealed, vk=ks1.vk, backend="torch", devices=1,
        max_batch=BATCH, max_wait_ms=SERVE_WAIT_MS, max_depth=2 * BATCH,
        keychain=mgr.registry, watchdog=Watchdog(min_timeout_s=SESSION_WATCHDOG_FLOOR_S),
    )
    be = eng.backend
    _on_card(be, "backend='torch'")
    mgr.attach(eng)
    eng.start()
    hops = _Hops()
    groups = {"verify": [], "show_prove": [], "show_verify": []}
    split = eng._verify._dispatch_by_epoch

    def by_epoch(fn, sigs, messages_list):
        def counted(s, m, vk):
            groups["verify"].append(len(s))
            return fn(s, m, vk)

        return split(counted, sigs, messages_list)

    eng._verify._dispatch_by_epoch = by_epoch
    _counted_calls(eng._prove, "_vk_for", groups["show_prove"])
    _counted_calls(eng._showv, "_vk_for", groups["show_verify"])
    out = {"fixture_s": fixture_s}
    try:
        # 1) full sessions, cold then warm
        prepared, creds1, proofs = _session_round(eng, hops, users, "cold_")
        prepared, creds1, proofs = _session_round(eng, hops, users, "")
        if any(c.epoch != 1 for c in creds1):
            raise AssertionError("a credential left the first round without epoch 1")
        vk1 = ks1.vk
        t0 = time.perf_counter()
        for i in range(0, BATCH, max(1, BATCH // SPEC_LANES)):
            p, c, rv = proofs[i]
            if not (ps.ps_verify(creds1[i], msgs[i], vk1, params)
                    and pok_sig.show_verify(p, vk1, params, rv, c)):
                raise AssertionError("lane %d fails the host spec" % i)
        spec_s = time.perf_counter() - t0
        hop_rates = {k: BATCH / v[-1] for k, v in hops.walls.items() if not k.startswith("cold_")}
        session_round_s = sum(hops.walls[k][-1] for k in hop_rates)

        # 2) proactive refresh with 1,024 mints in flight: same verkey,
        # every share moved, the straddlers settle under epoch 1
        before = [(s.sigkey.x, tuple(s.sigkey.y)) for s in ks1.signers]
        creds_r, rounds_s["refresh"], ks1r = _mint_inflight(
            eng, hops, prepared, users, mgr.refresh, "mint_across_refresh")
        after = [(s.sigkey.x, tuple(s.sigkey.y)) for s in ks1r.signers]
        if ks1r.vk.to_bytes(ctx) != vk1.to_bytes(ctx) or any(a == b for a, b in zip(before, after)):
            raise AssertionError("the refresh moved the verkey or kept a share")
        if any(c.epoch != 1 for c in creds_r):
            raise AssertionError("a mint straddling the refresh left epoch 1")
        _all_true(_verify_hop(eng, hops, "verify_refreshed", creds_r, msgs), "refresh straddlers")

        # 3) reshare to 2-of-5 with 1,024 mints in flight: epoch 2, a new
        # verkey; the straddlers verify under their stamp
        creds_s, rounds_s["reshare_2_of_5"], ks2 = _mint_inflight(
            eng, hops, prepared, users,
            lambda: mgr.reshare(threshold=2, total=entry.ISSUANCE_SIGNERS), "mint_across_reshare")
        if ks2.epoch != 2 or ks2.vk.to_bytes(ctx) == vk1.to_bytes(ctx):
            raise AssertionError("the reshare made %r" % (ks2,))
        straddle = collections.Counter(c.epoch for c in creds_s)
        if set(straddle) - {1, 2}:
            raise AssertionError("reshare straddlers carry epochs %s" % dict(straddle))
        _all_true(_verify_hop(eng, hops, "verify_straddlers", creds_s, msgs), "reshare straddlers")

        # 4) one coalesced batch over two epochs: 512 epoch-1 and 512
        # epoch-2 credentials, verified and shown
        creds2 = hops.run("mint_epoch2", [
            lambda w, r=r, m=m, sk=sk: eng.submit_mint(r, m, sk, max_wait_ms=w)
            for (r, _), (m, _, sk) in zip(prepared, users)
        ])
        if any(c.epoch != 2 for c in creds2):
            raise AssertionError("a mint after the reshare left epoch 2")
        half = BATCH // 2
        mixed = creds1[:half] + creds2[half:]
        for g in groups.values():
            g.clear()
        _all_true(_verify_hop(eng, hops, "verify_two_epochs", mixed, msgs), "two-epoch verify")
        mproofs = hops.run("show_prove_two_epochs", [
            lambda w, c=c, m=m: eng.submit_show_prove(c, m, max_wait_ms=w) for c, m in zip(mixed, msgs)
        ])
        _all_true(hops.run("show_verify_two_epochs", [
            lambda w, p=p, c=c: eng.submit_show_verify(p[0], p[2], p[1], epoch=c.epoch, max_wait_ms=w)
            for p, c in zip(mproofs, mixed)
        ]), "two-epoch show verify")
        two_epoch_groups = {k: list(v) for k, v in groups.items()}
        if two_epoch_groups != {"verify": [half, half], "show_prove": [1, 2],
                                "show_verify": [1, 2]}:
            raise AssertionError("the two-epoch batch ran as %s" % two_epoch_groups)

        # 5) wrong, unknown and retired epochs
        wrong = []
        for c in creds1:
            w = Signature(c.sigma_1, c.sigma_2)
            w.epoch = 2
            wrong.append(w)
        _all_true(_verify_hop(eng, hops, "verify_wrong_epoch", wrong, msgs), "wrong epoch", False)
        unknown = Signature(creds1[0].sigma_1, creds1[0].sigma_2)
        unknown.epoch = 42
        try:
            eng.submit_verify(unknown, msgs[0])
            raise AssertionError("epoch 42 was admitted")
        except EpochUnknownError as e:
            unknown_msg = str(e)
        for tag in ("reshare_3", "reshare_4"):
            t0 = time.perf_counter()
            mgr.reshare()
            rounds_s[tag] = time.perf_counter() - t0
        try:
            eng.submit_verify(creds1[0], msgs[0])
            raise AssertionError("a retired epoch was admitted")
        except EpochRetiredError as e:
            retired_msg = str(e)
        if "live epochs: [2, 3, 4]" not in retired_msg:
            raise AssertionError("retired refusal: %s" % retired_msg)
        _all_true(_verify_hop(eng, hops, "verify_epoch2_after_retire", creds2, msgs),
                  "epoch 2 after the retirement")

        # 6) closed-loop sessions over the 1,024 identities
        pool = [(m, pk, sk) for m, pk, sk in users]
        load = run_session_loadgen(
            eng, pool, duration_s=SESSION_SECONDS, concurrency=SESSION_CONCURRENCY,
            rng=random.Random(0x5E55), result_timeout=900.0,
        )
    finally:
        if not eng.drain(timeout=300.0):
            raise AssertionError("the protocol engine did not drain")
    dangling = sum(not f.done() for f in hops.futures)
    pins = {e: mgr.registry.pin_count(e) for e in (1, 2, 3, 4)}
    if dangling or any(pins.values()):
        raise AssertionError("dangling futures %d, pins %s" % (dangling, pins))
    if load["failed_shows"] or load["errors"] or not load["sessions_completed"]:
        raise AssertionError("session load: %s" % {k: load[k] for k in (
            "sessions_completed", "failed_shows", "errors", "rejected", "shed")})
    counters = metrics.snapshot()["counters"]
    timeouts = {k: counters.get(k, 0) for k in ("serve_watchdog_timeouts", "issue_watchdog_timeouts")}
    if any(timeouts.values()):
        raise AssertionError("watchdog timeouts %s" % timeouts)
    keylife = {k: v for k, v in sorted(counters.items()) if k.startswith("keylife_")}
    if (keylife.get("keylife_refreshes"), keylife.get("keylife_reshares"),
            keylife.get("keylife_retirements")) != (1, 3, 1):
        raise AssertionError("keylife counters %s" % keylife)
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain:
        raise AssertionError("keylife_session phase: %d launches, %d plain calls" % (launches, plain))
    bare_rates = {"prepare": bare["prepare_per_s"], "mint": bare["issued_credentials_per_s"],
                  "verify": bare["verify_per_s"], "show_prove": bare["proofs_per_s"],
                  "show_verify": bare["show_verify_per_s"]}
    log(
        "keylife_session", batch=BATCH, attrs=entry.MSG_COUNT, hidden=entry.ISSUANCE_HIDDEN,
        revealed=revealed, threshold="3-of-5, then 2-of-5", window=be.window,
        dkg_complaints={"2": [4]}, dkg_excluded=list(ks1.excluded),
        key_rounds_s=rounds_s, hop_walls_s=hops.walls, hop_rates_per_s=hop_rates,
        bare_rates_per_s=bare_rates,
        hop_ratio_to_bare={k: hop_rates[k] / bare_rates[k] for k in hop_rates},
        session_round_s=session_round_s, sessions_per_s_one_round=BATCH / session_round_s,
        spec_lanes=SPEC_LANES, spec_s=spec_s, reshare_straddlers=dict(straddle),
        two_epoch_groups=two_epoch_groups, unknown_epoch=unknown_msg, retired_epoch=retired_msg,
        session_load={k: load[k] for k in (
            "duration_s", "concurrency", "sessions_started", "sessions_completed", "rejected",
            "shed", "errors", "failed_shows", "sessions_per_s", "session_latency_s",
            "per_program")},
        keylife_counters=keylife, pins=pins, dangling_futures=dangling, watchdog_timeouts=timeouts,
        engine_counters={k: v for k, v in sorted(counters.items()) if k.endswith(("_jit_shapes", "_done"))
                         or k in ("issue_minted", "issue_batches", "issue_hedges", "serve_batches")},
        live_epochs=mgr.registry.live_epochs(), launches=launches, plain_calls=plain,
        seconds=time.perf_counter() - started, card=card,
    )
    return launches, (params, prepared), (params, prepared, mgr, users)


CT_REPS = 5
# every signed 5-bit digit at its largest magnitude (probes/probe_ct.py)
_DENSE = sum(16 * (32**i) for i in range(51)) % R
CT_PATTERNS = {
    "zeros": sig.Sigkey(0, [0] * entry.MSG_COUNT),
    "ones": sig.Sigkey(1, [1] * entry.MSG_COUNT),
    "dense_max_digits": sig.Sigkey(_DENSE, [_DENSE] * entry.MSG_COUNT),
    "r_minus_1": sig.Sigkey(R - 1, [R - 1] * entry.MSG_COUNT),
    "random": sig.Sigkey(
        0x6A09E667F3BCC908 * 0x243F6A8885A308D3 % R,
        [(0x9E3779B97F4A7C15 * (i + 1) ** 5) % R for i in range(entry.MSG_COUNT)],
    ),
}


def ct_probe_phase(card, issued):
    """batch_blind_sign on one fixed B = 1024 request batch under the five
    secret patterns of probes/probe_ct.py, after an untimed warm-up: the
    call's wall and the host encode of its secret scalars (GLV split, then
    signed digits uploaded to the card) alone, median of 5, the patterns
    taken in turn each repetition. Prints max/min of the medians beside
    the run-to-run spread (the largest max/min of one pattern's walls)."""
    from coconut_tpu_torch.gpu import glv
    from coconut_tpu_torch.gpu.backend import _signed_digits

    started = time.perf_counter()
    params, prepared = issued
    reqs = [r for r, _ in prepared]
    be = TorchBackend()
    nwin = -(-glv.HALF_BITS // 5) + 1

    def encode(sk):
        _, _, scalars = sig.blind_sign_rows(reqs, sk, params.ctx)
        split = [[h for s in row for h in glv.decompose(s)] for row in scalars]
        _signed_digits(split, be.device, nwin=nwin)
        torch.cuda.synchronize()

    def blind_sign(sk):
        torch.cuda.synchronize()
        out = sig.batch_blind_sign(reqs, sk, params, be)
        torch.cuda.synchronize()
        return out

    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    for sk in CT_PATTERNS.values():  # untimed warm-up
        encode(sk)
        blind_sign(sk)
    walls = {k: [] for k in CT_PATTERNS}
    encodes = {k: [] for k in CT_PATTERNS}
    for _ in range(CT_REPS):
        for name, sk in CT_PATTERNS.items():
            t0 = time.perf_counter()
            encode(sk)
            encodes[name].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            blind_sign(sk)
            walls[name].append(time.perf_counter() - t0)
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain:
        raise AssertionError("ct_probe phase: %d launches, %d plain calls" % (launches, plain))
    # the probe's calls compute real blind signatures: each pattern's
    # partials match the host spec on two lanes
    for name, sk in CT_PATTERNS.items():
        got = blind_sign(sk)
        for i in (0, BATCH - 1):
            if got[i].to_bytes(params.ctx) != sig.BlindSignature.new(reqs[i], sk, params).to_bytes(params.ctx):
                raise AssertionError("ct_probe %s lane %d differs from the host spec" % (name, i))
    med = {k: statistics.median(v) for k, v in walls.items()}
    enc = {k: statistics.median(v) for k, v in encodes.items()}
    ratio = max(med.values()) / min(med.values())
    spread = max(max(v) / min(v) for v in walls.values())
    log(
        "ct_probe", batch=BATCH, reps=CT_REPS, wall_median_s=med, wall_min_s={
            k: min(v) for k, v in walls.items()}, host_encode_median_s=enc,
        host_encode_share={k: enc[k] / med[k] for k in med}, walls_s=walls,
        max_over_min_of_medians=ratio, run_to_run_spread=spread,
        spread_covers_ratio=spread >= ratio, launches=launches, plain_calls=plain,
        seconds=time.perf_counter() - started, card=card,
    )
    return launches


NULL_SPENT = 1 << 20  # the spent set of the active epoch's keyspace
NULL_CHUNK = 65536  # prefill group commits, one fsync each
NULL_FRESH, NULL_REPLAYS, NULL_PAIRS = 512, 256, 128  # a mixed batch's lanes
NULL_KILL_AFTER = 6  # child batches acknowledged before the SIGKILL
# the phase's WAL segment bound: the default (8 MiB, 4 rotated segments
# kept) drops the oldest records of a store that never compacts, and the
# 2^20 prefill alone is ~150 MB of frames
NULL_SEGMENT_BYTES = 1 << 30
# the SIGKILL drill's child: commits batches of 1,024 through the guard and
# prints each batch index once its group commit has returned (acknowledged)
_KILL_CHILD = """
import hashlib, sys
from coconut_tpu_torch.state import NullifierGuard, StateStore
guard = NullifierGuard(StateStore(sys.argv[1], replica_id="child"), use_device=False)
b = 0
while True:
    batch = [hashlib.sha256(b"kill/%d/%d" % (b, i)).hexdigest() for i in range(1024)]
    if not all(guard.commit(batch, epochs=[int(sys.argv[2])] * 1024)):
        sys.exit("a fresh digest was refused")
    print(b, flush=True)
    b += 1
"""


def _rss_mb():
    """This process's resident set now, in MiB (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / (1 << 20)


def _settled(futs):
    """Each future's verdict, or its exception."""
    out = []
    for f in futs:
        exc = f.exception(900.0)
        out.append(f.result(0) if exc is None else exc)
    return out


def _timed_calls(obj, name, walls):
    """Wrap obj.name so each call appends its host wall (s) to `walls`."""
    inner = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            walls.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def _kill_drill(root, epoch):
    """A child commits batches of 1,024 through NullifierGuard.commit; it is
    SIGKILLed after NULL_KILL_AFTER acknowledged batches, and the directory
    reopened: (acknowledged batches, digests of them not seen, torn tails)."""
    from coconut_tpu_torch.state import StateStore
    from coconut_tpu_torch.state.nullifier import keyspace_of

    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, root, str(epoch)], stdout=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    acked = []
    try:
        for line in proc.stdout:
            acked.append(int(line))
            if len(acked) >= NULL_KILL_AFTER:
                break
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
        # what the child printed before it died was acknowledged too
        acked += [int(x) for x in proc.stdout.read().split()]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    if proc.returncode != -signal.SIGKILL or len(acked) < NULL_KILL_AFTER:
        raise AssertionError("kill drill: child exit %s after %d batches" % (proc.returncode, len(acked)))
    torn = metrics.get_count("wal_torn_tails")
    store = StateStore(root, replica_id="child")
    torn = metrics.get_count("wal_torn_tails") - torn
    ks = keyspace_of(epoch)
    missing = sum(
        not store.seen(ks, hashlib.sha256(b"kill/%d/%d" % (b, i)).hexdigest())
        for b in acked for i in range(1024)
    )
    kept = len(store.keys(ks))
    store.close()
    return {"acked_batches": len(acked), "missing": missing, "torn_tails": torn,
            "digests_on_disk": kept}


def _expect_lanes(got, want, what):
    """`want` per lane: True, or a nullifier hex the lane must be refused with."""
    from coconut_tpu_torch.errors import DoubleSpendError

    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is True:
            if g is not True:
                bad.append((i, repr(g)))
        elif not (isinstance(g, DoubleSpendError) and g.nullifier == w):
            bad.append((i, repr(g)))
    if bad or len(got) != len(want):
        raise AssertionError("%s: %d lanes wrong, first %s" % (what, len(bad), bad[:3]))


def nullifier_phase(card, session):
    """Double-spend detection on one ProtocolEngine over a StateStore whose
    active-epoch keyspace holds 2^20 spent digests: the device probe
    against its plain version, fresh / replayed / mixed / batched-mode
    batches of 1,024, domains and spend tags, restart and compaction, a
    SIGKILLed committer, and the epoch's retirement."""
    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.errors import DoubleSpendError
    from coconut_tpu_torch.state import StateStore
    from coconut_tpu_torch.state import nullifier as nf

    started = time.perf_counter()
    params, prepared, mgr, users = session
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    metrics.reset()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nullifier-")
    root = os.path.join(tmp, "state")
    ks = mgr.registry.active()
    epoch = ks.epoch
    space = nf.keyspace_of(epoch)
    ctx = params.ctx
    out = {"epoch": epoch, "spent": NULL_SPENT}
    try:
        # 1) prefill: 2^20 seeded digests in the active epoch's keyspace
        rng = np.random.default_rng(0x5EED)
        raw = rng.bytes(32 * NULL_SPENT)
        spent = [raw[i:i + 32].hex() for i in range(0, len(raw), 32)]
        rss_before = _rss_mb()
        store = StateStore(root, replica_id="card0", segment_bytes=NULL_SEGMENT_BYTES)
        t0 = time.perf_counter()
        for i in range(0, NULL_SPENT, NULL_CHUNK):
            store.put_many(space, [(d, 1) for d in spent[i:i + NULL_CHUNK]], epoch=epoch)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_fsyncs"] = metrics.get_count("wal_fsyncs")
        out["store_rss_mb"] = _rss_mb() - rss_before  # _data + _log of 2^20 records

        # 2) the probe on the card against its plain version: 512 spent,
        # then fresh, one bit off a spent digest in the last limb, top bit
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        table, n_real = nf.build_table(store.keys(space))
        out["table_build_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_dev = nf.limbs_on(table, dev)
        torch.cuda.synchronize()
        out["table_upload_s"] = time.perf_counter() - t0
        picks = rng.choice(NULL_SPENT, size=512 + 171, replace=False)
        flipped = [spent[i][:-8] + "%08x" % (int(spent[i][-8:], 16) ^ 1) for i in picks[512:]]
        top = ["".join("%08x" % (0x80000000 | int(v)) for v in rng.integers(0, 1 << 31, 8))
               for _ in range(170)]
        queries = [spent[i] for i in picks[:512]] + [rng.bytes(32).hex() for _ in range(171)]
        queries += flipped + top
        q = nf.digests_to_limbs(queries)
        q_dev = nf.limbs_on(q, dev)
        got = nf.lower_bound_hits(t_dev, n_real, q_dev).cpu().numpy()
        t0 = time.perf_counter()
        plain = nf.membership_probe(table, n_real, q, "cpu")
        out["probe_plain_s"] = time.perf_counter() - t0
        if not (np.array_equal(got, plain) and got[:512].all() and not got[512:].any()):
            raise AssertionError("probe: cuda %d hits, plain %d, expected 512"
                                 % (got.sum(), plain.sum()))
        probe = lambda: nf.lower_bound_hits(t_dev, n_real, q_dev)
        out["probe_device_ms"] = kb.time_cuda(probe, reps=5, inner=5, hold_cycles=50_000_000)
        prof = profile(lambda: (probe(), torch.cuda.synchronize()))
        out["probe_launches"] = prof["device_launches"]
        out["probe_busy_ms"] = prof["device_busy_ms"]
        out["probe_queries"] = len(queries)
        del t_dev, q_dev

        # 3) the guarded engine: mint 1,024 credentials under the active
        # epoch, three rounds of fresh shows of them
        be = TorchBackend()
        _on_card(be, "TorchBackend()")
        common = dict(
            count_hidden=entry.ISSUANCE_HIDDEN, revealed_msg_indices=list(entry.SHOW_REVEALED),
            vk=ks.vk, backend=be, devices=1, max_batch=BATCH, max_wait_ms=SERVE_WAIT_MS,
            max_depth=2 * BATCH, watchdog=Watchdog(min_timeout_s=SESSION_WATCHDOG_FLOOR_S),
        )
        dlq = os.path.join(tmp, "dead.jsonl")
        eng = ProtocolEngine(ks.signers, params, ks.threshold, keychain=mgr.registry,
                             state_store=store, dead_letter_path=dlq, **common)
        bare = ProtocolEngine(ks.signers, params, ks.threshold, keychain=mgr.registry, **common)
        batched = ProtocolEngine(ks.signers, params, ks.threshold, showv_mode="batched",
                                 state_store=store, **common)
        guard = eng.nullifiers
        _on_card(guard, "the guard's probe")
        _on_card(batched.nullifiers, "the batched engine's guard")
        walls = {"probe": [], "commit": [], "table": []}
        _timed_calls(guard, "probe", walls["probe"])
        _timed_calls(guard, "commit", walls["commit"])
        _timed_calls(guard, "_table_for", walls["table"])
        mgr.attach(eng)
        hops = _Hops()
        for e in (eng, bare, batched):
            e.start()
        try:
            creds = hops.run("mint", [
                lambda w, r=r, m=m, sk=sk: eng.submit_mint(r, m, sk, max_wait_ms=w)
                for (r, _), (m, _, sk) in zip(prepared, users)
            ])
            if any(c.epoch != epoch for c in creds):
                raise AssertionError("a credential left the mint without epoch %d" % epoch)
            msgs = [m for m, _, _ in users]
            rounds = [hops.run("show_prove_%d" % k, [
                lambda w, c=c, m=m: eng.submit_show_prove(c, m, max_wait_ms=w)
                for c, m in zip(creds, msgs)
            ]) for k in range(3)]
            shows, shows2, shows3 = rounds

            def show_verify(engine, what, lanes, **kw):
                futs = [engine.submit_show_verify(p[0], p[2], p[1], epoch=epoch,
                                                  max_wait_ms=HOP_WAIT_MS, **kw) for p in lanes]
                hops.futures.extend(futs)
                t0 = time.perf_counter()
                res = _settled(futs)
                hops.walls.setdefault(what, []).append(time.perf_counter() - t0)
                return res

            def nul(p):
                return nf.nullifier_of(p[0], p[1], epoch, params)

            # unguarded walls first (cold, then warm), in the same process
            for what in ("unguarded_cold", "unguarded"):
                _all_true(show_verify(bare, what, shows), what)

            # 3) fresh: all accepted, one group commit
            fs0 = metrics.get_count("wal_fsyncs")
            _all_true(show_verify(eng, "guarded_fresh", shows), "guarded fresh")
            out["fresh_fsyncs"] = metrics.get_count("wal_fsyncs") - fs0
            if metrics.get_count("nullifier_commits") != BATCH or out["fresh_fsyncs"] != 1:
                raise AssertionError("fresh batch: %d commits, %d fsyncs" % (
                    metrics.get_count("nullifier_commits"), out["fresh_fsyncs"]))

            # 4) the replay: every lane typed, probed and dead-lettered
            hits0 = metrics.get_count("nullifier_probe_hits")
            _expect_lanes(show_verify(eng, "guarded_replay", shows), [nul(p) for p in shows],
                          "replay")
            out["replay_probe_hits"] = metrics.get_count("nullifier_probe_hits") - hits0
            lines = [r for r in DeadLetterLog.read(dlq) if r["reason"] == "double_spend"]
            if out["replay_probe_hits"] != BATCH or len(lines) != BATCH or any(
                    r["schema"] != 4 or r["program"] != "show_verify" for r in lines):
                raise AssertionError("replay: %d probe hits, %d dead letters"
                                     % (out["replay_probe_hits"], len(lines)))

            # 5) and 6) mixed batches, exact then batched mode: fresh lanes,
            # replays and intra-batch duplicate pairs (each accepted once)
            perm = random.Random(0x51A7)
            for what, engine, fresh in (("mixed", eng, shows2), ("mixed_batched", batched, shows3)):
                lanes = ([(p, True) for p in fresh[:NULL_FRESH]]
                         + [(p, nul(p)) for p in shows[:NULL_REPLAYS]])
                pairs = fresh[NULL_FRESH:NULL_FRESH + NULL_PAIRS]
                lanes += [(p, "pair") for p in pairs] * 2
                perm.shuffle(lanes)
                checks0 = be.combined_checks
                res = show_verify(engine, what, [p for p, _ in lanes])
                _expect_lanes([r for r, (_, w) in zip(res, lanes) if w != "pair"],
                              [w for _, w in lanes if w != "pair"], what)
                by_pair = collections.defaultdict(list)
                for r, (p, w) in zip(res, lanes):
                    if w == "pair":
                        by_pair[nul(p)].append(r)
                if len(by_pair) != NULL_PAIRS or any(
                        sum(r is True for r in v) != 1
                        or sum(isinstance(r, DoubleSpendError) and r.nullifier == d for r in v) != 1
                        for d, v in by_pair.items()):
                    raise AssertionError("%s: a duplicate pair was not accepted exactly once" % what)
                out[what + "_combined_checks"] = be.combined_checks - checks0
            if out["mixed_batched_combined_checks"] < 1:
                raise AssertionError("the batched-mode batch ran no combined check")

            # 7) domains and spend tags: a re-randomised re-show in "ecash"
            # is refused, the same credential in a second domain accepted
            cred_bytes = creds[0].to_bytes(ctx)
            tag = {d: nf.spend_tag_of(cred_bytes, d) for d in ("ecash", "petition/chip-smoke")}
            res = _settled([
                eng.submit_show_verify(shows2[0][0], shows2[0][2], shows2[0][1], epoch=epoch,
                                       domain="ecash", tag=tag["ecash"]),
                eng.submit_show_verify(shows3[0][0], shows3[0][2], shows3[0][1], epoch=epoch,
                                       domain="petition/chip-smoke",
                                       tag=tag["petition/chip-smoke"]),
            ])
            _all_true(res, "first spends in two domains")
            (res,) = _settled([eng.submit_show_verify(
                shows3[0][0], shows3[0][2], shows3[0][1], epoch=epoch, domain="ecash",
                tag=tag["ecash"])])
            want = nf.nullifier_of(shows3[0][0], shows3[0][1], epoch, params, domain="ecash",
                                   tag=tag["ecash"])
            if not (isinstance(res, DoubleSpendError) and res.nullifier == want
                    and res.domain == "ecash"):
                raise AssertionError("the e-cash re-spend resolved to %r" % (res,))
        finally:
            for e in (eng, bare, batched):
                if not e.drain(timeout=300.0):
                    raise AssertionError("an engine did not drain")
        # the drained guards hold this store object: unhook the guarded
        # engine's retirement before the directory is reopened below
        mgr.registry._retire_hooks.remove(guard.retire_epoch)
        out["guard_walls_s"] = walls
        out["hop_walls_s"] = hops.walls
        counters = metrics.snapshot()["counters"]
        out["counters"] = {k: v for k, v in sorted(counters.items())
                           if k.startswith(("nullifier_", "wal_", "state_", "showv_"))}
        accepted = [nul(p) for p in shows] + [nul(p) for p in shows2[:NULL_FRESH + NULL_PAIRS]]
        accepted += [nul(p) for p in shows3[:NULL_FRESH + NULL_PAIRS]]
        n_records = sum(len(store.records_after(k, "card0", 0, limit=1 << 30))
                        for k in store.keyspaces())
        store.close()

        # 8) restart from the WAL alone, compaction, restart from the snapshot
        def reopen(what):
            t0 = time.perf_counter()
            st = StateStore(root, replica_id="card0", segment_bytes=NULL_SEGMENT_BYTES)
            out[what + "_s"] = time.perf_counter() - t0
            lost = sum(not st.seen(space, d) for d in accepted + spent[::4096])
            replays = nf.NullifierGuard(st).probe([nul(p) for p in shows[:BATCH]],
                                                  epochs=[epoch] * BATCH)
            if lost or not all(replays):
                raise AssertionError("%s: %d acknowledged digests lost, %d replays admitted"
                                     % (what, lost, BATCH - sum(replays)))
            return st

        store = reopen("reopen_wal")
        out["wal_records"] = n_records
        out["wal_bytes"] = store.wal.size_bytes()
        t0 = time.perf_counter()
        store.compact()
        out["compact_s"] = time.perf_counter() - t0
        out["snapshot_bytes"] = os.path.getsize(store.snap_path)
        store.close()
        store = reopen("reopen_snapshot")

        # 9) SIGKILL a committing child process; every acknowledged digest
        # must be on disk when the directory reopens
        out["kill_drill"] = _kill_drill(os.path.join(tmp, "kill"), epoch)
        if out["kill_drill"]["missing"] or out["kill_drill"]["torn_tails"] > 1:
            raise AssertionError("kill drill: %s" % out["kill_drill"])

        # 10) retirement: reshares push the epoch out of the window, and the
        # retire hook of an engine over the reopened store drops its keyspaces
        final = ProtocolEngine(ks.signers, params, ks.threshold, keychain=mgr.registry,
                               state_store=store, **common)
        sizes = {k: len(store.keys(k)) for k in store.keyspaces()
                 if k.startswith("nullifier/") and k.endswith("/%d" % epoch)}
        c0 = metrics.get_count("state_nullifiers_compacted")
        t0 = time.perf_counter()
        reshares = 0
        while epoch in dict(mgr.registry.live_epochs()):
            mgr.reshare()
            reshares += 1
        out["retire_s"] = time.perf_counter() - t0
        out["retire_reshares"] = reshares
        out["retired_keyspaces"] = sizes
        compacted = metrics.get_count("state_nullifiers_compacted") - c0
        if compacted != sum(sizes.values()) or set(sizes) & set(store.keyspaces()):
            raise AssertionError("retirement compacted %d of %s" % (compacted, sizes))
        final.drain(timeout=60.0)
        store.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    counters = metrics.snapshot()["counters"]
    errors = {k: counters.get(k, 0) for k in ("nullifier_probe_errors", "nullifier_commit_errors",
                                               "serve_watchdog_timeouts", "keylife_retire_hook_errors")}
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if any(errors.values()) or launches == 0 or plain:
        raise AssertionError("nullifier phase: %s, %d launches, %d plain calls"
                             % (errors, launches, plain))
    guarded, unguarded = hops.walls["guarded_fresh"][-1], hops.walls["unguarded"][-1]
    log(
        "nullifier", batch=BATCH, guarded_over_unguarded=guarded / unguarded,
        guarded_fresh_s=guarded, unguarded_s=unguarded,
        table_share_of_guarded=walls["table"][0] / guarded if walls["table"] else None,
        errors=errors, launches=launches, plain_calls=plain,
        seconds=time.perf_counter() - started, card=card, **out,
    )
    return launches


GATEWAY_CONCURRENCY = 2048  # closed-loop clients: two full batches in flight
GATEWAY_DIRECT_S = 8.0  # the 2,048 client threads take seconds to start
# the wire run's arrivals. The replica's connection thread decodes under
# the GIL, which slows the start of the 2,048 client threads to ~130 a
# second (on an H100 host, 127 submitted in a 1 s run), so the run is long
# enough for every client to submit; the requests in flight at the deadline
# are awaited, decoded one by one
GATEWAY_RPC_S = 20.0
FLEET_BATCH = 64
# the fleet's coalescing window: a hop's requests reach a replica over ~1 s
# of decoding, and with the 50 ms window of the other phases each hop ran as
# a string of small batches, each a full-width fan-out (on an H100, 195 s
# for a 64-session round)
FLEET_WAIT_MS = 1500.0
# full sessions of the kill round; the rejoin round re-shows the first
# FLEET_REJOIN of its credentials (a mint fan-out is host-bound, ~25 s on
# two replicas whatever its width, so the rejoin round mints nothing)
FLEET_SESSIONS, FLEET_REJOIN = 64, 16
FLEET_KEY, GREEDY_KEY = "key-fleet", "key-greedy"
GREEDY_QUOTA = 2
GATEWAY_TIMEOUT_S = 900.0
# the victim dies this long after the kill round's mints went out, while they
# are on the wire and in its queue (on an H100, a kill at 0.3 s left the
# mint hop at 83.8 s against 45.4-49.7 s at 1 s)
KILL_AFTER_S = 1.0


def _wire_report(rep):
    return {k: rep[k] for k in (
        "duration_s", "submitted", "completed", "errors", "errors_retryable",
        "errors_terminal", "dropped_futures", "valid",
        "invalid", "verdict_mismatches", "goodput_per_s", "batches", "mean_batch_occupancy",
        "rejected", "shed", "latency_s", "rpc_overhead_s")}


def _wire_gates(rep, what):
    if (rep["dropped_futures"] or rep["verdict_mismatches"] or rep["errors"]
            or rep["rejected"] or rep["shed"] or rep["completed"] < 2 * BATCH):
        raise AssertionError("%s: %s" % (what, _wire_report(rep)))


def _resolve(futs):
    """Every future's result, waited for on one thread each: a routed
    future fails over inside result(), so the resubmissions of a killed
    replica's requests go out together instead of one at a time."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(futs)) as pool:
        return list(pool.map(lambda f: f.result(GATEWAY_TIMEOUT_S), futs))


def _fleet_round(router, users, tag, kill=None, creds=None):
    """Every user through prepare -> mint -> show_prove -> show_verify on
    the router, each session bound to its ring primary; `kill` runs while
    the mints are in flight. Given `creds`, the round re-shows them
    (show_prove -> show_verify) and mints nothing. Returns the show bits,
    the sessions' final replicas, the mint futures' (first, last) replicas
    and the seconds from the kill to the last mint settled."""
    bound = [router.bound("%s-%d" % (tag, i)) for i in range(len(users))]
    walls = {}
    mints, moves, settle_s = [], [], None
    if creds is None:
        t0 = time.perf_counter()
        reqs = [r for r, _ in _resolve([
            b.submit_prepare(m, pk) for b, (m, pk, _) in zip(bound, users)])]
        walls["prepare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mints = [b.submit_mint(r, m, sk) for b, r, (m, _, sk) in zip(bound, reqs, users)]
        first = [f.replica_id for f in mints]
        if kill is not None:
            t_kill = kill()
        creds = _resolve(mints)
        walls["mint"] = time.perf_counter() - t0
        if kill is not None:
            settle_s = time.perf_counter() - t_kill
        moves = [(a, f.replica_id) for a, f in zip(first, mints)]
    t0 = time.perf_counter()
    proofs = _resolve([
        b.submit_show_prove(c, m) for b, c, (m, _, _) in zip(bound, creds, users)])
    walls["show_prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shows = [b.submit_show_verify(p, rv, ch) for b, (p, ch, rv) in zip(bound, proofs)]
    bits = _resolve(shows)
    walls["show_verify"] = time.perf_counter() - t0
    _all_true(bits, "fleet round %s" % tag)
    if any(not f.done() for f in mints + shows):
        raise AssertionError("fleet round %s: dangling futures" % tag)
    return {
        "bits": bits, "replicas": [f.replica_id for f in shows], "mint_moves": moves,
        "settle_s": settle_s, "walls": walls, "creds": creds, "shows": proofs,
    }


def _gateway_verify(card, honest):
    """Phase gateway, step 1: the verify service at B = 1024 driven direct
    and through a replica on a loopback socket."""
    from coconut_tpu_torch import net

    params, _, vk, sigs, msgs = honest
    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=BATCH)  # lane 1023 forged
    pool = list(zip(fsigs, fmsgs, expect))
    be = TorchBackend()  # cuda, window 9, raw wire
    _on_card(be, "the verify replica's backend")
    # the hung-dispatch floor: behind the wire the replica's decode thread
    # holds the GIL beside the executor's, and a batch takes several times
    # its direct wall (on an H100 every request of a wire run failed under
    # the default 1 s floor)
    svc = CredentialService(be, vk, params, max_batch=BATCH, max_wait_ms=SERVE_WAIT_MS,
                            max_depth=4 * BATCH,
                            watchdog=Watchdog(min_timeout_s=SESSION_WATCHDOG_FLOOR_S)).start()
    rep = client = None
    try:
        t0 = time.perf_counter()
        got = [f.result(GATEWAY_TIMEOUT_S) for f in [svc.submit(s, m) for s, m, _ in pool]]
        warm_s = time.perf_counter() - t0
        _expect_verdicts(got, expect, "gateway warm batch")
        metrics.reset()
        direct = run_loadgen(svc, pool, duration_s=GATEWAY_DIRECT_S,
                             concurrency=GATEWAY_CONCURRENCY, rng=random.Random(0x6A7E),
                             result_timeout=GATEWAY_TIMEOUT_S)
        log("gateway_direct", **_wire_report(direct), card=card)
        _wire_gates(direct, "direct")
        _healthy(svc, "direct load")
        codec = net.WireCodec(params)
        decode_walls = []
        _timed_calls(codec, "decode_request", decode_walls)
        rep = net.Replica(svc, codec, replica_id="verify")
        client = net.GatewayClient(net.SocketTransport(rep.serve()), net.WireCodec(params))
        metrics.reset()
        wire_rep = run_loadgen(client, pool, duration_s=GATEWAY_RPC_S,
                               concurrency=GATEWAY_CONCURRENCY, rng=random.Random(0x6A7F),
                               result_timeout=GATEWAY_TIMEOUT_S, transport="rpc")
        log("gateway_rpc", **_wire_report(wire_rep), decoded_requests=len(decode_walls),
            decode_ms_per_request=1000.0 * statistics.mean(decode_walls),
            watchdog_timeouts=metrics.get_count("serve_watchdog_timeouts"),
            busy_s=metrics.timers_with_prefix("serve_dev"),
            dispatches=metrics.counters_with_prefix("serve_dev"), card=card)
        _wire_gates(wire_rep, "rpc")
        _healthy(svc, "load over the wire")
        over_wire = [client.submit_verify(fsigs[i], fmsgs[i]).result(GATEWAY_TIMEOUT_S)
                     for i in (0, BATCH - 1)]
        if over_wire != [True, False]:
            raise AssertionError("over the wire: honest, forged read %s" % over_wire)
    finally:
        if client is not None:
            client.close()
        if rep is not None:
            rep.close()
        _drained(svc, "the verify replica's service")
    ratio = wire_rep["goodput_per_s"] / direct["goodput_per_s"]
    out = {
        "batch": BATCH, "concurrency": GATEWAY_CONCURRENCY, "warm_batch_s": warm_s,
        "direct": _wire_report(direct), "rpc": _wire_report(wire_rep),
        "goodput_ratio_rpc_to_direct": ratio, "reference_bar": 0.8,
        "decode_ms_per_request": 1000.0 * statistics.mean(decode_walls),
        "decode_ms_p99": 1000.0 * metrics.percentile(decode_walls, 99),
        "decoded_requests": len(decode_walls), "forged_over_wire": over_wire[1],
    }
    log("gateway_verify", **out, launches_so_far=cuda_fp.LAUNCHES, card=card)
    return out



def _gateway_fleet(card):
    """Phase gateway, steps 2 and 3: a two-replica ProtocolEngine fleet on
    the card behind a router with gossip and tenant tables, one replica
    killed mid-mint and rejoining; then the state plane over the wire and
    a replayed show refused after its witness dies."""
    from coconut_tpu_torch import net
    from coconut_tpu_torch.engine import ProtocolEngine
    from coconut_tpu_torch.errors import (
        DoubleSpendError, ServiceClosedError, TenantQuotaError, TransientBackendError,
    )
    from coconut_tpu_torch.state import StateReplicator, StateStore, nullifier_of

    out = {}
    # 2) two replicas of a ProtocolEngine fleet on the one card
    fparams, signers, esks, epks, fmsgs_all = entry.issue_fixture(FLEET_SESSIONS, user_keys=True)
    users = list(zip(fmsgs_all, epks, esks))
    revealed = list(entry.SHOW_REVEALED)
    root = tempfile.mkdtemp(prefix="chip-smoke-gateway-")
    rids = ("r0", "r1")
    stores, engines, replicas = {}, {}, {}

    def fleet_engine(store, backend="torch"):
        return ProtocolEngine(
            signers, fparams, entry.ISSUANCE_THRESHOLD, count_hidden=entry.ISSUANCE_HIDDEN,
            revealed_msg_indices=revealed, backend=backend, devices=1, max_batch=FLEET_BATCH,
            max_wait_ms=FLEET_WAIT_MS, max_depth=4 * FLEET_BATCH, state_store=store,
            watchdog=Watchdog(min_timeout_s=SESSION_WATCHDOG_FLOOR_S),
        ).start()

    def tenants():
        table = net.TenantTable()
        table.provision("fleet", FLEET_KEY)
        table.provision("greedy", GREEDY_KEY, quota=GREEDY_QUOTA)
        return table

    fcodec = net.WireCodec(fparams)

    def connect(rid, key=FLEET_KEY):
        return net.GatewayClient(net.SocketTransport(replicas[rid].address), fcodec,
                                 api_key=key, session=rid)

    metrics.reset()
    loop = router = None
    pullers = []
    try:
        for rid in rids:
            stores[rid] = StateStore(os.path.join(root, rid), replica_id=rid)
            engines[rid] = fleet_engine(stores[rid])
            _on_card(engines[rid].backend, "replica %s's backend" % rid)
            replicas[rid] = net.Replica(engines[rid], fcodec, tenants=tenants(), replica_id=rid)
            replicas[rid].serve()
        router = net.ReplicaRouter(
            {rid: connect(rid) for rid in rids},
            retry_policy=RetryPolicy(max_attempts=len(rids) + 1, base_delay=0.05,
                                     retryable=(TransientBackendError, ServiceClosedError)),
        )
        # pollers read through router.clients, so a rejoined replica's new
        # client is what the next sweep polls
        loop = net.GossipLoop(router.directory, {
            rid: (lambda r=rid: router.clients[r].poll_beacon(timeout=5.0)) for rid in rids
        }, interval_s=0.1).start()
        _wait_for(lambda: all(router.directory.state(r) == net.UP for r in rids),
                  "both replicas UP", timeout=60.0)

        # one replica killed with its mints in flight, on the cold fleet
        victim = router.candidates("kill-0")[0]
        survivor = [r for r in rids if r != victim][0]
        t_kill = []

        def kill():
            time.sleep(KILL_AFTER_S)  # the mints are on the wire and in the engine
            t_kill.append(time.perf_counter())
            replicas[victim].close()
            return t_kill[0]

        t0 = time.perf_counter()
        killed = _fleet_round(router, users[:FLEET_SESSIONS], "kill", kill=kill)
        kill_round_s = time.perf_counter() - t0
        moved = sum(1 for a, b in killed["mint_moves"] if a == victim and b == survivor)
        stayed = sum(1 for a, b in killed["mint_moves"] if b == victim)
        if not moved or stayed:
            raise AssertionError("kill round: %d mints moved to the survivor, %d settled on "
                                 "the victim" % (moved, stayed))
        _wait_for(lambda: router.directory.state(victim) == net.DOWN, "the victim DOWN",
                  timeout=60.0)
        down_states = router.directory.states()

        # the victim restarts on a new port and rejoins by beacon
        replicas[victim].serve()
        old = router.clients[victim]
        router.clients[victim] = connect(victim)
        old.close()
        t0 = time.perf_counter()
        _wait_for(lambda: router.directory.state(victim) == net.UP, "the victim rejoining",
                  timeout=60.0)
        rejoin_s = time.perf_counter() - t0
        if router.route("kill-0") != victim:
            raise AssertionError("affinity did not return to the rejoined replica")
        t0 = time.perf_counter()
        rejoin = _fleet_round(router, users[:FLEET_REJOIN], "rejoin",
                              creds=killed["creds"][:FLEET_REJOIN])
        rejoin_round_s = time.perf_counter() - t0
        on_victim = [i for i, r in enumerate(rejoin["replicas"]) if r == victim]
        if not on_victim:
            raise AssertionError("no session of the rejoin round landed on the victim")

        # tenant isolation on the rejoined replica: the greedy tenant's
        # third request is refused, the fleet tenant's beside it passes
        i = on_victim[0]
        m = users[i][0]
        cred = rejoin["creds"][i]
        greedy = connect(victim, GREEDY_KEY)
        admitted = _resolve([greedy.submit_verify(cred, m) for _ in range(GREEDY_QUOTA)])
        refused = greedy.submit_verify(cred, m).exception(GATEWAY_TIMEOUT_S)
        fleet_direct = connect(victim)
        beside = fleet_direct.submit_verify(cred, m).result(GATEWAY_TIMEOUT_S)
        greedy.close()
        fleet_direct.close()
        if admitted != [True] * GREEDY_QUOTA or not isinstance(refused, TenantQuotaError) \
                or beside is not True:
            raise AssertionError("tenants: greedy %s then %r, fleet %s"
                                 % (admitted, refused, beside))
        fleet_counters = {k: v for k, v in sorted(metrics.snapshot()["counters"].items())
                          if k.startswith(("gateway_", "issue_", "serve_watchdog"))
                          or k.endswith("_batches")}
        out["fleet"] = {
            "replicas": len(rids), "batch": FLEET_BATCH, "wait_ms": FLEET_WAIT_MS,
            "attrs": entry.MSG_COUNT, "hidden": entry.ISSUANCE_HIDDEN, "revealed": revealed,
            "threshold": "3-of-5", "sessions": FLEET_SESSIONS, "reshows": FLEET_REJOIN,
            "kill_round_s": kill_round_s, "rejoin_round_s": rejoin_round_s,
            "hop_walls_s": {"kill": killed["walls"], "rejoin": rejoin["walls"]},
            "sessions_per_s_kill_round": FLEET_SESSIONS / kill_round_s,
            "reshows_per_s_rejoin_round": FLEET_REJOIN / rejoin_round_s,
            "victim": victim, "mints_moved_to_survivor": moved,
            "failover_settle_s": killed["settle_s"], "states_after_kill": down_states,
            "rejoin_s": rejoin_s, "rejoin_sessions_on_victim": len(on_victim),
            "quota_refusal": str(refused), "counters": fleet_counters,
        }
        log("gateway_fleet", **out["fleet"], launches_so_far=cuda_fp.LAUNCHES, card=card)

        # 3) the state plane over the wire: a show the rejoined replica (the
        # witness) accepted reaches the other by pull_state, the witness
        # dies, the replay is refused
        witness, other = victim, survivor
        proof, chal, rv = rejoin["shows"][i]
        digest = nullifier_of(proof, chal, None, fparams)
        if not stores[witness].seen("nullifier/0", digest):
            raise AssertionError("the witness did not journal the show it accepted")
        t0 = time.perf_counter()
        for rid in rids:
            peers = {p: router.clients[p] for p in rids if p != rid}
            pullers.append(StateReplicator(stores[rid], router.directory, peers,
                                           interval_s=0.1).start())
        _wait_for(lambda: stores[other].seen("nullifier/0", digest),
                  "the nullifier replicated", timeout=60.0)
        replicate_s = time.perf_counter() - t0
        for p in pullers:
            p.stop()
        pullers = []
        replicas[witness].close()  # no drain: the witness is gone
        o = connect(other)
        err = o.submit_show_verify(proof, rv, chal).exception(GATEWAY_TIMEOUT_S)
        o.close()
        if not isinstance(err, DoubleSpendError) or err.nullifier != digest:
            raise AssertionError("the survivor answered the replay with %r" % (err,))
        # the survivor reopened from its WAL refuses it too
        replicas[other].close()
        be_other = engines[other].backend
        _drained(engines[other], "the survivor")
        stores[other].close()
        t0 = time.perf_counter()
        stores[other] = StateStore(os.path.join(root, other), replica_id=other)
        reopen_s = time.perf_counter() - t0
        engines[other] = fleet_engine(stores[other], backend=be_other)
        replicas[other] = net.Replica(engines[other], fcodec, tenants=tenants(), replica_id=other)
        replicas[other].serve()
        o = connect(other)
        err2 = o.submit_show_verify(proof, rv, chal).exception(GATEWAY_TIMEOUT_S)
        o.close()
        if not isinstance(err2, DoubleSpendError) or err2.nullifier != digest:
            raise AssertionError("the reopened survivor answered the replay with %r" % (err2,))
        out["state"] = {
            "witness": witness, "replicated_s": replicate_s, "nullifier": digest,
            "replay_refused": type(err).__name__, "reopened_refused": type(err2).__name__,
            "reopen_s": reopen_s, "records_after_reopen": len(stores[other].keys("nullifier/0")),
            "state_pulls": metrics.get_count("gateway_state_pulls"),
            "antientropy_pulls": metrics.get_count("state_antientropy_pulls"),
            "records_applied": metrics.get_count("state_records_applied"),
            "double_spends": metrics.get_count("nullifier_double_spends"),
        }
    finally:
        for p in pullers:
            p.stop()
        if loop is not None:
            loop.stop(timeout=5.0)
        if router is not None:
            router.close()
        for r in replicas.values():
            r.close()
        for rid, eng in engines.items():
            _drained(eng, "replica %s" % rid)
        for st in stores.values():
            st.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def gateway_phase(card, honest):
    """The fleet gateway on the card: the verify service behind a replica
    on a loopback socket at B = 1024 beside the same service direct; a
    two-replica ProtocolEngine fleet behind a router with gossip and
    tenant tables, one replica killed mid-run and rejoining; the state
    plane over the wire and a replayed show refused after the witness
    dies."""
    started = time.perf_counter()
    cuda_fp.LAUNCHES = 0
    cuda_fp.PLAIN_CALLS = 0
    verify = _gateway_verify(card, honest)
    out = _gateway_fleet(card)
    counters = metrics.snapshot()["counters"]
    timeouts = counters.get("serve_watchdog_timeouts", 0) + counters.get(
        "issue_watchdog_timeouts", 0)
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    if launches == 0 or plain or timeouts:
        raise AssertionError("gateway phase: %d launches, %d plain calls, %d watchdog timeouts"
                             % (launches, plain, timeouts))
    log("gateway", state=out["state"],
        goodput_ratio_rpc_to_direct=verify["goodput_ratio_rpc_to_direct"],
        decode_ms_per_request=verify["decode_ms_per_request"],
        failover_settle_s=out["fleet"]["failover_settle_s"], launches=launches,
        plain_calls=plain, seconds=time.perf_counter() - started, card=card)
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

    phase_s = {"start": time.perf_counter() - started}
    last = [time.perf_counter()]

    def timed(name, result):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        return result

    kern = timed("kernel", kernel_phase(dev))
    by_path = {}
    by_path["verify"], vbe, vhonest, vrate = timed("main_path", main_path_phase(card))
    by_path["show"], sbe, shonest, srate = timed("show_path", show_path_phase(card))
    by_path["verify_combined"], crate = timed(
        "verify_combined", verify_combined_phase(card, vbe, vhonest, vrate))
    by_path["show_combined"], scrate = timed(
        "show_combined", show_combined_phase(card, sbe, shonest, srate))
    by_path["grouped"], grate = timed("grouped", grouped_phase(card, vbe, vhonest, vrate))
    by_path["g2_verify"], g2_creds = timed("g2_verify", g2_verify_phase(
        card, {"exact": vrate, "combined": crate, "grouped": grate}
    ))
    by_path["prove"], prate = timed("prove", prove_phase(card, vhonest, srate))
    by_path["show_g2"] = timed(
        "show_g2", show_g2_phase(card, g2_creds, {"exact": srate, "combined": scrate}))
    timed("ragged", ragged_phase(card, vhonest))
    by_path["issue"], irates = timed("issue", issue_phase(card))
    by_path["issue_g2"] = timed("issue_g2", issue_g2_phase(card))
    by_path["bucketed"] = timed("bucketed", bucketed_phase(card))
    by_path["serve"] = timed("serve", serve_phase(card, vhonest, vrate))
    by_path["issue_service"] = timed(
        "issue_service", issue_service_phase(card, irates["issued_credentials_per_s"]))
    by_path["keylife_session"], issued, session = timed(
        "keylife_session", keylife_session_phase(card, dict(
            irates, verify_per_s=vrate, proofs_per_s=prate, show_verify_per_s=srate)))
    by_path["ct_probe"] = timed("ct_probe", ct_probe_phase(card, issued))
    by_path["nullifier"] = timed("nullifier", nullifier_phase(card, session))
    by_path["gateway"] = timed("gateway", gateway_phase(card, vhonest))
    log("done", seconds=time.perf_counter() - started, phase_seconds=phase_s, card=card)
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
