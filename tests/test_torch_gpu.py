"""Card-only tests of the port: the CUDA Montgomery kernel against its plain
PyTorch version on the GPU, the wrapper's checks, and the verify,
show-verify, combined and grouped paths, the show prover, the show
family under G2, the device hash-to-G1, the bucketed distinct MSM, a
threshold issuance round, the online verify service, the issuance
service (a mint at B = 16, a crashed authority) and the ProtocolEngine
(8 full sessions over DKG keys, a refresh between two mints) on `cuda`
against the same paths on the CPU or the host spec, the kernel's counts
under threads, the nullifier set's membership probe on `cuda` against
its plain version on CPU tensors over a 2^16-row table, and a short
population of petition / e-cash / access workflows on a ProtocolEngine on
`cuda` with an ElasticController in the loop.

Marked `gpu`; each test skips where no CUDA card is present. On a machine
with one: `python -m pytest tests/test_torch_gpu.py -q`. Tolerance: exact
(0) — every limb is an exact integer.
"""

import numpy as np
import pytest
import torch

from coconut_tpu_torch import elgamal, entry, keygen, pok_sig, ps
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.gpu import cuda_fp, fp
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.gpu.limbs import NLIMBS
from coconut_tpu_torch.ops import hashing
from coconut_tpu_torch.ops.curve import G1_GEN, g1
from coconut_tpu_torch.ops.fields import R
from coconut_tpu_torch.params import Params
from torch_show_helpers import fields_of, seeded_randbelow

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lazy(rng, n):
    x = rng.integers(-128, 129, size=(n, NLIMBS)).astype(np.float64)
    x[:, 47:] = 0.0
    w = rng.integers(1, 993, size=(n, 1)) * rng.choice([-1, 1], size=(n, 1))
    return (x * w).astype(np.float32)


# ragged widths for every lane-group size G in 4..32 (G - 1, G + 1), around
# a block of 128 threads, and the main path's fp2_mul / fp6_mul widths
@pytest.mark.parametrize(
    "n", [1, 3, 5, 7, 9, 15, 17, 31, 33, 127, 128, 129, 3072, 3073, 18432]
)
def test_kernel_equals_plain_version(cuda, n):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(_lazy(rng, n)).to(cuda)
    b = torch.from_numpy(_lazy(rng, n)).to(cuda)
    got = cuda_fp.mul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_fp.mul_plain(a, b))
    assert torch.equal(got.cpu(), cuda_fp.mul_plain(a.cpu(), b.cpu()))


def _adversarial():
    half = NLIMBS // 2
    rows = [
        np.full(NLIMBS, 132.0),
        np.full(NLIMBS, -132.0),
        np.tile([132.0, -132.0], half),
        np.concatenate([np.full(half, 132.0), np.full(half, -132.0)]),
    ]
    big = np.full(NLIMBS, float(1 << 17))
    big[-2:] = 0.0
    rows += [big, -big, big * np.tile([1.0, -1.0], half)]
    return np.array(rows, dtype=np.float32)


def test_kernel_equals_plain_version_adversarial(cuda):
    """Limbs at +-132 (alternating, half and half) and at +-2^17 with limbs
    50-51 vacant, every pair of them."""
    adv = _adversarial()
    a = torch.from_numpy(np.repeat(adv, len(adv), axis=0)).to(cuda)
    b = torch.from_numpy(np.tile(adv, (len(adv), 1))).to(cuda)
    got = cuda_fp.mul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_fp.mul_plain(a, b))
    assert torch.equal(got.cpu(), cuda_fp.mul_plain(a.cpu(), b.cpu()))


def test_fp_mul_on_cuda_launches_the_kernel(cuda):
    a = torch.from_numpy(_lazy(np.random.default_rng(3), 6).reshape(2, 3, NLIMBS)).to(cuda)
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    width6 = cuda_fp.LAUNCH_WIDTHS[6]
    out = fp.mul(a, a[0, 0])  # broadcasting, as mul_stack and constants use it
    assert cuda_fp.LAUNCHES == launches + 1 and cuda_fp.PLAIN_CALLS == plain
    assert cuda_fp.LAUNCH_WIDTHS[6] == width6 + 1
    assert out.shape == a.shape
    assert torch.equal(out.cpu(), cuda_fp.mul_plain(a.cpu(), a[0, 0].cpu()))


def test_launch_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, NLIMBS, device=cuda)
    out = torch.empty_like(a)
    with pytest.raises(ValueError, match="float32"):
        cuda_fp.launch(a.double(), a.double(), out)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fp.launch(a.t().contiguous().t(), a, out)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(5 * NLIMBS + 1, device=cuda)
        cuda_fp.launch(flat[1:].view(5, NLIMBS)[:4], a, out)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fp.launch(a.cpu(), a, out)
    with pytest.raises(ValueError, match="lies on cpu"):
        cuda_fp.launch(a, a.cpu(), out)


def test_batch_verify_on_cuda_matches_cpu_and_expected(cuda):
    params, _, vk, sigs, msgs = entry.fixture(8)
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=2)
    for window in (9, 4):
        be = TorchBackend(comb_window=window)
        plain = cuda_fp.PLAIN_CALLS
        assert be.batch_verify(sigs, msgs, vk, params) == expect
        assert cuda_fp.PLAIN_CALLS == plain
    assert TorchBackend(device="cpu", comb_window=4).batch_verify(sigs, msgs, vk, params) == expect


def test_batch_show_verify_on_cuda_matches_cpu_and_expected(cuda):
    """B = 64 shows, one in 8 forged (each of the four kinds twice), at the
    card's window 9 and raw wire against the CPU's window 6 and int16
    wire."""
    params, _, vk, proofs, rmsgs, challenges = entry.show_fixture(64)
    proofs, rmsgs, expect = entry.forge_shows(params, proofs, rmsgs, every=8)
    plain = cuda_fp.PLAIN_CALLS
    got = TorchBackend().batch_show_verify(proofs, vk, params, rmsgs, challenges)
    assert cuda_fp.PLAIN_CALLS == plain
    assert got == expect
    cpu = TorchBackend(device="cpu").batch_show_verify(proofs, vk, params, rmsgs, challenges)
    assert cpu == got


def test_combined_checks_on_cuda_match_cpu(cuda):
    """B = 64: the combined verify of an honest batch and of one with lanes
    31 and 63 forged, and the combined show verify of a batch with one show
    in 16 forged (each kind of forgery once), on the card at window 9 and
    raw wire give the CPU's results at window 6 and int16 wire."""
    params, _, vk, sigs, msgs = entry.fixture(64)
    fsigs, fmsgs, _ = entry.forge(params, sigs, msgs, every=32)
    _, _, _, proofs, rmsgs, challenges = entry.show_fixture(64)
    proofs, rmsgs, _ = entry.forge_shows(params, proofs, rmsgs, every=16)
    be, plain = TorchBackend(), cuda_fp.PLAIN_CALLS
    assert be.batch_verify_combined(sigs, msgs, vk, params) is True
    got = (
        be.batch_verify_combined(fsigs, fmsgs, vk, params),
        be.batch_show_verify_combined(proofs, vk, params, rmsgs, challenges),
    )
    assert cuda_fp.PLAIN_CALLS == plain
    assert (be.combined_checks, be.final_exps) == (3, 3)
    bits, pair_ok = got[1]
    # 15 and 47 fail the pairing check only; 31 (corrupted response) and
    # 63 (identity sigma'_1, a dead lane) fail their own bits
    assert got[0] is False and pair_ok is False
    assert [i for i, b in enumerate(bits) if not b] == [31, 63]
    cpu = TorchBackend(device="cpu")
    assert got == (
        cpu.batch_verify_combined(fsigs, fmsgs, vk, params),
        cpu.batch_show_verify_combined(proofs, vk, params, rmsgs, challenges),
    )


def _double_sigma_2(params, sigs, lane):
    sigs = list(sigs)
    s = sigs[lane]
    sigs[lane] = type(s)(s.sigma_1, params.ctx.sig.mul(s.sigma_2, 2))
    return sigs


def test_grouped_verify_on_cuda_matches_cpu(cuda):
    """B = 64 under G1: the grouped check is True on the honest batch and
    False with lane 31's sigma_2 doubled, on the card (the kernel launched,
    the plain version never, one final exponentiation a check), as on the
    CPU."""
    params, _, vk, sigs, msgs = entry.fixture(64)
    forged = _double_sigma_2(params, sigs, 31)
    be = TorchBackend()
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    got = (
        be.batch_verify_grouped(sigs, msgs, vk, params),
        be.batch_verify_grouped(forged, msgs, vk, params),
    )
    assert got == (True, False)
    assert cuda_fp.LAUNCHES > launches and cuda_fp.PLAIN_CALLS == plain
    assert (be.grouped_checks, be.final_exps) == (2, 2)
    cpu = TorchBackend(device="cpu")
    assert got == (
        cpu.batch_verify_grouped(sigs, msgs, vk, params),
        cpu.batch_verify_grouped(forged, msgs, vk, params),
    )


def test_g2_verify_family_on_cuda(cuda):
    """B = 64 under the G2 assignment, on the card at window 9 and raw
    wire: exact verify with one lane in 8 forged gives the expected bits
    (the CPU's too); the combined and grouped checks are True on the honest
    batch and False with lane 31's sigma_2 doubled. The kernel launched, the
    plain version never."""
    params, _, vk, sigs, msgs = entry.fixture(64, ctx="G2")
    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=8)
    forged = _double_sigma_2(params, sigs, 31)
    be = TorchBackend()
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    assert be.batch_verify(fsigs, fmsgs, vk, params) == expect
    for check in (be.batch_verify_combined, be.batch_verify_grouped):
        assert check(sigs, msgs, vk, params) is True
        assert check(forged, msgs, vk, params) is False
    assert cuda_fp.LAUNCHES > launches and cuda_fp.PLAIN_CALLS == plain
    assert (be.combined_checks, be.grouped_checks) == (2, 2)
    assert TorchBackend(device="cpu").batch_verify(fsigs, fmsgs, vk, params) == expect


def test_batch_show_on_cuda_matches_cpu(cuda, monkeypatch):
    """B = 64 under G1: the batched prover on the card (window 9, raw wire;
    the kernel launched, the plain version never) and on the CPU (window 6,
    int16 wire) with one seeded rand_fr sequence give the same proofs,
    challenges and revealed maps, proof for proof; the card verifies them
    with the challenges recomputed."""
    params, _, vk, sigs, msgs = entry.fixture(64)
    runs = []
    for dev in ("cuda", "cpu"):
        seeded_randbelow(monkeypatch, 64)
        be = TorchBackend(device=dev)
        launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
        proofs, chals, rms = pok_sig.batch_show(sigs, vk, params, msgs, entry.SHOW_REVEALED, be)
        if dev == "cuda":
            assert cuda_fp.LAUNCHES > launches and cuda_fp.PLAIN_CALLS == plain
            card = be
        runs.append(([fields_of(p) for p in proofs], chals, rms))
    assert runs[0] == runs[1]
    assert ps.batch_show_verify(proofs, vk, params, rms, backend=card) == [True] * 64


def test_g2_show_verify_on_cuda_matches_cpu(cuda):
    """B = 64 under G2, proved on the card, one show in 8 forged four ways:
    exact show verify (challenges recomputed) gives the expected bits on
    the card and on the CPU, and the combined check on the honest batch is
    one True."""
    params, _, vk, sigs, msgs = entry.fixture(64, ctx="G2")
    be = TorchBackend()
    proofs, _, rms = pok_sig.batch_show(sigs, vk, params, msgs, entry.SHOW_REVEALED, be)
    fproofs, frms, expect = entry.forge_shows(params, proofs, rms, every=8)
    plain = cuda_fp.PLAIN_CALLS
    got = ps.batch_show_verify(fproofs, vk, params, frms, backend=be)
    assert ps.batch_show_verify(proofs, vk, params, rms, backend=be, mode="batched") == [True] * 64
    assert cuda_fp.PLAIN_CALLS == plain
    assert got == expect
    cpu = TorchBackend(device="cpu")
    assert ps.batch_show_verify(fproofs, vk, params, frms, backend=cpu) == got


def test_hash_and_bucketed_msm_on_cuda(cuda):
    """hash_to_g1_batch of 8 messages on the card (the empty one included)
    equals the host spec; a G1 distinct MSM forced through the bucketed
    schedule at window 5 ([4, 3] rows, an identity base and a zero scalar)
    equals the spec. The kernel launched, the plain version never."""
    be = TorchBackend()
    launches, plain = cuda_fp.LAUNCHES, cuda_fp.PLAIN_CALLS
    msgs = [b""] + [b"card-%d" % i for i in range(7)]
    assert be.hash_to_g1_batch(msgs) == [hashing.hash_to_g1(m) for m in msgs]
    rng = np.random.default_rng(5)
    scal = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(3)] for _ in range(4)]
    scal[1][2] = 0
    pts = [[g1.mul(G1_GEN, s + 1) for s in row] for row in scal]
    pts[2][0] = None
    be.bucket_mode = 5
    assert be.msm_g1_distinct(pts, scal) == [g1.msm(p, s) for p, s in zip(pts, scal)]
    assert (be.msm_bucketed_dispatches, be.msm_bucket_window) == (1, 5)
    assert cuda_fp.LAUNCHES > launches and cuda_fp.PLAIN_CALLS == plain


def test_issuance_round_on_cuda_matches_the_spec(cuda, monkeypatch):
    """B = 8 under G1, 2 hidden of 6, 3-of-5: prepare on the card (device
    hash, c2 by the offset program) gives the host spec's requests byte for
    byte from one seeded draw; signer 1's blind signatures, the unblinded
    and the aggregated credentials ({1, 2, 3}: the others' partials from
    the spec) equal the spec's, and every credential verifies on the card
    under the aggregated verkey."""
    seeded_randbelow(monkeypatch, 8)
    params = Params.new(6, b"backend-test")
    _, _, signers = keygen.trusted_party_SSS_keygen(3, 5, params)
    esk, epk = elgamal.elgamal_keygen(params.ctx.sig, params.g)
    msgs = [[(7 * i + j) * 0x1234567 % R for j in range(6)] for i in range(8)]
    be = TorchBackend()
    out = []
    for backend in (be, ps.SPEC):
        seeded_randbelow(monkeypatch, 88)
        out.append(sig.batch_prepare_blind_sign(msgs, 2, epk, params, backend=backend))
    ctx = params.ctx
    assert [(r.to_bytes(ctx), k) for r, k in out[0]] == [(r.to_bytes(ctx), k) for r, k in out[1]]
    assert (be.device_hash_batches, be.msm_offset_dispatches) == (1, 1)
    reqs = [r for r, _ in out[0]]
    partials = []
    for s in signers[:3]:
        spec = sig.batch_blind_sign(reqs, s.sigkey, params, ps.SPEC)
        if s.id == 1:
            card = sig.batch_blind_sign(reqs, s.sigkey, params, be)
            assert [b.to_bytes(ctx) for b in card] == [b.to_bytes(ctx) for b in spec]
        partials.append(spec)
    flat = [b for part in partials for b in part]
    unblinded = sig.batch_unblind(flat, esk, ctx, be)
    spec_unblinded = sig.batch_unblind(flat, esk, ctx, ps.SPEC)
    assert unblinded == spec_unblinded
    rows = [[(n + 1, unblinded[n * 8 + i]) for n in range(3)] for i in range(8)]
    creds = sig.batch_aggregate(3, rows, ctx, be)
    assert creds == sig.batch_aggregate(3, rows, ctx, ps.SPEC)
    vk = sig.Verkey.aggregate(3, [(s.id, s.verkey) for s in signers[:3]], ctx)
    assert be.batch_verify(creds, msgs, vk, params) == [True] * 8


def test_kernel_counts_are_exact_under_threads(cuda):
    """4 threads x 50 launches each add exactly 200 to LAUNCHES (and 200
    to the width's count), and every product equals the plain version's."""
    import threading

    rng = np.random.default_rng(4)
    a = torch.from_numpy(_lazy(rng, 33)).to(cuda)
    b = torch.from_numpy(_lazy(rng, 33)).to(cuda)
    want = cuda_fp.mul_plain(a, b)
    launches, width = cuda_fp.LAUNCHES, cuda_fp.LAUNCH_WIDTHS[33]
    wrong = []
    start = threading.Barrier(4)

    def work():
        start.wait()
        for _ in range(50):
            out = cuda_fp.mul(a, b)
            if not torch.equal(out, want):
                wrong.append(1)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not wrong
    assert cuda_fp.LAUNCHES == launches + 200
    assert cuda_fp.LAUNCH_WIDTHS[33] == width + 200


def test_credential_service_on_cuda_matches_batch_verify(cuda):
    """The port's CredentialService on the card at max_batch=64: 100
    requests (one in 8 forged) in two batches, the second padded, give the
    bits of TorchBackend.batch_verify, with no plain call."""
    from coconut_tpu_torch.serve import CredentialService

    params, _, vk, sigs, msgs = entry.fixture(100)
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=8)
    be = TorchBackend()
    assert be.batch_verify(sigs, msgs, vk, params) == expect
    plain = cuda_fp.PLAIN_CALLS
    with CredentialService(be, vk, params, max_batch=64, max_wait_ms=20.0) as svc:
        futs = [svc.submit(s, m) for s, m in zip(sigs, msgs)]
        got = [f.result(300.0) for f in futs]
    assert got == expect
    assert cuda_fp.PLAIN_CALLS == plain


def _issue_orders(n):
    """entry.issue_fixture(n) with a key pair a user, and its n requests
    prepared on the host spec: (fixture, [(request, messages, secret)])."""
    fix = entry.issue_fixture(n, user_keys=True)
    params, _, esks, epks, msgs = fix
    with entry.seeded_draws(0x155):
        prepared = sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epks, params, ps.SPEC)
    return fix, [(req, m, sk) for (req, _), m, sk in zip(prepared, msgs, esks)]


def test_issuance_service_on_cuda_matches_the_spec(cuda):
    """IssuanceService(backend=None) mints B = 16 orders (per-user ElGamal
    keys) on the card in one fan-out: every credential equals the spec's
    Signature.aggregate of BlindSignature.new partials under the subset
    {2, 4, 5}, verifies on the card, and no plain call runs."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.issue import IssuanceService

    (params, signers, _, _, msgs), orders = _issue_orders(16)
    metrics.reset()
    plain = cuda_fp.PLAIN_CALLS
    svc = IssuanceService(signers, params, entry.ISSUANCE_THRESHOLD, max_batch=16, max_wait_ms=50.0)
    assert svc.minter.backend.device.type == "cuda"
    futs = [svc.submit(req, m, sk) for req, m, sk in orders]
    with svc:
        creds = [f.result(600.0) for f in futs]
    assert cuda_fp.PLAIN_CALLS == plain
    assert metrics.get_count("issue_minted") == 16
    ctx = params.ctx
    for (req, m, sk), cred in zip(orders, creds):
        parts = [(j, sig.BlindSignature.new(req, signers[j - 1].sigkey, params).unblind(sk, ctx))
                 for j in (2, 4, 5)]
        assert cred == sig.Signature.aggregate(entry.ISSUANCE_THRESHOLD, parts, ctx)
    vk = sig.Verkey.aggregate(3, [(j, signers[j - 1].verkey) for j in (2, 4, 5)], ctx)
    assert svc.minter.backend.batch_verify(creds, msgs, vk, params) == [True] * 16


def test_issuance_service_on_cuda_contains_a_crashed_authority(cuda):
    """B = 16, authority 2 crashing on its first sign: every order mints on
    the card and verifies, the crash is counted once and authority 2 is
    QUARANTINED."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.faults import FaultyBackend
    from coconut_tpu_torch.issue import IssuanceService
    from coconut_tpu_torch.serve.health import HealthPolicy

    (params, signers, _, _, msgs), orders = _issue_orders(16)
    be = TorchBackend()
    backends = [be, FaultyBackend(be, crash_sign_on=(0,)), be, be, be]
    metrics.reset()
    svc = IssuanceService(signers, params, 3, backend=be, backends=backends, max_batch=16,
                          max_wait_ms=50.0, health_policy=HealthPolicy(probe_after_s=600.0))
    futs = [svc.submit(req, m, sk) for req, m, sk in orders]
    with svc:
        creds = [f.result(600.0) for f in futs]
    vk = sig.Verkey.aggregate(3, [(j, signers[j - 1].verkey) for j in (1, 3, 4)], params.ctx)
    assert be.batch_verify(creds, msgs, vk, params) == [True] * 16
    assert backends[1].crashes == 1 and metrics.get_count("issue_authority_crashes") == 1
    assert svc._health_of("2").state == "quarantined"
    assert metrics.get_count("issue_minted") == 16


def test_protocol_engine_session_round_across_a_refresh_on_cuda(cuda):
    """ProtocolEngine(backend="torch") over keys from a seeded DKG: 8 full
    sessions on the card (each hop one batch), a proactive refresh, then 8
    more mints: every verify and show verdict True, every credential of
    epoch 1, the verkey unchanged, the refreshed credentials equal to the
    host spec's verify, the kernel launched and no plain call."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.engine import ProtocolEngine

    params, mgr, ks = entry.keylife_fixture()
    _, _, esks, epks, msgs = entry.issue_fixture(8, user_keys=True)
    metrics.reset()
    plain, launches = cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES
    eng = ProtocolEngine(ks.signers, params, 3, count_hidden=entry.ISSUANCE_HIDDEN,
                         revealed_msg_indices=list(entry.SHOW_REVEALED), vk=ks.vk, backend="torch",
                         max_batch=8, max_wait_ms=60000.0, keychain=mgr.registry)
    assert eng.backend.device.type == "cuda"
    mgr.attach(eng)
    with eng:
        prepared = [f.result(600.0) for f in [eng.submit_prepare(m, pk) for m, pk in zip(msgs, epks)]]
        creds = [f.result(600.0) for f in [
            eng.submit_mint(r, m, sk) for (r, _), m, sk in zip(prepared, msgs, esks)]]
        assert [c.epoch for c in creds] == [1] * 8
        assert [f.result(600.0) for f in [eng.submit_verify(c, m) for c, m in zip(creds, msgs)]] == [True] * 8
        proofs = [f.result(600.0) for f in [eng.submit_show_prove(c, m) for c, m in zip(creds, msgs)]]
        assert [f.result(600.0) for f in [
            eng.submit_show_verify(p, rv, ch, epoch=1) for p, ch, rv in proofs]] == [True] * 8
        ks_r = mgr.refresh()
        assert ks_r.vk.to_bytes(params.ctx) == ks.vk.to_bytes(params.ctx)
        again = [f.result(600.0) for f in [
            eng.submit_mint(r, m, sk) for (r, _), m, sk in zip(prepared, msgs, esks)]]
        assert [f.result(600.0) for f in [eng.submit_verify(c, m) for c, m in zip(again, msgs)]] == [True] * 8
    assert all(ps.ps_verify(c, m, ks.vk, params) for c, m in zip(again, msgs))
    assert cuda_fp.PLAIN_CALLS == plain and cuda_fp.LAUNCHES > launches
    assert metrics.get_count("keylife_refreshes") == 1
    assert mgr.registry.pin_count(1) == 0


def test_population_on_cuda_through_the_elastic_controller(cuda, tmp_path):
    """A 3 s diurnal population (petitions, e-cash with double spends,
    access sessions) on a ProtocolEngine with two executors, a StateStore
    and an ElasticController on `cuda`: every started workflow reaches one
    terminal, none failed or cancelled, rejections only double_spend; the
    kernel launched and no plain call."""
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.engine import ElasticController, ElasticPolicy, ProtocolEngine
    from coconut_tpu_torch.scenarios import (
        TERMINAL_OUTCOMES, AccessScenario, DiurnalCurve, EcashScenario, PetitionScenario,
        Population, PopulationDriver, RateSchedule, ScenarioReport,
    )
    from coconut_tpu_torch.state import StateStore

    params, signers, _, _, _ = entry.issue_fixture(1)
    store = StateStore(str(tmp_path / "state"), replica_id="gpu-scn")
    eng = ProtocolEngine(signers, params, entry.ISSUANCE_THRESHOLD,
                         count_hidden=entry.ISSUANCE_HIDDEN,
                         revealed_msg_indices=list(entry.SHOW_REVEALED), backend="torch",
                         devices=2, max_batch=64, max_wait_ms=50.0, pad_partial=False,
                         state_store=store)
    assert eng.backend.device.type == "cuda" and eng.nullifiers.device.type == "cuda"
    metrics.reset()
    plain, launches = cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES
    try:
        eng.start()
        mix = [(2.0, PetitionScenario(eng, params, campaigns=2, resign_p=0.5, deadline_s=60.0)),
               (2.0, EcashScenario(eng, params, double_spend_p=0.5, deadline_s=60.0)),
               (1.0, AccessScenario(eng, params, session_range=(2, 2), deadline_s=60.0))]
        out = PopulationDriver(
            Population(1024, seed=0x19), mix, RateSchedule(DiurnalCurve(1.0, 2.0, 3.0)), 3.0,
            seed=0x19, report=ScenarioReport(slo_s=10.0), engine=eng,
            elastic=ElasticController(eng, ElasticPolicy(min_executors=1)),
            drain_timeout_s=60.0,
        ).run()
    finally:
        assert eng.drain(timeout=120.0)
        store.close()
    totals = out["totals"]
    assert totals["failed"] == 0 and totals["cancelled"] == 0
    assert {label for per in out["rejections"].values() for label in per} <= {"double_spend"}
    counters = metrics.snapshot()["counters"]
    assert counters["scenario_started"] == sum(
        counters.get("scenario_%s" % o, 0) for o in TERMINAL_OUTCOMES) > 0
    assert cuda_fp.PLAIN_CALLS == plain and cuda_fp.LAUNCHES > launches


def test_membership_probe_on_cuda_equals_plain_version(cuda, tmp_path):
    """2^16 spent digests; 1,024 queries: 512 spent, 256 one bit off a spent
    digest in the last limb, 128 fresh, 128 with every limb's top bit set.
    The cuda mask equals the CPU plain version's and the expected one; the
    guard on cuda gives the same flags through a StateStore."""
    from coconut_tpu_torch.state import NullifierGuard, StateStore
    from coconut_tpu_torch.state import nullifier as nf

    rng = np.random.default_rng(0x2016)
    spent = [rng.bytes(32).hex() for _ in range(1 << 16)]
    flipped = [d[:-8] + "%08x" % (int(d[-8:], 16) ^ 1) for d in spent[512:768]]
    top = ["".join("%08x" % (0x80000000 | int(v)) for v in rng.integers(0, 1 << 31, 8))
           for _ in range(128)]
    queries = spent[:512] + flipped + [rng.bytes(32).hex() for _ in range(128)] + top
    table, n = nf.build_table(spent)
    q = nf.digests_to_limbs(queries)
    got = nf.membership_probe(table, n, q, cuda)
    torch.cuda.synchronize()
    assert np.array_equal(got, nf.membership_probe(table, n, q, "cpu"))
    assert got[:512].all() and not got[512:].any()
    store = StateStore(str(tmp_path / "s"))
    guard = NullifierGuard(store, device=cuda)
    assert guard.commit(spent[:4096], epochs=[1] * 4096) == [True] * 4096
    assert guard.probe(queries[:8] + spent[4096:4104], epochs=[1] * 16) == [True] * 8 + [False] * 8
    store.close()


def test_sharded_verify_on_logical_shards_of_one_card(cuda):
    """Per-credential verify on [cuda:0] * 4 as a (2, 2) mesh at B = 8 (one
    lane in 2 forged): the bits of the unsharded TorchBackend, with the
    kernel launched and never the plain version; then the port's
    dryrun_multichip on the same four logical shards."""
    from coconut_tpu_torch.gpu import shard

    params, _, vk, sigs, msgs = entry.fixture(8)
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=2)
    be = TorchBackend()
    mesh = shard.default_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)
    plain, launches = cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES
    assert shard.batch_verify_sharded(be, sigs, msgs, vk, params, mesh) == expect
    assert cuda_fp.PLAIN_CALLS == plain and cuda_fp.LAUNCHES > launches
    assert be.batch_verify(sigs, msgs, vk, params) == expect
    entry.dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)
