"""The port's threshold issuance (BASELINE config 4) against the JAX package
on the CPU: `batch_prepare_blind_sign`, `batch_blind_sign`, `batch_unblind`
and `batch_aggregate` of `coconut_tpu_torch.signature` on a `cpu`
TorchBackend and on the host spec (`ps.SPEC`), each byte-equal to
`coconut_tpu.signature`'s on `backend="python"` with the same seeded draws,
under G1 and G2; the prepare step's schedules (the device offset, the
asynchronous distinct MSM, the synchronous host spec);
the plus-offset program and the packed / wire split of its operands; the
bucketed distinct-MSM schedule at windows 2, 3 and 5 against the Horner one
and the spec; the cost model's choices; and the refusals (no card, a
failing device hash, bad aggregation subsets).

Keys, ElGamal keys and messages are made by the JAX package from a seeded
`secrets.randbelow` and carried across with `coconut_tpu_torch.convert`.
Shapes are tiny (B = 2, 6 attributes, 2 hidden, 3-of-5). Tolerance: exact —
bytes, points and bits must be equal.
"""

import functools
import random
from types import SimpleNamespace

import pytest
import torch

from coconut_tpu import elgamal as jelgamal
from coconut_tpu import keygen as jkeygen
from coconut_tpu import params as jparams
from coconut_tpu import signature as jsig
from coconut_tpu.errors import GeneralError as JGeneralError
from coconut_tpu.ops import curve as jcurve
from coconut_tpu.ps import ps_verify as jps_verify
from coconut_tpu_torch import convert, ps
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.backend import SpecBackend
from coconut_tpu_torch.errors import GeneralError
from coconut_tpu_torch.gpu import curve as cv
from coconut_tpu_torch.gpu import fp
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import (
    PackedPoints, TorchBackend, _bucket_window, _decode_points, _pack_pts, _pts_f32,
    _unpack_pt,
)
from coconut_tpu_torch.gpu.limbs import fr_digits_signed_np
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import R
from torch_show_helpers import seeded_randbelow, two_torch_threads  # noqa: F401 (autouse)

B = 2
HIDDEN = 2
SIGNERS = (1, 3, 5)  # the 3-of-5 subset that signs and aggregates


@pytest.fixture(scope="module")
def backend():
    return TorchBackend(device="cpu", comb_window=4)


@functools.lru_cache(maxsize=None)
def _state(ctx):
    """The JAX package's params, 3-of-5 signers, ElGamal key pair and B
    message vectors from a seeded draw, beside the port's copies."""
    with pytest.MonkeyPatch.context() as mp:
        seeded_randbelow(mp, 0x155E)
        jp = jparams.Params.new(6, b"backend-test", jparams.GroupContext(ctx))
        _, _, jsigners = jkeygen.trusted_party_SSS_keygen(3, 5, jp)
        esk, epk = jelgamal.elgamal_keygen(jp.ctx.sig, jp.g)
    rng = random.Random(0x3E55)
    msgs = [[rng.randrange(R) for _ in range(6)] for _ in range(B)]
    return SimpleNamespace(
        jp=jp, jsigners=jsigners, pp=convert.params_from(jp),
        signers=[convert.signer_from(s) for s in jsigners], esk=esk, epk=epk, msgs=msgs,
    )


@pytest.fixture(scope="module", params=["G1", "G2"])
def state(request):
    return _state(request.param)


def _prepare(monkeypatch, fn, msgs, pk, params, backend, seed=0x9E):
    seeded_randbelow(monkeypatch, seed)
    return fn(msgs, HIDDEN, pk, params, backend=backend)


def _req_bytes(out, ctx):
    return [(req.to_bytes(ctx), rnd) for req, rnd in out]


def _points(sigs):
    return [(s.sigma_1, s.sigma_2) for s in sigs]


def test_issuance_round_matches_the_reference(state, backend, monkeypatch):
    """prepare -> blind-sign by signers 1, 3, 5 -> unblind -> aggregate on
    the cpu TorchBackend (blind-sign: signer 1's batch; the others' on the
    host spec) and on the host spec, byte-equal to the JAX package's
    functions at every step; lanes 0 and B-1 equal the spec holders
    (SignatureRequest.new, BlindSignature.new, Signature.aggregate);
    the aggregated verkeys agree; every issued credential verifies with the
    JAX package's ps_verify. Under G1 the prepare step hashes on the
    "device" (its program on the CPU) and assembles c2 by the offset
    program; under G2 the host hashes, as in the reference."""
    jp, pp, ctx = state.jp, state.pp, state.pp.ctx
    g1_ctx = ctx.name == "G1"
    monkeypatch.setattr(backend, "device_hash_enabled", lambda: g1_ctx)
    hashes, offsets = backend.device_hash_batches, backend.msm_offset_dispatches
    want = _prepare(monkeypatch, jsig.batch_prepare_blind_sign, state.msgs, state.epk, jp, "python")
    got = _prepare(monkeypatch, sig.batch_prepare_blind_sign, state.msgs, state.epk, pp, backend)
    spec = _prepare(monkeypatch, sig.batch_prepare_blind_sign, state.msgs, state.epk, pp, ps.SPEC)
    assert _req_bytes(got, ctx) == _req_bytes(spec, ctx) == _req_bytes(want, jp.ctx)
    assert backend.device_hash_batches - hashes == int(g1_ctx)
    assert backend.msm_offset_dispatches - offsets == 1
    reqs, jreqs = [r for r, _ in got], [r for r, _ in want]
    for i in (0, B - 1):  # the host spec request from the same draws
        rnd = got[i][1]
        draws = iter(rnd)
        monkeypatch.setattr(sig, "rand_fr", lambda: next(draws))
        monkeypatch.setattr("coconut_tpu_torch.elgamal.rand_fr", lambda: next(draws))
        one, _ = sig.SignatureRequest.new(state.msgs[i], HIDDEN, state.epk, pp)
        assert one.to_bytes(ctx) == reqs[i].to_bytes(ctx)
        assert one.get_h(ctx) == reqs[i].get_h(ctx) == ctx.hash_to_sig(
            sig.SignatureRequest.hash_input(one.commitment, one.known_messages, ctx)
        )

    blinded = {}
    for sid in SIGNERS:
        signer, jsigner = state.signers[sid - 1], state.jsigners[sid - 1]
        b = sig.batch_blind_sign(reqs, signer.sigkey, pp, ps.SPEC)
        jb = jsig.batch_blind_sign(jreqs, jsigner.sigkey, jp, backend="python")
        if sid == SIGNERS[0]:
            on_be = sig.batch_blind_sign(reqs, signer.sigkey, pp, backend)
            assert [x.to_bytes(ctx) for x in on_be] == [x.to_bytes(ctx) for x in b]
            # the JAX package's requests, carried across, sign the same
            crossed = [convert.request_from(r) for r in jreqs]
            assert [x.to_bytes(ctx) for x in sig.batch_blind_sign(crossed, signer.sigkey, pp, ps.SPEC)] == [
                x.to_bytes(ctx) for x in b
            ]
        assert [x.to_bytes(ctx) for x in b] == [x.to_bytes(jp.ctx) for x in jb]
        for i in (0, B - 1):
            assert sig.BlindSignature.new(reqs[i], signer.sigkey, pp).to_bytes(ctx) == b[i].to_bytes(ctx)
        blinded[sid] = (b, jb)

    # every signer's blind signatures unblinded in one call
    flat = [x for sid in SIGNERS for x in blinded[sid][0]]
    unblinded = sig.batch_unblind(flat, state.esk, ctx, backend)
    assert _points(unblinded) == _points(sig.batch_unblind(flat, state.esk, ctx, ps.SPEC))
    junblinded = {
        sid: jsig.batch_unblind(blinded[sid][1], state.esk, jp.ctx, backend="python")
        for sid in SIGNERS
    }
    assert _points(unblinded) == _points([x for sid in SIGNERS for x in junblinded[sid]])
    assert _points([flat[0].unblind(state.esk, ctx)]) == _points(unblinded[:1])
    jflat = [convert.blind_signature_from(x) for sid in SIGNERS for x in blinded[sid][1]]
    assert _points(sig.batch_unblind(jflat, state.esk, ctx, ps.SPEC)) == _points(unblinded)

    partials = [
        [(sid, unblinded[n * B + i]) for n, sid in enumerate(SIGNERS)] for i in range(B)
    ]
    creds = sig.batch_aggregate(3, partials, ctx, backend)
    jcreds = jsig.batch_aggregate(
        3, [[(sid, junblinded[sid][i]) for sid in SIGNERS] for i in range(B)], jp.ctx,
        backend="python",
    )
    assert _points(creds) == _points(jcreds)
    assert _points([convert.signature_from(c) for c in jcreds]) == _points(creds)
    assert _points(sig.batch_aggregate(3, partials, ctx, ps.SPEC)) == _points(creds)
    assert _points([sig.Signature.aggregate(3, partials[-1], ctx)]) == _points(creds[-1:])

    vk = sig.Verkey.aggregate(3, [(s, state.signers[s - 1].verkey) for s in SIGNERS], ctx)
    jvk = jsig.Verkey.aggregate(3, [(s, state.jsigners[s - 1].verkey) for s in SIGNERS], jp.ctx)
    assert (vk.X_tilde, vk.Y_tilde) == (jvk.X_tilde, jvk.Y_tilde)
    assert vk.to_bytes(ctx) == jvk.to_bytes(jp.ctx)
    assert all(
        jps_verify(jsig.Signature(c.sigma_1, c.sigma_2), m, jvk, jp)
        for c, m in zip(creds, state.msgs)
    )


class _Without:
    """A backend with some of its methods hidden: the prepare step's
    capability probes then pick another schedule."""

    def __init__(self, be, hidden):
        self._be = be
        self._hidden = set(hidden)

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._be, name)


def test_prepare_schedules_give_the_same_requests(backend, monkeypatch):
    """Under G1: the asynchronous distinct schedule (no offset program: h^m
    by itself, c2 added on the host) on the cpu TorchBackend gives the JAX
    package's requests byte for byte (the offset schedule and the
    synchronous one are in test_issuance_round_matches_the_reference). The
    cpu backend does not hash on its device."""
    st = _state("G1")
    ctx = st.pp.ctx
    want = _prepare(monkeypatch, jsig.batch_prepare_blind_sign, st.msgs, st.epk, st.jp, "python")
    hashes, offsets = backend.device_hash_batches, backend.msm_offset_dispatches
    got = _prepare(
        monkeypatch, sig.batch_prepare_blind_sign, st.msgs, st.epk, st.pp,
        _Without(backend, ["msm_g1_distinct_plus_offset_async"]),
    )
    assert _req_bytes(got, ctx) == _req_bytes(want, st.jp.ctx)
    assert (backend.device_hash_batches, backend.msm_offset_dispatches) == (hashes, offsets)


def test_plus_offset_program_and_the_packed_wire_split(backend):
    """A program's packed output holds digits of the MONTGOMERY value: it
    re-enters a program through _unpack_pt, with no domain change, and
    _pts_f32 (the raw wire's path, which moves standard-domain digits into
    the Montgomery domain) refuses it. Taken the wrong way the same bytes
    decode to x R instead of x. The plus-offset program, fed such a handle,
    equals the host add offset_i + MSM_i, with an identity offset, a zero
    scalar and both on lanes 1-3."""
    rng = random.Random(0x0FF5)
    offs = [g1.mul(G1_GEN, rng.randrange(1, R)) for _ in range(4)]
    offs[1] = offs[3] = None
    mont = tw.encode_batch([(0, 0) if p is None else p for p in offs], "cpu")
    x, y = _pack_pts(mont)
    handle = PackedPoints((x, y, torch.tensor([p is None for p in offs])))
    assert _decode_points(*_unpack_pt(handle)) == offs
    for wire in (handle, (handle, x)):
        with pytest.raises(TypeError):
            _pts_f32(wire)
    with pytest.raises(TypeError):
        _unpack_pt((x, y, handle[2]))
    wrong = tw.decode_batch(fp.to_mont(x))
    assert wrong[0] == offs[0][0] * (1 << 416) % jcurve.P != offs[0][0]

    pts = [[g1.mul(G1_GEN, rng.randrange(1, R))] for _ in range(4)]
    scal = [[rng.randrange(R)] for _ in range(4)]
    scal[2] = scal[3] = [0]
    got = backend.msm_distinct_wait(backend.msm_g1_distinct_plus_offset_async(pts, scal, handle))
    assert got == [g1.add(o, g1.msm(p, s)) for o, p, s in zip(offs, pts, scal)]


# --- the bucketed schedule ---------------------------------------------------------


def _digits(scalars, nwin, window):
    mag, sgn = fr_digits_signed_np([s for row in scalars for s in row], nwin=nwin, window=window)
    k = len(scalars[0])
    return (
        torch.from_numpy(mag.reshape(len(scalars), k, nwin)),
        torch.from_numpy(sgn.reshape(len(scalars), k, nwin)),
    )


def _projective_to_affine(spec, acc):
    """Projective (X : Y : Z) limbs -> spec affine points, on the host."""
    X, Y, Z = (tw.decode_batch(c) for c in acc)
    out = []
    for xv, yv, zv in zip(X, Y, Z):
        if zv == spec.zero:
            out.append(None)
            continue
        zi = spec.f_inv(zv)
        out.append((spec.f_mul(xv, zi), spec.f_mul(yv, zi)))
    return out


@pytest.mark.parametrize("window", [2, 3, 5])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_bucketed_msm_matches_horner_and_the_spec(group, window):
    """curve.msm_distinct_bucketed over [3, 3] rows of 20-bit scalars (an
    identity base and a zero scalar among them) equals the Horner schedule
    (curve.msm_distinct_signed) on the same rows and the JAX package's spec
    MSM. The schedule per window is the full program's; short scalars keep
    the window count small."""
    spec, jspec, gen, fl = (
        (g1, jcurve.g1, G1_GEN, cv.FP) if group == "G1" else (g2, jcurve.g2, G2_GEN, cv.FP2)
    )
    rng = random.Random(window)
    pts = [[spec.mul(gen, rng.randrange(1, R)) for _ in range(3)] for _ in range(3)]
    pts[0][1] = None
    scal = [[rng.randrange(1 << 20) for _ in range(3)] for _ in range(3)]
    scal[1][2] = 0
    flat = [p for row in pts for p in row]
    zero = spec.zero
    enc = lambda i: tw.encode_batch([zero if p is None else p[i] for p in flat], "cpu")
    shape = lambda t: t.reshape((3, 3) + t.shape[1:])
    x, y = tw.tree_map(shape, enc(0)), tw.tree_map(shape, enc(1))
    inf = torch.tensor([p is None for p in flat]).reshape(3, 3)
    bucketed = cv.msm_distinct_bucketed(
        fl, x, y, inf, *_digits(scal, -(-20 // window) + 1, window), window
    )
    horner = cv.msm_distinct_signed(fl, x, y, inf, *_digits(scal, -(-20 // 5) + 1, 5))
    want = [jspec.msm(p, s) for p, s in zip(pts, scal)]
    assert _projective_to_affine(spec, bucketed) == _projective_to_affine(spec, horner) == want


def test_bucketed_program_through_the_backend(backend, monkeypatch):
    """msm_g1_distinct with the bucketed schedule forced at window 3 (full
    255-bit scalars, GLV-split to [3, 4] rows of 128-bit halves) equals the
    spec and counts one bucketed dispatch; the cost model ("auto", as on
    cuda) takes 32 G1 bases a row (64 after GLV) bucketed at window 5 and
    keeps every config 4 shape Horner."""
    monkeypatch.setattr(backend, "bucket_mode", 3)
    rng = random.Random(0xB0C)
    pts = [[g1.mul(G1_GEN, rng.randrange(1, R)) for _ in range(2)] for _ in range(3)]
    pts[0][0] = None
    scal = [[rng.randrange(R) for _ in range(2)] for _ in range(3)]
    scal[1][1] = 0
    before = backend.msm_bucketed_dispatches
    assert backend.msm_g1_distinct(pts, scal) == [jcurve.g1.msm(p, s) for p, s in zip(pts, scal)]
    assert (backend.msm_bucketed_dispatches - before, backend.msm_bucket_window) == (1, 3)
    assert _bucket_window(64, 128, "auto") == 5
    # h^m and unblind (k = 1), blind-sign and aggregate (k = 3), G1 after
    # GLV and G2 without
    assert [_bucket_window(k, b, "auto") for k, b in ((2, 128), (6, 128), (3, 255), (1, 255))] == [None] * 4
    assert _bucket_window(64, 128, "off") is None and _bucket_window(2, 128, 4) == 4


# --- refusals -----------------------------------------------------------------


def test_backend_none_needs_a_card():
    """backend=None is a TorchBackend on cuda: without a card every batch
    function raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    st = _state("G1")
    req = sig.SignatureRequest([], None, [])
    calls = [
        lambda: sig.batch_prepare_blind_sign(st.msgs, HIDDEN, st.epk, st.pp),
        lambda: sig.batch_blind_sign([req], st.signers[0].sigkey, st.pp),
        lambda: sig.batch_unblind([sig.BlindSignature(None, (None, None))], 1, st.pp.ctx),
        lambda: sig.batch_aggregate(1, [[(1, sig.Signature(None, None))]], st.pp.ctx),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class _FailingHash(SpecBackend):
    def device_hash_enabled(self):
        return True

    def hash_to_g1_batch(self, datas):
        raise RuntimeError("device hash failed")


def test_a_failing_device_hash_is_not_caught():
    """No fallback: where the backend hashes on its device, a failure of
    that hash propagates (the reference rehashes on the host)."""
    st = _state("G1")
    with pytest.raises(RuntimeError, match="device hash failed"):
        sig.batch_prepare_blind_sign(st.msgs, HIDDEN, st.epk, st.pp, backend=_FailingHash())


def test_aggregation_refusals_match_the_reference():
    """Short, duplicated and out-of-range subsets, and partials that
    disagree on sigma_1, raise GeneralError with the reference's message
    and code."""
    st = _state("G1")
    s = sig.Signature(G1_GEN, G1_GEN)
    other = sig.Signature(g1.double(G1_GEN), G1_GEN)
    cases = [
        (3, [(1, s), (2, s)]),
        (2, [(1, s), (1, s)]),
        (2, [(0, s), (2, s)]),
        (2, [(1, s), (2, other)]),
    ]
    for t, subset in cases:
        with pytest.raises(GeneralError) as mine:
            sig.batch_aggregate(t, [subset], st.pp.ctx, ps.SPEC)
        with pytest.raises(JGeneralError) as ref:
            jsig.batch_aggregate(t, [subset], st.jp.ctx, backend="python")
        assert (str(mine.value), mine.value.code) == (str(ref.value), ref.value.code)
