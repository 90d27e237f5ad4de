"""The port's random-linear-combination (RLC) batch checks against the JAX
package, on the CPU: the generic pair-set Miller loop and its pad-lane
contract against the spec's multi_pairing; the combiner digits, the wire
encoders, the transcripts and the combiners byte for byte against
coconut_tpu; the combined verify and show-verify programs against the JAX
encoder's operands and PythonBackend's combined methods with the same
combiners; and the protocol layer's bisection ladders on a stub backend,
call for call against coconut_tpu.ps.

Tolerance: exact — GT values, digits, bytes and verdict bits must be equal.
The whole file makes four runs of a program (the pairing product, two
combined verifies, one combined show verify); the JAX package's own
combined programs run only under COCONUT_TEST_HEAVY=1.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from coconut_tpu import batchverify as jbv
from coconut_tpu import ps as jps
from coconut_tpu.backend import PythonBackend
from coconut_tpu.ops import pairing as spec_pairing
from coconut_tpu.ops import serialize as jser
from coconut_tpu.ops.curve import G1_GEN, G2_GEN, g1 as sg1, g2 as sg2
from coconut_tpu.params import DEFAULT_CTX, GroupContext, Params as SpecParams
from coconut_tpu.pok_vc import Proof as SpecSchnorrProof
from coconut_tpu.ps import PoKOfSignatureProof as SpecProof
from coconut_tpu.signature import Signature as SpecSignature, Verkey as SpecVerkey
from coconut_tpu.tpu import backend as jbe
from coconut_tpu_torch import batchverify as bv
from coconut_tpu_torch import entry, ps
from coconut_tpu_torch.errors import CoconutError, PSError
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import pairing as pr
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import (
    TorchBackend, _combiner_digits, fused_verify_combined,
)
from coconut_tpu_torch.ops import serialize as ser
from coconut_tpu_torch.ops.fields import R
from coconut_tpu_torch.params import Signature
from coconut_tpu_torch.pok_vc import Proof as SchnorrProof
from coconut_tpu_torch.ps import PoKOfSignatureProof

CPU = torch.device("cpu")
RS = [0x1D5, (1 << 128) - 1, 0xC0FFEE << 90, 7]  # pinned combiners, < 2^128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def creds():
    """__graft_entry__._fixture's B = 4 credentials (JAX package objects)
    and entry.fixture's (the port's holders): the same draw."""
    return graft._fixture(batch=4), entry.fixture(4)


def _g2_creds(n):
    """entry.fixture(n, ctx="G2")'s credentials as the JAX package's objects
    (which the port reads by duck typing): (params, vk, sigs, msgs)."""
    params, _, vk, sigs, msgs = entry.fixture(n, msg_count=2, ctx="G2")
    jparams = SpecParams(params.g, params.g_tilde, params.h, GroupContext("G2"))
    jsigs = [SpecSignature(s.sigma_1, s.sigma_2) for s in sigs]
    return jparams, SpecVerkey(vk.X_tilde, vk.Y_tilde), jsigs, msgs


def _spec(p):
    """Any proof with the port's fields -> the JAX package's own object."""
    return SpecProof(
        p.sigma_prime_1, p.sigma_prime_2, p.J,
        SpecSchnorrProof(p.proof_vc.t, p.proof_vc.responses),
        p.revealed_msg_indices,
    )


@pytest.fixture(scope="module")
def shows():
    """entry.show_fixture(3)'s shows (the port's holders): lane 0 honest,
    lane 1 with a corrupted Schnorr response, lane 2 with an identity
    sigma'_1 (a dead lane)."""
    params, _, vk, proofs, rmsgs, challenges = entry.show_fixture(3)
    p1, p2 = proofs[1], proofs[2]
    vc = p1.proof_vc
    proofs[1] = PoKOfSignatureProof(
        p1.sigma_prime_1, p1.sigma_prime_2, p1.J,
        SchnorrProof(vc.t, [(vc.responses[0] + 1) % R] + vc.responses[1:]),
        p1.revealed_msg_indices,
    )
    proofs[2] = PoKOfSignatureProof(None, None, p2.J, p2.proof_vc, p2.revealed_msg_indices)
    return params, vk, proofs, rmsgs, challenges


# --- the generic pair-set Miller loop ---------------------------------------


def test_pairing_product_pad_lanes_match_spec(monkeypatch):
    """A [4, 2] pair set through TorchBackend("cpu").pairing_product_is_one:
    a good row (product one), a pad lane first with a junk partner, a pad
    lane last, and an all-pad row. Each row's GT value equals the spec's
    multi_pairing of its unpadded pairs, and the bits are the spec's."""
    b = 0x5EED
    P2, Q2 = sg1.mul(G1_GEN, 3), sg2.mul(G2_GEN, 5)
    junk1, junk2 = sg1.mul(G1_GEN, 11), sg2.mul(G2_GEN, 13)
    good = [(G1_GEN, sg2.mul(G2_GEN, b)), (sg1.neg(sg1.mul(G1_GEN, b)), G2_GEN)]
    rows = [
        good,
        [(junk1, None), (P2, Q2)],
        [(sg1.neg(P2), Q2), (None, junk2)],
        [(None, junk2), (junk1, None)],
    ]
    unpadded = [good, [(P2, Q2)], [(sg1.neg(P2), Q2)], []]

    seen = []

    def spy(f):
        out = final_exp(f)
        seen.append(out)
        return out

    final_exp = pr.final_exp
    monkeypatch.setattr(pr, "final_exp", spy)
    be = TorchBackend(device="cpu")
    bits = be.pairing_product_is_one(rows)
    (gt,) = seen
    want = [spec_pairing.multi_pairing(r) for r in unpadded]
    assert tw.decode_batch(gt) == want
    assert bits == [spec_pairing.pairing_check(r) for r in rows] == [True, False, False, True]
    assert be.final_exps == 4
    with pytest.raises(ValueError, match="ragged"):
        be.pairing_product_is_one([good, good[:1]])


# --- host copies: digits, encoders, transcripts, combiners ------------------


def test_combiner_digits_match_jax():
    mag, sgn = _combiner_digits(RS, CPU)
    jmag, jsgn = jbe._combiner_digits(RS)
    assert mag.shape == (4, 1, 27) and mag.dtype == torch.uint8
    np.testing.assert_array_equal(mag.numpy(), np.asarray(jmag))
    np.testing.assert_array_equal(sgn.numpy(), np.asarray(jsgn))
    assert isinstance(jmag, (np.ndarray, jnp.ndarray))
    for bad in (1 << 128, -1):
        with pytest.raises(ValueError, match="128 bits"):
            _combiner_digits([1, bad], CPU)
        with pytest.raises(ValueError, match="128 bits"):
            jbe._combiner_digits([1, bad])


def test_encoders_match_jax(creds, shows):
    """Field and point encoders, and the wire layouts of a verkey, a
    signature and a show proof (the port's holders and the JAX package's
    objects alike), byte for byte against coconut_tpu."""
    (jparams, _, jvk, jsigs, _), (params, _, vk, sigs, _) = creds
    ctx = DEFAULT_CTX
    for x in (0, 1, R - 1, R + 5):
        assert ser.fr_to_bytes(x) == jser.fr_to_bytes(x)
    for p in (jsigs[0].sigma_1, None):
        assert ser.g1_to_bytes(p) == jser.g1_to_bytes(p)
        assert ser.fp_to_bytes(p[0] if p else 7) == jser.fp_to_bytes(p[0] if p else 7)
    for q in (jvk.X_tilde, None):
        assert ser.g2_to_bytes(q) == jser.g2_to_bytes(q)
    assert ser.g2_to_bytes(None) == b"\x00" * 192
    want = jvk.to_bytes(ctx)
    assert ser.verkey_to_bytes(vk, params.ctx) == ser.verkey_to_bytes(jvk, ctx) == want
    want = jsigs[1].to_bytes(ctx)
    assert ser.signature_to_bytes(sigs[1], params.ctx) == want
    assert ser.signature_to_bytes(Signature(None, None), ctx) == b"\x00" * 192
    sparams, svk, proofs, _, _ = shows
    for p in proofs:
        want = _spec(p).to_bytes(ctx)
        assert ser.show_proof_to_bytes(p, sparams.ctx) == want
        assert ser.show_proof_to_bytes(_spec(p), ctx) == want
    # the G2 assignment swaps the groups' encoders
    g2ctx = GroupContext("G2")
    sig2 = SpecSignature(jvk.X_tilde, None)
    assert ser.signature_to_bytes(sig2, g2ctx) == sig2.to_bytes(g2ctx)
    vk2 = SpecVerkey(jsigs[0].sigma_1, [jsigs[1].sigma_2])
    assert ser.verkey_to_bytes(vk2, g2ctx) == vk2.to_bytes(g2ctx)


def test_verify_transcript_and_combiners_match_jax(creds):
    (jparams, _, jvk, jsigs, jmsgs), (params, _, vk, sigs, msgs) = creds
    for epoch in (None, 0, 7):
        want = jbv.verify_transcript(jsigs, jmsgs, jvk, jparams, epoch=epoch)
        assert bv.verify_transcript(sigs, msgs, vk, params, epoch=epoch) == want
        assert bv.verify_transcript(jsigs, jmsgs, jvk, jparams, epoch=epoch) == want
    t = bv.verify_transcript(sigs, msgs, vk, params)
    bumped = [list(m) for m in msgs]
    bumped[0][0] += 1
    # epoch, verkey, lane and message separation
    assert len({
        t,
        bv.verify_transcript(sigs, msgs, vk, params, epoch=0),
        bv.verify_transcript(sigs, msgs, vk, params, epoch=1),
        bv.verify_transcript(sigs, msgs, SpecVerkey(vk.Y_tilde[0], vk.Y_tilde), params),
        bv.verify_transcript(sigs[:3], msgs[:3], vk, params),
        bv.verify_transcript(sigs, bumped, vk, params),
    }) == 6
    # messages enter reduced mod R
    assert bv.verify_transcript(sigs, [[m + R for m in ms] for ms in msgs], vk, params) == t
    for lam in (None, 64, 128):
        assert bv.derive_combiners(t, 5, lam=lam) == jbv.derive_combiners(t, 5, lam=lam)
    rs = bv.derive_combiners(t, 64, lam=64)
    assert all(1 <= r < (1 << 64) for r in rs) and len(set(rs)) == 64
    for lam in (63, 129):
        with pytest.raises(ValueError, match="COCONUT_BATCH_LAMBDA"):
            bv.derive_combiners(t, 1, lam=lam)


def test_batch_lambda_from_the_environment(monkeypatch):
    monkeypatch.delenv("COCONUT_BATCH_LAMBDA", raising=False)
    assert bv.batch_lambda() == jbv.batch_lambda() == 128
    monkeypatch.setenv("COCONUT_BATCH_LAMBDA", "80")
    assert bv.batch_lambda() == jbv.batch_lambda() == 80
    t = b"transcript"
    assert bv.derive_combiners(t, 3) == jbv.derive_combiners(t, 3)
    assert all(r < (1 << 80) for r in bv.derive_combiners(t, 3))
    monkeypatch.setenv("COCONUT_BATCH_LAMBDA", "32")
    with pytest.raises(ValueError):
        bv.batch_lambda()


def test_show_transcript_matches_jax(creds, shows):
    """A dead proof (identity sigma') enters as zero bytes; a corrupted
    response changes the transcript; epochs separate."""
    (jparams, _, jvk, _, _), _ = creds
    params, vk, proofs, rmsgs, challenges = shows
    sproofs = [_spec(p) for p in proofs]
    for epoch in (None, 3):
        want = jbv.show_transcript(sproofs, jvk, jparams, rmsgs, challenges, epoch=epoch)
        assert bv.show_transcript(proofs, vk, params, rmsgs, challenges, epoch=epoch) == want
        assert bv.show_transcript(sproofs, jvk, jparams, rmsgs, challenges, epoch=epoch) == want
    t = bv.show_transcript(proofs, vk, params, rmsgs, challenges)
    assert t != bv.show_transcript(proofs, vk, params, rmsgs, challenges, epoch=0)
    assert t != bv.show_transcript(proofs[:2], vk, params, rmsgs[:2], challenges[:2])
    assert t != bv.show_transcript(proofs, vk, params, rmsgs, [c + 1 for c in challenges])
    tv = bv.verify_transcript([], [], vk, params)
    assert t != tv and bv.derive_combiners(t, 3) == jbv.derive_combiners(t, 3)


# --- the combined programs --------------------------------------------------


def _tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(_tuple_tree(x) for x in t)
    return np.asarray(t)


def test_jax_operands_through_port_fused_verify_combined(creds):
    """B = 4 with lane 2's sigma_2 doubled, under each signature
    assignment: the JAX encoder's operands and the JAX package's combiner
    digits through the port's program reject the batch, as PythonBackend's
    combined check does with the same r."""
    (jparams, _, jvk, jsigs, jmsgs), _ = creds
    sigs = list(jsigs)
    sigs[2] = SpecSignature(sigs[2].sigma_1, sg1.mul(sigs[2].sigma_2, 2))
    ops = jbe.JaxBackend().encode_verify_batch(sigs, jmsgs, jvk, jparams)
    wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = operands_from_numpy(_tuple_tree(ops), CPU)
    rmag, rsgn = operands_from_numpy(_tuple_tree(jbe._combiner_digits(RS)), CPU)
    plain = cuda_fp.PLAIN_CALLS
    ok = fused_verify_combined(True, wtables, mag, sgn, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2)
    assert cuda_fp.PLAIN_CALLS > plain  # CPU tensors: the plain path
    assert ok.shape == () and not bool(ok)
    assert PythonBackend().batch_verify_combined(sigs, jmsgs, jvk, jparams, rs=RS) is False
    # the G2 assignment: signatures in G2, the verkey and g_tilde in G1
    params, vk, sigs, msgs = _g2_creds(4)
    sigs[2] = SpecSignature(sigs[2].sigma_1, sg2.mul(sigs[2].sigma_2, 2))
    ops = jbe.JaxBackend().encode_verify_batch(sigs, msgs, vk, params)
    wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = operands_from_numpy(_tuple_tree(ops), CPU)
    ok = fused_verify_combined(False, wtables, mag, sgn, s1, s2n, rmag, rsgn, gtx, gty, inf1, inf2)
    assert ok.shape == () and not bool(ok)
    assert PythonBackend().batch_verify_combined(sigs, msgs, vk, params, rs=RS) is False


def test_batch_verify_combined_matches_python_backend(creds):
    """B = 3 honest credentials (padded to 4 with a clone of lane 0) with
    pinned r: one combined check and one final exponentiation, True as
    PythonBackend's, under each signature assignment. The host refuses
    identity sigmas, empty batches and a wrong r count without running a
    program."""
    (jparams, _, jvk, jsigs, jmsgs), (params, _, vk, sigs, msgs) = creds
    be = TorchBackend(device="cpu", comb_window=4)
    assert be.batch_verify_combined(sigs[:3], msgs[:3], vk, params, rs=RS[:3]) is True
    assert (be.combined_checks, be.final_exps) == (1, 1)
    py = PythonBackend()
    assert py.batch_verify_combined(jsigs[:3], jmsgs[:3], jvk, jparams, rs=RS[:3]) is True
    dead = [Signature(None, None)] + sigs[1:]
    assert be.batch_verify_combined(dead, msgs, vk, params) is False
    assert be.batch_verify_combined([], [], vk, params) is True
    assert be.batch_verify_combined_async([], [], vk, params)() is True
    with pytest.raises(ValueError, match="combiner count"):
        be.batch_verify_combined(sigs, msgs, vk, params, rs=RS[:3])
    assert (be.combined_checks, be.final_exps) == (5, 1)
    g2params, g2vk, g2sigs, g2msgs = _g2_creds(3)
    assert be.batch_verify_combined(g2sigs, g2msgs, g2vk, g2params, rs=RS[:3]) is True
    assert py.batch_verify_combined(g2sigs, g2msgs, g2vk, g2params, rs=RS[:3]) is True
    assert (be.combined_checks, be.final_exps) == (6, 2)


def test_batch_show_verify_combined_matches_python_backend(creds, shows):
    """Lanes honest, corrupted Schnorr response, identity sigma'_1 with
    pinned r: per-lane bits [T, F, F] and the pairing bool TRUE (the dead
    lane is masked out of the fold), as PythonBackend's."""
    (jparams, _, jvk, _, _), _ = creds
    params, vk, proofs, rmsgs, challenges = shows
    be = TorchBackend(device="cpu", comb_window=4)
    got = be.batch_show_verify_combined(proofs, vk, params, rmsgs, challenges, rs=RS[:3])
    want = PythonBackend().batch_show_verify_combined(
        [_spec(p) for p in proofs], jvk, jparams, rmsgs, challenges, rs=RS[:3]
    )
    assert got == want == ([True, False, False], True)
    assert (be.combined_checks, be.final_exps) == (1, 1)
    assert be.batch_show_verify_combined([], vk, params, [], []) == ([], True)


# --- the protocol layer's ladders on a stub backend -------------------------


class _Stub:
    """A backend whose checks answer from per-lane truths. Lanes are their
    own indices (verify) or namespaces carrying one (show). A combined
    check's pairing bool is the and of its lanes' pairing truths, except
    on the sub-batches in `collide` (first lane, lanes), which pass as a
    colliding draw would. Records every combined check (first lane,
    lanes), its pairing bool, and every exact call."""

    def __init__(self, pair, schnorr=None, collide=()):
        self.pair, self.schnorr, self.collide = pair, schnorr, set(collide)
        self.calls, self.oks, self.exact = [], [], []

    def _key(self, lanes):
        return (_idx(lanes[0]), len(lanes))

    def _combined(self, lanes, live):
        self.calls.append(self._key(lanes))
        self.oks.append(self._key(lanes) in self.collide or all(self.pair[i] for i in live))
        return self.oks[-1]

    def leaves(self):
        """Single-lane checks that failed."""
        return [lo for (lo, n), ok in zip(self.calls, self.oks) if n == 1 and not ok]

    def batch_verify_combined(self, sigs, msgs, vk, params, epoch=None):
        return self._combined(sigs, sigs)

    def batch_verify(self, sigs, msgs, vk, params):
        self.exact.append(self._key(sigs))
        return [self.pair[i] for i in sigs]

    def batch_show_verify_combined(self, proofs, vk, params, rmsgs, challenges, epoch=None):
        live = [p.i for p in proofs if self.schnorr[p.i] is not None]
        return [bool(self.schnorr[p.i]) for p in proofs], self._combined(proofs, live)

    def batch_show_verify(self, proofs, vk, params, rmsgs, challenges):
        self.exact.append(self._key(proofs))
        return [bool(self.schnorr[p.i]) and self.pair[p.i] for p in proofs]


def _idx(lane):
    return getattr(lane, "i", lane)


# (B, lanes whose pairing check fails, colliding sub-batches, expected
# exact calls): two forged lanes; an identity sigma (rejected on the host,
# so its lane fails every check it is in); a lone lane; an all-valid
# batch; the "both halves pass" residue, settled by the exact path.
VERIFY_LADDERS = {
    "two_forged": (8, {3, 5}, (), []),
    "identity_sigma": (8, {2}, (), []),
    "lone_lane": (1, {0}, (), []),
    "all_valid": (5, set(), (), []),
    "residue": (8, {6}, {(6, 1)}, [(6, 2)]),
}


@pytest.mark.parametrize("case", sorted(VERIFY_LADDERS))
def test_verify_ladder_names_the_forged_lanes(case):
    B, bad, collide, exact_calls = VERIFY_LADDERS[case]
    pair = [i not in bad for i in range(B)]
    stub = _Stub(pair, collide=collide)
    sigs, msgs = list(range(B)), [[0]] * B
    bits = ps.batch_verify(sigs, msgs, "vk", "params", stub, mode="batched")
    assert bits == pair and stub.exact == exact_calls
    assert stub.leaves() == sorted(bad - {lo for lo, _ in collide})
    if not collide:
        ref = _Stub(pair)
        assert jps.batch_verify(sigs, msgs, "vk", "params", backend=ref, mode="batched") == pair
        assert stub.calls == ref.calls  # the reference's ladder, check for check
    assert ps.batch_verify(sigs, msgs, "vk", "params", stub, mode="exact") == pair


def _show_lanes(expect):
    """Proof stand-ins revealing {2}; `verify` (the reference ladder's
    exact check) answers `expect`."""
    lanes = [
        types.SimpleNamespace(
            i=i, revealed_msg_indices={2}, verify=lambda vk, params, rm, c, i=i: expect[i]
        )
        for i in range(len(expect))
    ]
    return lanes, [{2: 0}] * len(expect), [0] * len(expect)


# (B, pairing failures, Schnorr failures, dead lanes, colliding
# sub-batches, expected exact calls)
SHOW_LADDERS = {
    "forged_and_dead": (8, {1, 6}, {4}, {7}, (), []),
    "dead_only": (4, set(), set(), {2}, (), []),
    "residue": (4, {3}, set(), set(), {(3, 1)}, [(2, 2)]),
}


@pytest.mark.parametrize("case", sorted(SHOW_LADDERS))
def test_show_ladder_names_the_forged_lanes(case):
    """Dead lanes and Schnorr failures fail through their own bits and are
    never a leaf; pairing failures are the ladder's leaves."""
    B, bad_pair, bad_schnorr, dead, collide, exact_calls = SHOW_LADDERS[case]
    pair = [i not in bad_pair for i in range(B)]
    schnorr = [None if i in dead else i not in bad_schnorr for i in range(B)]
    expect = [bool(s) and p for s, p in zip(schnorr, pair)]
    proofs, rmsgs, chals = _show_lanes(expect)
    stub = _Stub(pair, schnorr, collide)
    got = ps.batch_show_verify(proofs, "vk", "params", rmsgs, chals, stub, mode="batched")
    assert got == expect and stub.exact == exact_calls
    assert stub.leaves() == sorted(bad_pair - {lo for lo, _ in collide})
    ref = _Stub(pair, schnorr, collide)
    assert jps.batch_show_verify(
        proofs, "vk", "params", rmsgs, chals, backend=ref, mode="batched"
    ) == expect
    assert stub.calls == ref.calls


def test_ladder_edges_and_validation():
    """Where coconut_tpu.ps raises PSError, the port raises its own PSError
    (coconut_tpu_torch.errors), of the same name and wire code."""
    stub = _Stub([])
    assert ps.batch_verify([], [], "vk", "params", stub, mode="batched") == []
    assert ps.batch_show_verify([], "vk", "params", [], [], stub, mode="batched") == []
    assert stub.calls == []
    with pytest.raises(PSError, match="unknown verify mode"):
        ps.batch_verify([0], [[0]], "vk", "params", stub, mode="bogus")
    with pytest.raises(PSError, match="batch size"):
        ps.batch_verify([0, 1], [[0]], "vk", "params", stub, mode="batched")
    proofs, rmsgs, chals = _show_lanes([True, True])
    with pytest.raises(PSError, match="unknown verify mode"):
        ps.batch_show_verify(proofs, "vk", "params", rmsgs, chals, stub, mode="bogus")
    with pytest.raises(PSError, match="batch size"):
        ps.batch_show_verify(proofs, "vk", "params", rmsgs, chals[:1], stub)
    with pytest.raises(PSError, match="batch size"):
        ps.batch_show_verify(proofs, "vk", "params", rmsgs[:1], chals, stub)
    with pytest.raises(PSError, match="requires a backend"):
        ps.batch_show_verify(proofs, "vk", "params", rmsgs, chals, ps.SPEC, mode="batched")
    proofs[1].revealed_msg_indices = {3}
    with pytest.raises(PSError, match="do not match"):
        ps.batch_show_verify(proofs, "vk", "params", rmsgs, chals, stub)


def test_mixed_revealed_sets_go_proof_by_proof():
    """A batch that mixes revealed-index sets goes proof by proof, never to
    the backend, with the reference's bits and ragged counts, in both
    modes."""
    stub = _Stub([])
    proofs, _, chals = _show_lanes([True, True])
    proofs[1].revealed_msg_indices = {3}
    for mode in ("exact", "batched"):
        ps.COUNTS.clear()
        got = ps.batch_show_verify(proofs, "vk", "params", [{2: 0}, {3: 0}], chals, stub, mode)
        want = jps.batch_show_verify(
            proofs, "vk", "params", [{2: 0}, {3: 0}], chals, backend=stub, mode=mode
        )
        assert got == want == [True, True]
        assert dict(ps.COUNTS) == {"show_verify_ragged_fallback": 1, "show_verify_ragged_proofs": 2}
    assert stub.calls == [] and stub.exact == []


def test_ps_error_matches_the_reference():
    """B = 1, mode "bogus": both packages raise a PSError with code
    "ps_error", a CoconutError and not a ValueError."""
    from coconut_tpu.errors import CoconutError as JaxCoconutError, PSError as JaxPSError

    with pytest.raises(JaxPSError) as want:
        jps.batch_verify([0], [[0]], "vk", "params", backend=_Stub([True]), mode="bogus")
    with pytest.raises(PSError) as got:
        ps.batch_verify([0], [[0]], "vk", "params", _Stub([True]), mode="bogus")
    for err, base in ((got.value, CoconutError), (want.value, JaxCoconutError)):
        assert type(err).__name__ == "PSError" and err.code == "ps_error"
        assert isinstance(err, base) and not isinstance(err, ValueError)
    assert str(got.value) == str(want.value)
    assert CoconutError.code == JaxCoconutError.code == "error"


# --- the JAX package's combined programs (heavy) ----------------------------

_heavy_skip = pytest.mark.skipif(
    os.environ.get("COCONUT_TEST_HEAVY") != "1",
    reason="multi-minute XLA compile of the combined programs on the CPU; "
    "set COCONUT_TEST_HEAVY=1",
)


@pytest.mark.heavy
@_heavy_skip
def test_jax_backend_combined_verify_matches_port(creds):
    (jparams, _, jvk, jsigs, jmsgs), _ = creds
    sigs = list(jsigs)
    sigs[1] = SpecSignature(sigs[1].sigma_1, sg1.mul(sigs[1].sigma_2, 2))
    be = TorchBackend(device="cpu")
    for batch in (jsigs, sigs):
        want = jbe.JaxBackend().batch_verify_combined(batch, jmsgs, jvk, jparams, rs=RS)
        assert be.batch_verify_combined(batch, jmsgs, jvk, jparams, rs=RS) == want
    assert want is False


@pytest.mark.heavy
@_heavy_skip
def test_jax_backend_combined_show_verify_matches_port(creds, shows):
    (jparams, _, jvk, _, _), _ = creds
    params, vk, proofs, rmsgs, challenges = shows
    sproofs = [_spec(p) for p in proofs]
    want = jbe.JaxBackend().batch_show_verify_combined(
        sproofs, jvk, jparams, rmsgs, challenges, rs=RS[:3]
    )
    got = TorchBackend(device="cpu").batch_show_verify_combined(
        proofs, vk, params, rmsgs, challenges, rs=RS[:3]
    )
    assert got == want == ([True, False, False], True)
