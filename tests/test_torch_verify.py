"""The port's main path as a whole: TorchBackend(device="cpu").batch_verify
against JaxBackend.batch_verify and the spec's ps_verify, on the mixed
batch of tests/test_backends.py (B = 8, 6 attributes, Params.new(6,
b"backend-test"), lanes valid / tampered sigma_2 / wrong message /
identity sigma_1), and the JAX encoder's operands fed through
convert.operands_from_numpy into the port's fused_verify.

Tolerance: exact — verdict bits must be equal.
"""

import random

import numpy as np
import pytest
import torch

from coconut_tpu.ops.fields import R
from coconut_tpu.params import Params
from coconut_tpu.ps import ps_verify
from coconut_tpu.signature import Signature, Sigkey, Verkey
from coconut_tpu.tpu.backend import JaxBackend
from coconut_tpu_torch import entry
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend, fused_verify

MSG_COUNT = 6
BATCH = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_backends.py's construction: master-key credentials with
    lanes i % 4 == 1 tampered (sigma_2 doubled), == 2 wrong message, and
    lane 3 the identity-sigma_1 forgery."""
    rng = random.Random(0xBAC0)
    params = Params.new(MSG_COUNT, b"backend-test")
    sk = Sigkey(rng.randrange(1, R), [rng.randrange(1, R) for _ in range(MSG_COUNT)])
    ops = params.ctx.other
    vk = Verkey(ops.mul(params.g_tilde, sk.x), [ops.mul(params.g_tilde, y) for y in sk.y])
    sig_ops = params.ctx.sig
    sigs, msgs_list, expect = [], [], []
    for i in range(BATCH):
        msgs = [rng.randrange(R) for _ in range(MSG_COUNT)]
        s1 = sig_ops.mul(params.g, rng.randrange(1, R))
        e = (sk.x + sum(y * m for y, m in zip(sk.y, msgs))) % R
        sig = Signature(s1, sig_ops.mul(s1, e))
        kind = i % 4
        if kind == 1:
            sig = Signature(sig.sigma_1, sig_ops.mul(sig.sigma_2, 2))
        elif kind == 2:
            msgs = list(msgs)
            msgs[0] = (msgs[0] + 1) % R
        elif kind == 3 and i == 3:
            sig = Signature(None, None)
        expect.append(kind == 0 or (kind == 3 and i != 3))
        sigs.append(sig)
        msgs_list.append(msgs)
    return params, vk, sigs, msgs_list, expect


@pytest.fixture(scope="module")
def port_backend():
    return TorchBackend(device="cpu")


def test_batch_verify_matches_jax_and_spec(setup, port_backend):
    params, vk, sigs, msgs_list, expect = setup
    plain_before = cuda_fp.PLAIN_CALLS
    got = port_backend.batch_verify(sigs, msgs_list, vk, params)
    assert cuda_fp.PLAIN_CALLS > plain_before  # CPU tensors: the plain path
    jax_bits = JaxBackend().batch_verify(sigs, msgs_list, vk, params)
    spec = [ps_verify(s, m, vk, params) for s, m in zip(sigs, msgs_list)]
    assert got == [bool(b) for b in jax_bits] == spec == expect


def test_jax_operands_through_port_fused_verify(setup, port_backend):
    params, vk, sigs, msgs_list, expect = setup
    jops = JaxBackend().encode_verify_batch(sigs, msgs_list, vk, params)
    tops = operands_from_numpy(tuple_tree(jops), CPU)
    assert tops[1].dtype == torch.uint8 and tops[3][0].dtype == torch.int16
    bits = fused_verify(True, *tops)
    assert bits.tolist() == expect
    # the port's own encoder yields the same operands (window 6, int16 wire)
    pops = port_backend.encode_verify_batch(sigs, msgs_list, vk, params)
    for p, t in zip(tw.leaves(pops), tw.leaves(tops)):
        assert p.dtype == t.dtype and torch.equal(p, t)


def test_static_operand_cache(setup):
    """Its own backend, so the counts do not hang on which tests of the
    module ran before it in this worker: the first encode misses, the
    second hits."""
    params, vk, sigs, msgs_list, expect = setup
    be = TorchBackend(device="cpu")
    be.encode_verify_batch(sigs[:2], msgs_list[:2], vk, params)
    assert (be.encode_cache_hits, be.encode_cache_misses) == (0, 1)
    be.encode_verify_batch(sigs[:2], msgs_list[:2], vk, params)
    assert (be.encode_cache_hits, be.encode_cache_misses) == (1, 1)
    assert be.batch_verify([], [], vk, params) == []


def test_g2_assignment_is_a_later_slice(port_backend):
    """The G2 assignment, a later slice until the grouped verify's, through
    the same call: encode_verify_batch under ctx "G2" (signatures in G2,
    the verkey and g_tilde in G1) yields operands that decode to the spec's
    points — sigma_1 and -sigma_2 as Fp2 pairs, g_tilde as an Fp pair, and
    comb-table entries (j, w, d) equal to d * 64^(nwin-1-w) * base_j over
    G1. The program's G2 bits are in tests/test_torch_g2.py."""
    from coconut_tpu.ops.curve import g1 as sg1, g2 as sg2
    from coconut_tpu_torch.gpu import curve as cv
    from coconut_tpu_torch.gpu.backend import _pts_f32

    params, _, vk, sigs, msgs = entry.fixture(2, msg_count=2, ctx="G2")
    wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2 = port_backend.encode_verify_batch(
        sigs, msgs, vk, params
    )
    s1, s2n, gtx, gty = _pts_f32((s1, s2n, gtx, gty))
    pts = lambda xy: list(zip(tw.decode_batch(xy[0]), tw.decode_batch(xy[1])))
    assert pts(s1) == [s.sigma_1 for s in sigs]
    assert pts(s2n) == [sg2.neg(s.sigma_2) for s in sigs]
    assert pts((gtx[None], gty[None])) == [params.g_tilde]
    assert (inf1 | inf2).tolist() == [False, False] and mag.shape == (2, 3, 43)
    bases = [vk.X_tilde] + vk.Y_tilde
    at = [(0, 42, 1), (1, 0, 32), (2, 20, 17)]  # (base, window, digit)
    X, Y, Z = (torch.stack([t[j, w, d] for j, w, d in at]) for t in wtables)
    ax, ay, ainf = cv.to_affine(cv.FP, (X, Y, Z))
    assert not ainf.any()
    assert pts((ax, ay)) == [sg1.mul(bases[j], d * 64 ** (42 - w)) for j, w, d in at]


@pytest.mark.parametrize("raw_wire", [True, False])
def test_point_wires_decode_to_the_points(setup, raw_wire):
    """Both point wires (raw 48-byte digits entering the Montgomery domain
    on the device, int16 balanced limbs) decode back to the spec points,
    for G1 and G2, with None as the identity mask."""
    from coconut_tpu_torch.gpu.backend import _pts_f32

    params, vk, sigs, _, _ = setup
    be = TorchBackend(device="cpu", raw_wire=raw_wire)
    g1_pts = [sigs[0].sigma_1, None, sigs[2].sigma_2]
    g2_pts = [vk.X_tilde, None, vk.Y_tilde[0]]
    for pts, enc in ((g1_pts, be._encode_g1_points), (g2_pts, be._encode_g2_points)):
        (x, y), inf = enc(pts)
        leaf = x[0] if isinstance(x, tuple) else x
        assert leaf.dtype == (torch.uint8 if raw_wire else torch.int16)
        x, y = _pts_f32((x, y))
        got = list(zip(tw.decode_batch(x), tw.decode_batch(y)))
        assert inf.tolist() == [False, True, False]
        assert [got[0], got[2]] == [pts[0], pts[2]]


def test_entry_fixture_and_forgeries():
    """entry.fixture draws the same credentials as __graft_entry__._fixture,
    and entry.forge's three kinds of bad lane verify False on the port and
    on the spec."""
    import __graft_entry__ as graft

    params, _, vk, sigs, msgs = entry.fixture(6)
    jparams, _, jvk, jsigs, jmsgs = graft._fixture(batch=6)
    assert (params.g, params.g_tilde, params.h) == (jparams.g, jparams.g_tilde, jparams.h)
    assert (vk.X_tilde, vk.Y_tilde) == (jvk.X_tilde, jvk.Y_tilde)
    assert [(s.sigma_1, s.sigma_2) for s in sigs] == [(s.sigma_1, s.sigma_2) for s in jsigs]
    assert msgs == jmsgs

    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=2)
    assert expect == [True, False] * 3
    got = TorchBackend(device="cpu", comb_window=4).batch_verify(fsigs, fmsgs, vk, params)
    spec = [
        ps_verify(Signature(s.sigma_1, s.sigma_2), m, jvk, jparams)
        for s, m in zip(fsigs, fmsgs)
    ]
    assert got == spec == expect


def test_entry_program_on_cpu():
    fn, operands = entry.entry(batch=2, device="cpu")
    assert fn(*operands).tolist() == [True, True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.entry(batch=2)


def tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(tuple_tree(x) for x in t)
    return np.asarray(t)
