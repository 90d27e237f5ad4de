"""The port's hash to the curves against the JAX package on the CPU: the
host spec (`ops/hashing.py`, `Params.new`), the field helpers `fp.from_mont`
and `fp.canon_parity` against `coconut_tpu.tpu.fp` limb for limb, the
device SvdW map (`curve.svdw_map_fp`) on each of its three candidates and
at its edges (u = 0, tv1 * tv2 = 0, a candidate pair that sums to the
identity), and the hash program (`hash_to_g1_program`, through
`TorchBackend.hash_to_g1_batch`) against `coconut_tpu.ops.hashing`.

The JAX package's jitted hash program is not run here (its XLA compile
takes minutes); its host spec is the oracle. Shapes are tiny (B <= 8).
Tolerance: exact — limbs, bits and points must be equal.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coconut_tpu import params as jparams
from coconut_tpu.ops import curve as jcurve
from coconut_tpu.ops import hashing as jhash
from coconut_tpu.tpu import fp as jfp
from coconut_tpu_torch import params
from coconut_tpu_torch.gpu import fp
from coconut_tpu_torch.gpu import curve as cv
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend, _decode_points, hash_to_g1_program
from coconut_tpu_torch.gpu.limbs import fp_encode_raw_batch
from coconut_tpu_torch.ops import hashing
from coconut_tpu_torch.ops.fields import P, fp_inv, fp_sqrt
from torch_show_helpers import two_torch_threads  # noqa: F401 (autouse)

DST_255 = bytes(range(255))


# --- the host spec ------------------------------------------------------------


def test_host_hashes_match_the_reference():
    """expand_message_xmd, the SvdW constants, hash_to_g1 and hash_to_g2 of
    the port's host copy equal the JAX package's, on the empty message, a
    long one, and under a 255-byte DST (the last direct-encoding length)."""
    assert hashing._SVDW_FP == jhash._SVDW_FP
    assert hashing._SVDW_FP2 == jhash._SVDW_FP2
    for dst in (hashing.DST_G1, DST_255):
        for m in (b"", b"A" * 130):
            assert hashing.expand_message_xmd(m, dst, 128) == jhash.expand_message_xmd(m, dst, 128)
            assert hashing.hash_to_g1(m, dst) == jhash.hash_to_g1(m, dst)
    assert hashing.hash_to_g2(b"g2") == jhash.hash_to_g2(b"g2")
    assert hashing.hash_to_fr(b"fr") == jhash.hash_to_fr(b"fr")


@pytest.mark.parametrize("ctx", ["G1", "G2"])
def test_params_new_matches_the_reference(ctx):
    mine = params.Params.new(6, b"backend-test", params.GroupContext(ctx))
    ref = jparams.Params.new(6, b"backend-test", jparams.GroupContext(ctx))
    assert (mine.g, mine.g_tilde, mine.h) == (ref.g, ref.g_tilde, ref.h)
    assert mine.msg_count() == 6


# --- field helpers --------------------------------------------------------------


def _mul_outputs(n, seed):
    """NORMALIZED rows with |value| < 0.66p (products of random LAZY rows),
    the encoded 1, and 0."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 129, size=(2, n, 52)).astype(np.float32)
    a[..., 48:] = 0.0
    rows = fp.mul(torch.from_numpy(a[0]), torch.from_numpy(a[1]))
    return torch.cat([rows, fp.ones_mont((1,), "cpu"), fp.zeros((1,), "cpu")])


def test_from_mont_and_canon_parity_match_the_reference():
    t = _mul_outputs(64, 11)
    jt = jnp.asarray(t.numpy())
    np.testing.assert_array_equal(fp.from_mont(t).numpy(), np.asarray(jfp.from_mont(jt)))
    par = fp.canon_parity(t)
    np.testing.assert_array_equal(par.numpy(), np.asarray(jfp.canon_parity(jt)))
    values = [sum(int(v) << (8 * i) for i, v in enumerate(row)) % P for row in t.numpy()]
    assert par.tolist() == [bool(v & 1) for v in values]
    # on from_mont's output the parity is that of the standard-domain value
    std = [v * pow(1 << 416, -1, P) % P for v in values]
    assert fp.canon_parity(fp.from_mont(t)).tolist() == [bool(v & 1) for v in std]


# --- the SvdW map and the hash program ---------------------------------------------


def _u_for_candidate(which):
    """A field element whose map takes exactly x-candidate `which`
    (1-based), found by replaying the spec's candidates and square tests."""
    F = hashing._FpAdapter
    Z, c1, c2, c3, c4 = hashing._SVDW_FP
    rng = random.Random(0x5D + which)

    def g(x):
        return F.add(F.mul(F.sq(x), x), F.B)

    while True:
        u = rng.randrange(1, P)
        tv1 = F.mul(F.sq(u), c1)
        tv2, tv1 = F.add(1, tv1), F.sub(1, tv1)
        tv3 = F.inv0(F.mul(tv1, tv2))
        tv4 = F.mul(F.mul(F.mul(u, tv1), tv3), c3)
        x3 = F.add(F.mul(F.sq(F.mul(F.sq(tv2), tv3)), c4), Z)
        sq = [fp_sqrt(g(x)) is not None for x in (F.sub(c2, tv4), F.add(c2, tv4), x3)]
        if sq[:which] == [False] * (which - 1) + [True]:
            return u


def _edge_pairs():
    """Eight (u0, u1) lanes: each candidate, u = 0, the u with
    tv1 * tv2 = 0 (u^2 c1 = 1; the inverse maps 0 to 0), random u's, and
    last (u, p - u) with u a candidate-3 element: the map is odd there, so
    the pair sums to the identity."""
    u1, u2, u3 = (_u_for_candidate(w) for w in (1, 2, 3))
    u_inv0 = fp_sqrt(fp_inv(hashing._SVDW_FP[1]))
    assert u_inv0 is not None
    rng = random.Random(7)
    return [
        (u1, u2), (u2, u3), (u3, u1), (0, 0), (u_inv0, u1),
        (rng.randrange(P), rng.randrange(P)), (rng.randrange(P), 1), (u3, P - u3),
    ]


def _spec_map(u):
    return jhash._map_to_curve_svdw(jhash._FpAdapter, jhash._SVDW_FP, u)


def _upload(us):
    dig = torch.from_numpy(fp_encode_raw_batch(us).copy())
    par = torch.tensor([bool(u & 1) for u in us])
    return dig, par


def test_svdw_map_each_candidate_and_edges():
    """The stacked device map on sixteen u's: every affine point equals the
    spec's map (which runs the candidates by branches)."""
    us = [u for pair in _edge_pairs() for u in pair]
    dig, par = _upload(us)
    x, y = cv.svdw_map_fp(fp.to_mont(dig), par)
    got = list(zip(tw.decode_batch(x), tw.decode_batch(y)))
    assert got == [_spec_map(u) for u in us]


def test_hash_program_on_edge_lanes(monkeypatch):
    """hash_to_g1_program on the eight lanes: each equals clear_cofactor of
    the spec maps' sum, the identity lane is flagged, and hash_to_g1_wait
    refuses the batch because of it. The packed coordinates keep
    pack_canon48's contract (G1 mul outputs: |limb| <= 132, |value| <
    0.66p)."""
    seen = []
    pack = fp.pack_canon48
    monkeypatch.setattr(fp, "pack_canon48", lambda t: seen.append(t) or pack(t))
    pairs = _edge_pairs()
    dig, par = _upload([u for pair in pairs for u in pair])
    handle = hash_to_g1_program(dig.reshape(8, 2, 48), par.reshape(8, 2))
    (rows,) = seen
    assert float(rows.abs().max()) <= 132
    for row in rows.numpy():
        assert abs(sum(int(v) << (8 * i) for i, v in enumerate(row))) < 2 * P // 3
    want = [
        jcurve.g1.mul(jcurve.g1.add(_spec_map(a), _spec_map(b)), jcurve.G1_COFACTOR)
        for a, b in pairs
    ]
    assert want[-1] is None and None not in want[:-1]
    assert _decode_points(*handle) == want
    with pytest.raises(ValueError, match="identity"):
        TorchBackend.hash_to_g1_wait(handle)


def test_hash_to_g1_batch_matches_the_reference():
    """Messages through TorchBackend.hash_to_g1_batch under a 255-byte DST,
    the empty one included, equal coconut_tpu.ops.hashing.hash_to_g1; the
    backend counts one batch of four points; an empty batch is no program.
    On the CPU the protocol does not route its hashes here."""
    be = TorchBackend(device="cpu")
    msgs = [b"", b"dst-edge", b"A" * 130, bytes(range(64))]
    assert be.hash_to_g1_batch(msgs, dst=DST_255) == [jhash.hash_to_g1(m, DST_255) for m in msgs]
    assert (be.device_hash_batches, be.device_hash_points) == (1, 4)
    assert be.hash_to_g1_batch([]) == []
    assert be.device_hash_batches == 1
    assert not be.device_hash_enabled()
