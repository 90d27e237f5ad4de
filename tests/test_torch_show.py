"""The port's show-verify slice (BASELINE config 3) against the JAX package
and the spec, on the CPU: the distinct-base signed MSM and its table build
limb for limb against coconut_tpu/tpu/curve.py, the show encoder leaf for
leaf against JaxBackend's, the JAX encoder's operands through the port's
fused_show_verify, whole batches against PoKOfSignatureProof.verify and
ps.batch_show_verify, the entry fixture's shows and forgeries, the
static-operand cache keyed by program kind and revealed set, and a G2
show batch against the spec (the G2 family's own tests are in
tests/test_torch_show_g2.py).

Tolerance: exact — limbs, dtypes, shapes and verdict bits must be equal.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from coconut_tpu import pok_sig
from coconut_tpu.ops.curve import G1_GEN, G2_GEN, g1 as sg1, g2 as sg2
from coconut_tpu.pok_vc import Proof as SpecSchnorrProof
from coconut_tpu.ps import PoKOfSignatureProof as SpecProof, batch_show_verify
from coconut_tpu.tpu import curve as jcv
from coconut_tpu.tpu import limbs as jlimbs
from coconut_tpu.tpu.backend import JaxBackend
from coconut_tpu_torch import entry
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import curve as cv
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend, fused_show_verify
from coconut_tpu_torch.gpu.limbs import fp_encode_batch, fr_digits_signed_np
from coconut_tpu_torch.ops.fields import R

B = 8
REVEALED = entry.SHOW_REVEALED
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(p):
    """Any proof with the port's fields -> the JAX package's own object."""
    return SpecProof(
        p.sigma_prime_1, p.sigma_prime_2, p.J,
        SpecSchnorrProof(p.proof_vc.t, p.proof_vc.responses),
        p.revealed_msg_indices,
    )


@pytest.fixture(scope="module")
def mixed():
    """B = 8 shows made by the JAX package's prover (pok_sig.show, real
    Fiat-Shamir challenges) of __graft_entry__._fixture's credentials, with
    lanes 1, 3, 5, 7 forged the four ways of entry.forge_shows."""
    params, _, vk, sigs, msgs_list = graft._fixture(batch=B)
    shows = [pok_sig.show(s, vk, params, m, set(REVEALED)) for s, m in zip(sigs, msgs_list)]
    proofs, rmsgs, expect = entry.forge_shows(
        params, [s[0] for s in shows], [s[2] for s in shows], every=2
    )
    assert expect == [True, False] * (B // 2)
    return params, vk, [_spec(p) for p in proofs], rmsgs, [s[1] for s in shows], expect


@pytest.fixture(scope="module")
def port_backend():
    return TorchBackend(device="cpu")


# --- the distinct-base signed MSM ------------------------------------------


def _np_tree(elems):
    if isinstance(elems[0], tuple):
        return tuple(_np_tree([e[i] for e in elems]) for i in range(len(elems[0])))
    return fp_encode_batch(elems)


def _assert_same(port, ref):
    ports, refs = tw.leaves(port), tw.leaves(_tuple_tree(ref))
    assert len(ports) == len(refs)
    for p, r in zip(ports, refs):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def _tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(_tuple_tree(x) for x in t)
    return t


@pytest.mark.parametrize("group,k", [("G2", 1), ("G1", 3)])
def test_msm_distinct_signed_matches_reference(group, k):
    """B = 3 rows of k points: lane 1 holds an identity point, lane 2 a zero
    scalar. Tables, Jacobian lift and MSM limbs equal the reference's; the
    affine result equals the spec's MSM."""
    spec, gen, fl, jfl, zero = (
        (sg2, G2_GEN, cv.FP2, jcv.FP2, (0, 0)) if group == "G2"
        else (sg1, G1_GEN, cv.FP, jcv.FP, 0)
    )
    rng = random.Random(0x5E0 + k)
    n = 3
    pts = [[spec.mul(gen, rng.randrange(1, R)) for _ in range(k)] for _ in range(n)]
    pts[1][0] = None
    scal = [[rng.randrange(R) for _ in range(k)] for _ in range(n)]
    scal[2][k - 1] = 0
    flat = [p for row in pts for p in row]
    xs = _np_tree([zero if p is None else p[0] for p in flat])
    ys = _np_tree([zero if p is None else p[1] for p in flat])
    shape = lambda t: t.reshape(n, k, t.shape[-1])
    xs, ys = tw.tree_map(shape, xs), tw.tree_map(shape, ys)
    inf = np.array([[p is None for p in row] for row in pts])
    mag, sgn = fr_digits_signed_np([s for row in scal for s in row])
    jmag, jsgn = jlimbs.fr_digits_signed_np([s for row in scal for s in row])
    np.testing.assert_array_equal(mag, jmag)
    np.testing.assert_array_equal(sgn, jsgn)
    mag, sgn = mag.reshape(n, k, 52), sgn.reshape(n, k, 52)
    assert mag.dtype == np.uint8

    tx, ty = tw.tree_map(torch.from_numpy, xs), tw.tree_map(torch.from_numpy, ys)
    jx, jy = tw.tree_map(jnp.asarray, xs), tw.tree_map(jnp.asarray, ys)
    tinf, jinf = torch.from_numpy(inf), jnp.asarray(inf)

    _assert_same(cv.affine_to_jacobian(fl, tx, ty, tinf), jcv.affine_to_jacobian(jfl, jx, jy, jinf))
    tables = cv.build_tables_device(fl, tx, ty, tinf, entries=17)
    _assert_same(tables, jcv.build_tables_device(jfl, jx, jy, jinf, entries=17))
    assert tw.leaves(tables)[0].shape == (n, k, 17, 52)

    acc = cv.msm_distinct_signed(fl, tx, ty, tinf, torch.from_numpy(mag), torch.from_numpy(sgn))
    jacc = jcv.msm_distinct_signed(jfl, jx, jy, jinf, jnp.asarray(mag), jnp.asarray(sgn))
    _assert_same(acc, jacc)

    x, y, ainf = cv.to_affine(fl, acc)
    got = [None if i else p for p, i in zip(zip(tw.decode_batch(x), tw.decode_batch(y)), ainf.tolist())]
    want = []
    for row, srow in zip(pts, scal):
        tot = None
        for p, s in zip(row, srow):
            tot = spec.add(tot, spec.mul(p, s) if p is not None and s else None)
        want.append(tot)
    assert got == want
    if k == 1:
        assert ainf.tolist() == [False, True, True]


# --- the encoder and the fused program --------------------------------------


def test_encoder_matches_jax(mixed, port_backend):
    """Window 6, int16 wire on both sides: the same operand tuple, leaf for
    leaf (dtype, shape, values)."""
    params, vk, proofs, rmsgs, challenges, _ = mixed
    jops = JaxBackend().encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
    pops = port_backend.encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
    assert len(pops) == len(jops) == 19
    pl, jl = tw.leaves(pops), tw.leaves(_tuple_tree(jops))
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        assert p.numpy().dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p.numpy(), j)
    assert pops[5].shape == (B, 1, 52) and pops[5].dtype == torch.uint8  # challenge digits
    assert pops[1].shape == (B, 3, 43) and pops[12].shape == (B, 5, 43)


def test_jax_operands_through_port_fused_show_verify(mixed):
    params, vk, proofs, rmsgs, challenges, expect = mixed
    jops = JaxBackend().encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
    tops = operands_from_numpy(_tuple_tree(jops), CPU)
    assert tops[3][0][0].dtype == torch.int16
    assert fused_show_verify(True, *tops).tolist() == expect


def test_batch_show_verify_matches_spec(mixed, port_backend):
    params, vk, proofs, rmsgs, challenges, expect = mixed
    plain = cuda_fp.PLAIN_CALLS
    got = port_backend.batch_show_verify(proofs, vk, params, rmsgs, challenges)
    assert cuda_fp.PLAIN_CALLS > plain  # CPU tensors: the plain path
    spec = [p.verify(vk, params, rm, c) for p, rm, c in zip(proofs, rmsgs, challenges)]
    assert got == spec == expect


def test_ps_batch_show_verify_with_port_backend(mixed, port_backend):
    """The protocol layer recomputes the Fiat-Shamir challenges and hands
    the uniform batch to the port; its bits equal the sequential path."""
    params, vk, proofs, rmsgs, _, expect = mixed
    seq = batch_show_verify(proofs, vk, params, rmsgs)
    got = batch_show_verify(proofs, vk, params, rmsgs, backend=port_backend)
    assert got == seq == expect


def test_show_fixture_and_forgeries_under_the_spec():
    """entry.show_fixture draws the JAX fixture's keys and credentials; its
    proofs hold under the spec verifier, and each of forge_shows' four kinds
    of lane fails there (the port's verdicts on each kind are held against
    the spec on the mixed batch above)."""
    params, _, vk, proofs, rmsgs, challenges = entry.show_fixture(4)
    jparams, _, jvk, _, _ = graft._fixture(batch=4)
    assert (params.g, params.g_tilde) == (jparams.g, jparams.g_tilde)
    assert (vk.X_tilde, vk.Y_tilde) == (jvk.X_tilde, jvk.Y_tilde)
    assert all(p.revealed_msg_indices == set(REVEALED) for p in proofs)
    spec = [_spec(p).verify(jvk, jparams, rm, c) for p, rm, c in zip(proofs, rmsgs, challenges)]
    assert spec == [True] * 4
    fproofs, frmsgs, expect = entry.forge_shows(params, proofs, rmsgs, every=1)
    assert expect == [False] * 4
    spec = [_spec(p).verify(jvk, jparams, rm, c) for p, rm, c in zip(fproofs, frmsgs, challenges)]
    assert spec == expect


def test_static_operand_cache_keys_on_kind_and_revealed_set():
    """Verify, then show, then show with another revealed set under one
    verkey: each builds its own cache entry (the reference's key), each
    gives the expected bits, and a repeat is a hit."""
    params, _, vk, sigs, msgs = entry.fixture(2)
    sigs, msgs, vexpect = entry.forge(params, sigs, msgs, every=2)
    be = TorchBackend(device="cpu", comb_window=4)
    assert be.batch_verify(sigs, msgs, vk, params) == vexpect
    assert (be.encode_cache_misses, be.encode_cache_hits) == (1, 0)
    for n, revealed in enumerate([REVEALED, (0, 5)], start=2):
        _, _, _, proofs, rmsgs, challenges = entry.show_fixture(2, revealed=revealed)
        proofs, rmsgs, expect = entry.forge_shows(params, proofs, rmsgs, every=2)
        assert be.batch_show_verify(proofs, vk, params, rmsgs, challenges) == expect
        assert expect == [True, False]
        assert (be.encode_cache_misses, be.encode_cache_hits) == (n, 0)
    ops = be.encode_show_verify_batch(proofs, vk, params, rmsgs, challenges)
    assert (be.encode_cache_misses, be.encode_cache_hits) == (3, 1)
    assert tw.leaves(ops[0])[0].shape[0] == 1 + 4  # g_tilde + the 4 hidden Y_tilde
    assert be.batch_show_verify([], vk, params, [], []) == []


def test_g2_show_batch_matches_spec(port_backend):
    """The G2 show path: B = 2 shows under the G2 assignment made by the
    JAX package's prover (pok_sig.show, Fiat-Shamir challenges) of
    entry.fixture(ctx="G2")'s credentials, lane 1's revealed value bumped.
    The port's bits (window 6, int16 wire) equal the JAX package's
    sequential spec verify."""
    from coconut_tpu.params import GroupContext as SpecContext, Params as SpecParams
    from coconut_tpu.signature import Signature as SpecSignature, Verkey as SpecVerkey

    params, _, vk, sigs, msgs = entry.fixture(2, ctx="G2")
    jparams = SpecParams(params.g, params.g_tilde, params.h, SpecContext("G2"))
    jvk = SpecVerkey(vk.X_tilde, vk.Y_tilde)
    shows = [
        pok_sig.show(SpecSignature(s.sigma_1, s.sigma_2), jvk, jparams, m, set(REVEALED))
        for s, m in zip(sigs, msgs)
    ]
    proofs, challenges = [s[0] for s in shows], [s[1] for s in shows]
    rmsgs = [dict(s[2]) for s in shows]
    rmsgs[1][2] = (rmsgs[1][2] + 1) % R
    want = batch_show_verify(proofs, jvk, jparams, rmsgs, challenges)
    assert want == [True, False]
    assert port_backend.batch_show_verify(proofs, jvk, jparams, rmsgs, challenges) == want


_heavy_skip = pytest.mark.skipif(
    os.environ.get("COCONUT_TEST_HEAVY") != "1",
    reason="multi-minute XLA compile of the whole show program on the CPU; "
    "set COCONUT_TEST_HEAVY=1",
)


@pytest.mark.heavy
@_heavy_skip
def test_jax_backend_batch_show_verify_matches_port(mixed, port_backend):
    params, vk, proofs, rmsgs, challenges, expect = mixed
    n = 4
    args = (proofs[:n], vk, params, rmsgs[:n], challenges[:n])
    jax_bits = JaxBackend().batch_show_verify(*args)
    assert port_backend.batch_show_verify(*args) == [bool(b) for b in jax_bits] == expect[:n]


@pytest.mark.parametrize("ctx", ["G1", "G2"])
def test_fixture_fixed_base_tables_give_the_plain_products(monkeypatch, ctx):
    """entry's fixed-base tables (used from FIXED_BASE_MIN products on one
    base) give the points of the plain scalar multiplication, for scalars
    at and past the byte and group-order edges, and the fixtures made with
    them equal those made without."""
    from coconut_tpu_torch.ops.curve import G1_GEN as PG1, G2_GEN as PG2, g1 as pg1, g2 as pg2

    group, gen = (pg1, PG1) if ctx == "G1" else (pg2, PG2)
    table = entry._FixedBase(group, gen)
    rng = random.Random(0xF1B)
    for k in (0, 1, 255, 256, 1 << 248, R - 1, R, R + 5, rng.randrange(R), rng.randrange(R * R)):
        assert table.mul(k) == group.mul(gen, k % R)

    def points(fix):
        _, _, vk, sigs, _ = fix
        return vk.X_tilde, vk.Y_tilde, [(s.sigma_1, s.sigma_2) for s in sigs]

    def shows(fix):
        return [(p.sigma_prime_1, p.sigma_prime_2, p.J, p.proof_vc.t, p.proof_vc.responses)
                for p in fix[3]] + [fix[5]]

    plain = points(entry.fixture(3, msg_count=2, ctx=ctx))
    plain_shows = shows(entry.show_fixture(2)) if ctx == "G1" else None
    monkeypatch.setattr(entry, "FIXED_BASE_MIN", 1)
    assert points(entry.fixture(3, msg_count=2, ctx=ctx)) == plain
    if ctx == "G1":
        assert shows(entry.show_fixture(2)) == plain_shows
