"""The port's show prover (BASELINE config 3, "prove + verify") against the
JAX package on the CPU: the packed readback (`gpu/fp.pack_canon48` and the
uint8 decode), the GLV split, the Fiat-Shamir hash, the host spec pairing
and tower, every CurveBackend MSM primitive of `TorchBackend` against
`coconut_tpu.backend.PythonBackend`, the spec and batched provers with one
seeded draw against `coconut_tpu.pok_sig`, the show-verify with recomputed
challenges, and a batch that mixes revealed-index sets. The G2 assignment's
show family is in tests/test_torch_show_g2.py.

Shapes are tiny (B <= 4, 4 attributes, comb window 4). Both packages'
`rand_fr` draw from `secrets.randbelow`, which the tests patch with one
seeded sequence. Tolerance: exact — bytes, limbs, points, challenges and
verdict bits must be equal.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coconut_tpu import pok_sig as jpok, ps as jps
from coconut_tpu.backend import PythonBackend
from coconut_tpu.ops import fields as jfields
from coconut_tpu.ops import hashing as jhash
from coconut_tpu.ops import pairing as jpairing
from coconut_tpu.signature import fiat_shamir_challenge as jfs
from coconut_tpu.tpu import fp as jfp
from coconut_tpu.tpu import glv as jglv
from coconut_tpu.tpu import limbs as jlimbs
from coconut_tpu_torch import entry, pok_sig, ps
from coconut_tpu_torch.gpu import cuda_fp, fp, glv
from coconut_tpu_torch.gpu import curve as cv
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.gpu.limbs import fp_decode_batch
from coconut_tpu_torch.ops import fields, hashing, pairing
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import P, R
from coconut_tpu_torch.signature import fiat_shamir_challenge
from torch_show_helpers import (  # noqa: F401 (two_torch_threads: autouse)
    as_jax, fields_of, seeded_randbelow, spec_proof, two_torch_threads,
)

REVEALED = {2, 3}
MSGS = 4


@pytest.fixture(scope="module")
def backend():
    return TorchBackend(device="cpu", comb_window=4)


# --- the packed readback ------------------------------------------------------


def _lazy_rows(rng, n):
    """Lazy limb rows with |value| < 2p and |limbs| <= 400: random values of
    either sign in carry-shuffled digits, then the bound's edges."""
    rows = []
    for _ in range(n):
        v = rng.randrange(-2 * P + 1, 2 * P)
        # a representation of v with limbs in [0, 400] times its sign: the
        # digits of |v| with 256 moved down from a random neighbour
        d, x = [], abs(v)
        for _ in range(52):
            d.append(x % 256)
            x //= 256
        for i in range(51):
            if d[i + 1] > 0 and d[i] < 145 and rng.random() < 0.5:
                d[i] += 256
                d[i + 1] -= 1
        sign = -1 if v < 0 else 1
        rows.append(np.array([sign * c for c in d], dtype=np.float32))
    edges = [np.zeros(52, np.float32)]
    for v in (2 * P - 1, -(2 * P - 1), 1, -1, P, -P):
        edges.append(np.array([(abs(v) >> (8 * i)) & 255 for i in range(52)], np.float32) * (1 if v > 0 else -1))
    row = np.zeros(52, np.float32)
    row[:47] = 400.0  # every limb at the bound, value far below 2p
    edges += [row, -row]
    return np.stack(rows + edges)


def test_pack_canon48_matches_jax_on_lazy_limbs():
    """Random lazy rows of both signs and the bound's edges (+-(2p-1), +-p,
    +-1, 0, limbs at +-400): byte-equal to the JAX package's pack, and the
    decode gives the value mod p."""
    rows = _lazy_rows(random.Random(0xCA7), 64)
    got = fp.pack_canon48(torch.from_numpy(rows))
    assert got.dtype == torch.uint8 and got.shape == (rows.shape[0], 48)
    want = np.asarray(jfp.pack_canon48(jnp.asarray(rows)))
    np.testing.assert_array_equal(got.numpy(), want)
    rinv = pow(1 << 416, -1, P)
    values = [sum(int(v) << (8 * i) for i, v in enumerate(r)) for r in rows]
    assert fp_decode_batch(got.numpy()) == [v * rinv % P for v in values]


@pytest.mark.parametrize("group", ["FP", "FP2"])
def test_pack_canon48_on_affine_outputs(group, backend):
    """to_affine outputs of points with a nontrivial Z (doubled, then added)
    keep pack_canon48's contract (|limb| <= 396, |value| < 2p); the packed
    bytes equal the JAX package's, and the uint8 decode (port and JAX)
    gives the spec's affine points."""
    spec, gen, fl = (g1, G1_GEN, cv.FP) if group == "FP" else (g2, G2_GEN, cv.FP2)
    rng = random.Random(0xAFF)
    pts = [spec.mul(gen, rng.randrange(1, R)) for _ in range(3)]
    x, y = tw.encode_batch([p[0] for p in pts], "cpu"), tw.encode_batch([p[1] for p in pts], "cpu")
    jac = cv.affine_to_jacobian(fl, x, y, torch.zeros(3, dtype=torch.bool))
    jac = cv.jadd(fl, cv.jdouble(fl, jac), jac)  # 3P
    ax, ay, inf = cv.to_affine(fl, jac)
    assert not inf.any()
    leaves = tw.leaves((ax, ay))
    for t in leaves:
        assert float(t.abs().max()) <= 396
        for row in t.numpy():
            assert abs(sum(int(v) << (8 * i) for i, v in enumerate(row))) < 2 * P
    packed = [fp.pack_canon48(t) for t in leaves]
    for t, pk in zip(leaves, packed):
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jfp.pack_canon48(jnp.asarray(t.numpy()))))
        assert fp_decode_batch(pk.numpy()) == jlimbs.fp_decode_batch(pk.numpy())
    it = iter(packed)
    got = tw.decode_batch(tw.tree_map(lambda _: next(it), (ax, ay)))
    assert got == [spec.mul(p, 3) for p in pts]


def test_uint8_decode_matches_jax():
    """Random 48-byte rows (any digits, values up to 2^384): the port's
    uint8 decode equals the JAX package's, element for element."""
    rows = np.random.default_rng(5).integers(0, 256, size=(2, 3, 48), dtype=np.uint8)
    assert fp_decode_batch(rows) == jlimbs.fp_decode_batch(rows)
    assert tw.decode_batch(torch.from_numpy(rows)) == jlimbs.fp_decode_batch(rows)


# --- GLV, hashing, the host spec ------------------------------------------------


def test_glv_matches_jax():
    rng = random.Random(0x61)
    assert (glv.LAMBDA, glv.BETA, glv.HALF_BITS) == (jglv.LAMBDA, jglv.BETA, jglv.HALF_BITS)
    ks = [0, 1, R - 1, glv.LAMBDA, glv.LAMBDA - 1, R + 5] + [rng.randrange(R) for _ in range(20)]
    for k in ks:
        k1, k2 = glv.decompose(k)
        assert (k1, k2) == jglv.decompose(k)
        assert 0 <= k1 < 1 << 128 and 0 <= k2 < 1 << 128
        assert (k1 + k2 * glv.LAMBDA - k) % R == 0
    p = g1.mul(G1_GEN, rng.randrange(1, R))
    assert glv.phi(p) == jglv.phi(p) == g1.mul(p, glv.LAMBDA)
    assert glv.phi(None) is None and glv.decompose(0) == (0, 0)


def test_hash_to_fr_and_challenge_match_jax():
    rng = random.Random(0x4A5)
    msgs = [b"", b"abc", bytes(rng.randrange(256) for _ in range(1000))]
    for m in msgs:
        assert hashing.expand_message_xmd(m, hashing.DST_FR, 64) == jhash.expand_message_xmd(m, jhash.DST_FR, 64)
        assert hashing.hash_to_fr(m) == jhash.hash_to_fr(m)
        assert fiat_shamir_challenge(m) == jfs(m)
    assert hashing.DST_FR == jhash.DST_FR


def test_host_spec_pairing_and_tower_match_jax():
    """The port's host Fp12 arithmetic and pairing check against the JAX
    package's spec: e(aP, bQ) * e(-abP, Q) == 1, a tampered product is
    not, and the Miller values and final exponentiation are equal."""
    rng = random.Random(0x9A1)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    P1, Q2 = g1.mul(G1_GEN, a), g2.mul(G2_GEN, b)
    f = pairing.miller_loop_projective(P1, Q2)
    assert f == jpairing.miller_loop_projective(P1, Q2)
    assert pairing.final_exp(f) == jpairing.final_exp(f)
    assert fields.fp12_inv(f) == jfields.fp12_inv(f)
    assert fields.fp12_frobenius(f) == jfields.fp12_frobenius(f)
    good = [(P1, Q2), (g1.neg(g1.mul(G1_GEN, a * b % R)), G2_GEN)]
    bad = [(P1, Q2), (g1.neg(g1.mul(G1_GEN, a * b % R + 1)), G2_GEN)]
    assert pairing.pairing_check(good) and jpairing.pairing_check(good)
    assert not pairing.pairing_check(bad) and not jpairing.pairing_check(bad)
    assert pairing.pairing_check([(None, Q2), (P1, None)])


# --- the CurveBackend MSM primitives ---------------------------------------------


def _msm_inputs(group, seed):
    spec, gen = (g1, G1_GEN) if group == "G1" else (g2, G2_GEN)
    rng = random.Random(seed)
    pts = lambda n: [spec.mul(gen, rng.randrange(1, R)) for _ in range(n)]
    bases = pts(3)
    bases[1] = None  # an identity base
    scalars = [[rng.randrange(R) for _ in range(3)] for _ in range(3)]
    scalars[1] = [0, 0, 0]  # an all-zero row: the identity
    scalars[2][2] = 0
    rows = [pts(2) for _ in range(3)]
    rows[0][1] = None  # an identity point
    return bases, scalars, rows


@pytest.mark.parametrize("group", ["G1", "G2"])
@pytest.mark.parametrize("kind", ["shared", "shared_many", "distinct"])
def test_msm_primitives_match_python_backend(group, kind, backend):
    """Each primitive (sync and async + wait) against PythonBackend's, point
    for point, with an identity base, an identity point, zero scalars and an
    all-zero row; the CPU runs the plain multiply."""
    g = group.lower()
    bases, scalars, rows = _msm_inputs(group, 0x3A + (group == "G2"))
    ref = PythonBackend()
    plain = cuda_fp.PLAIN_CALLS
    if kind == "shared":
        got = getattr(backend, "msm_%s_shared" % g)(bases, scalars)
        want = getattr(ref, "msm_%s_shared" % g)(bases, scalars)
        assert want[1] is None
    elif kind == "shared_many":
        jobs = [(bases, scalars), (bases[::-1], scalars[::-1]), (bases[:2], [s[:2] for s in scalars])]
        handle = getattr(backend, "msm_%s_shared_many_async" % g)(jobs)
        got = backend.msm_shared_many_wait(handle)
        assert getattr(backend, "msm_%s_shared_many" % g)(jobs) == got
        want = [getattr(ref, "msm_%s_shared" % g)(b, s) for b, s in jobs]
    else:
        sc = [s[:2] for s in scalars]
        handle = getattr(backend, "msm_%s_distinct_async" % g)(rows, sc)
        got = backend.msm_distinct_wait(handle)
        want = getattr(ref, "msm_%s_distinct" % g)(rows, sc)
        assert want[1] is None
    assert got == want
    assert cuda_fp.PLAIN_CALLS > plain
    if kind == "distinct":
        with pytest.raises(ValueError, match="ragged distinct-MSM"):
            getattr(backend, "msm_%s_distinct" % g)([rows[0], rows[1][:1]], [sc[0], sc[1][:1]])


# --- the provers -------------------------------------------------------------------


def test_spec_show_matches_jax(monkeypatch):
    """pok_sig.show on the host spec, one seeded draw in both packages: the
    same proof, challenge, revealed map and wire bytes; show_verify passes
    with the challenge recomputed and fails with a wrong one."""
    params, _, vk, sigs, msgs = entry.fixture(1, msg_count=MSGS)
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    seeded_randbelow(monkeypatch, 3)
    proof, c, rm = pok_sig.show(sigs[0], vk, params, msgs[0], REVEALED)
    seeded_randbelow(monkeypatch, 3)
    jproof, jc, jrm = jpok.show(jsigs[0], jvk, jparams, msgs[0], REVEALED)
    assert fields_of(proof) == fields_of(jproof) and (c, rm) == (jc, jrm)
    assert proof.to_bytes(params.ctx) == jproof.to_bytes(jparams.ctx)
    assert proof.to_bytes_for_challenge(vk, params) == jproof.to_bytes_for_challenge(jvk, jparams)
    assert fiat_shamir_challenge(proof.to_bytes_for_challenge(vk, params)) == c
    assert pok_sig.show_verify(proof, vk, params, rm) is True
    assert pok_sig.show_verify(proof, vk, params, rm, challenge=c + 1) is False


def test_batch_show_matches_jax(monkeypatch, backend):
    """B = 3 under G1, revealing {2, 3}: TorchBackend's batch_show and the JAX package's batch_show on PythonBackend, one seeded
    draw, give equal proofs, challenges and revealed maps; every proof
    passes the port's spec verifier with the challenge recomputed."""
    params, _, vk, sigs, msgs = entry.fixture(3, msg_count=MSGS)
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    seeded_randbelow(monkeypatch, 11)
    plain = cuda_fp.PLAIN_CALLS
    proofs, chals, rms = pok_sig.batch_show(sigs, vk, params, msgs, REVEALED, backend)
    assert cuda_fp.PLAIN_CALLS > plain
    seeded_randbelow(monkeypatch, 11)
    jproofs, jchals, jrms = jpok.batch_show(jsigs, jvk, jparams, msgs, REVEALED, backend="python")
    assert [fields_of(p) for p in proofs] == [fields_of(p) for p in jproofs]
    assert chals == jchals and rms == jrms
    assert [pok_sig.show_verify(p, vk, params, rm) for p, rm in zip(proofs, rms)] == [True] * 3


@pytest.fixture(scope="module")
def proved():
    """B = 4 proofs of the batched prover (CPU, window 4), lanes 1 and 3
    forged (a wrong revealed value, a corrupted response), as the port's
    holders and as the JAX package's objects."""
    params, _, vk, sigs, msgs = entry.fixture(4, msg_count=MSGS)
    be = TorchBackend(device="cpu", comb_window=4)
    proofs, _, rms = pok_sig.batch_show(sigs, vk, params, msgs, REVEALED, be)
    proofs, rms, expect = entry.forge_shows(params, proofs, rms, every=2)
    jparams, jvk, _ = as_jax(params, vk, sigs)
    return params, vk, proofs, rms, expect, jparams, jvk, be, sigs, msgs


@pytest.mark.parametrize("mode", ["exact", "batched"])
def test_fs_show_verify_matches_jax(mode, proved):
    """ps.batch_show_verify with challenges=None on honest and forged proofs
    made by the prover: the port's bits equal coconut_tpu.ps's (its spec
    path, challenges recomputed too) and the expected verdicts."""
    params, vk, proofs, rms, expect, jparams, jvk, be, _, _ = proved
    want = jps.batch_show_verify([spec_proof(p) for p in proofs], jvk, jparams, rms)
    got = ps.batch_show_verify(proofs, vk, params, rms, backend=be, mode=mode)
    assert got == want == expect == [True, False, True, False]


def test_ragged_batch_goes_proof_by_proof(monkeypatch, proved):
    """A batch mixing revealed sets {2, 3} and {0, 1}, one forged: the port
    verifies it proof by proof with the spec (the backend is never called),
    its bits equal coconut_tpu.ps's, and the counters read 1 and 4, in
    exact and batched mode."""
    params, vk, proofs, rms, _, jparams, jvk, _, sigs, msgs = proved
    extra = [pok_sig.show(s, vk, params, m, {0, 1}) for s, m in zip(sigs[:2], msgs[:2])]
    batch = [proofs[0], extra[0][0], proofs[1], extra[1][0]]
    brms = [rms[0], extra[0][2], rms[1], extra[1][2]]
    want = jps.batch_show_verify([spec_proof(p) for p in batch], jvk, jparams, brms)
    assert want == [True, True, False, True]

    class NoDevice:
        def __getattr__(self, name):
            raise AssertionError("the backend was called: %s" % name)

    for mode in ("exact", "batched"):
        ps.COUNTS.clear()
        got = ps.batch_show_verify(batch, vk, params, brms, backend=NoDevice(), mode=mode)
        assert got == want
        assert dict(ps.COUNTS) == {"show_verify_ragged_fallback": 1, "show_verify_ragged_proofs": 4}
    ps.COUNTS.clear()
    assert ps.batch_show_verify(batch, vk, params, brms, backend=ps.SPEC) == want
    assert not ps.COUNTS  # the spec path asked for by name: not counted


def test_entry_points_default_to_the_card(monkeypatch, proved):
    """Without a card, the prover and the show verifier raise unless the
    caller names a backend: `None` is a TorchBackend on `cuda`, and the
    host spec path is asked for as ps.SPEC. batch_verify takes no default
    backend."""
    params, vk, proofs, rms, expect, _, _, _, sigs, msgs = proved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pok_sig.batch_show(sigs[:1], vk, params, msgs[:1], REVEALED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.batch_show_verify(proofs, vk, params, rms)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.batch_show_verify([], vk, params, [], mode="batched")
    with pytest.raises(TypeError):
        ps.batch_verify(sigs, msgs, vk, params)
    assert ps.batch_show_verify(proofs[:2], vk, params, rms[:2], backend=ps.SPEC) == expect[:2]
    got = pok_sig.batch_show(sigs[:1], vk, params, msgs[:1], REVEALED, backend=ps.SPEC)
    assert pok_sig.show_verify(got[0][0], vk, params, got[2][0]) is True
