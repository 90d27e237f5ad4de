"""Known-answer vectors replayed against the port, test for test as
tests/test_vectors.py replays them against the JAX package: the port's
host spec (`ops/`), its protocol holders, and its native binding
(`native.py`) read the same committed files (tests/vectors/*.json).

Also here, the spec functions the port copied last (`ops/fields.py`'s
Fr, Fp6 and Fp12 leftovers, `ops/pairing.py`'s affine Miller loop,
untwist and final-exponentiation oracles, `gpu/limbs.py`'s
COCONUT_DEBUG_PACK check), each against the JAX package's on the same
inputs drawn from a numpy seed. Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from coconut_tpu.ops import fields as jfields
from coconut_tpu.ops import pairing as jpairing
from coconut_tpu_torch import native
from coconut_tpu_torch.gpu import backend as gbackend
from coconut_tpu_torch.gpu import limbs
from coconut_tpu_torch.ops import fields
from coconut_tpu_torch.ops import pairing
from coconut_tpu_torch.ops import serialize as ser
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import P, R
from coconut_tpu_torch.ops.hashing import expand_message_xmd, hash_to_fr, hash_to_g1, hash_to_g2
from coconut_tpu_torch.params import Params
from coconut_tpu_torch.ps import ps_verify
from coconut_tpu_torch.signature import Signature, Verkey

VECDIR = os.path.join(os.path.dirname(__file__), "vectors")


def load(name):
    with open(os.path.join(VECDIR, name)) as f:
        return json.load(f)


def _flat(x):
    out = []

    def rec(t):
        if isinstance(t, tuple):
            for u in t:
                rec(u)
        else:
            out.append(hex(t))

    rec(x)
    return out


# --- the vectors -------------------------------------------------------------


def test_field_vectors():
    v = load("fields.json")
    assert hex(P) == v["p"] and hex(R) == v["r"]
    for c in v["fp_cases"]:
        a, b = int(c["a"], 16), int(c["b"], 16)
        assert hex(fields.fp_add(a, b)) == c["add"]
        assert hex(fields.fp_mul(a, b)) == c["mul"]
        assert hex(fields.fp_inv(a)) == c["inv_a"]


def test_expand_message_xmd_vectors():
    for c in load("hashing.json")["expand_message_xmd"]:
        got = expand_message_xmd(bytes.fromhex(c["msg"]), bytes.fromhex(c["dst"]), c["len"])
        assert got.hex() == c["out"]


def test_hash_to_fr_vectors():
    for c in load("hashing.json")["hash_to_fr"]:
        assert hex(hash_to_fr(bytes.fromhex(c["msg"]))) == c["fr"]


def test_hash_to_group_vectors():
    v = load("hashing.json")
    for c in v["hash_to_g1"]:
        assert ser.g1_to_compressed(hash_to_g1(bytes.fromhex(c["msg"]))).hex() == c["point"]
    for c in v["hash_to_g2"]:
        assert ser.g2_to_compressed(hash_to_g2(bytes.fromhex(c["msg"]))).hex() == c["point"]


def test_native_hashing_matches_vectors():
    """The native core's hashing and its Params derivation against the same
    vectors."""
    v = load("hashing.json")
    for c in v["hash_to_fr"]:
        assert hex(native.hash_to_fr(bytes.fromhex(c["msg"]))) == c["fr"]
    for c in v["hash_to_g1"]:
        got = ser.g1_to_compressed(native.hash_to_g1(bytes.fromhex(c["msg"])))
        assert got.hex() == c["point"]
    msgs = [bytes.fromhex(c["msg"]) for c in v["hash_to_g1"]]
    assert [ser.g1_to_compressed(p).hex() for p in native.hash_to_g1_batch(msgs)] == [
        c["point"] for c in v["hash_to_g1"]
    ]
    for c in v["hash_to_g2"]:
        got = ser.g2_to_compressed(native.hash_to_g2(bytes.fromhex(c["msg"])))
        assert got.hex() == c["point"]
    pv = load("params.json")
    g, gt, hs = native.derive_params(pv["msg_count"], bytes.fromhex(pv["label"]))
    assert Params(g, gt, hs).to_bytes().hex() == pv["blob"]


def test_params_blob_vector():
    v = load("params.json")
    params = Params.new(v["msg_count"], bytes.fromhex(v["label"]))
    assert params.to_bytes().hex() == v["blob"]
    assert Params.from_bytes(bytes.fromhex(v["blob"])) == params


def test_curve_vectors():
    for c in load("curve.json")["cases"]:
        a, b = int(c["a"], 16), int(c["b"], 16)
        pa, pb = g1.mul(G1_GEN, a), g1.mul(G1_GEN, b)
        assert ser.g1_to_bytes(pa).hex() == c["g1_a"]
        assert ser.g1_to_bytes(g1.add(pa, pb)).hex() == c["g1_add"]
        assert ser.g1_to_bytes(g1.msm([pa, pb], [b, a])).hex() == c["g1_msm"]
        assert ser.g2_to_bytes(g2.mul(G2_GEN, a)).hex() == c["g2_a"]


def test_pairing_vectors():
    v = load("pairing.json")
    a, b = int(v["a"], 16), int(v["b"], 16)
    assert _flat(pairing.pairing(g1.mul(G1_GEN, a), g2.mul(G2_GEN, b))) == v["e_aG1_bG2"]
    assert _flat(pairing.pairing(G1_GEN, G2_GEN)) == v["e_G1_G2"]
    assert v["e_aG1_bG2"] == v["bilinearity_ab"]


def test_transcript_vector():
    v = load("transcript.json")
    params = Params.new(len(v["msgs"]), bytes.fromhex(v["label"]))
    vk = Verkey.from_bytes(bytes.fromhex(v["vk"]), params.ctx)
    sig = Signature.from_bytes(bytes.fromhex(v["sig"]), params.ctx)
    assert ps_verify(sig, [int(m, 16) for m in v["msgs"]], vk, params) is v["verifies"]
    assert ps_verify(sig, [int(m, 16) for m in v["bad_msgs"]], vk, params) is v["bad_verifies"]


# --- the spec leftovers against the JAX package's ------------------------------


def _ints(rng, n, mod):
    return [int.from_bytes(rng.bytes(48), "little") % mod for _ in range(n)]


def _fp12(rng):
    c = iter(_ints(rng, 12, P))
    return tuple(tuple(tuple((next(c), next(c)) for _ in range(3))) for _ in range(2))


def test_field_leftovers_match_the_reference():
    rng = np.random.default_rng(0xF1)
    a, b = _ints(rng, 2, R)
    for name in ("fr_add", "fr_sub"):
        assert getattr(fields, name)(a, b) == getattr(jfields, name)(a, b)
    assert fields.fr_neg(a) == jfields.fr_neg(a) and fields.fr_neg(0) == 0
    x, y = _fp12(rng), _fp12(rng)
    for name in ("fp12_add", "fp12_sub"):
        assert getattr(fields, name)(x, y) == getattr(jfields, name)(x, y)
    assert fields.fp12_sub(x, x) == fields.FP12_ZERO == jfields.FP12_ZERO
    for e in (0, 1, 5, -3, (1 << 70) + 11):
        assert fields.fp12_pow(x, e) == jfields.fp12_pow(x, e)
    s = tuple(_ints(rng, 2, P))
    assert fields.fp6_mul_fp2(x[0], s) == jfields.fp6_mul_fp2(x[0], s)


def test_pairing_leftovers_match_the_reference():
    """untwist, the affine Miller loop, the two final-exponentiation
    oracles and `pairing`, each against the JAX package's; the affine loop
    and the projective one agree after the final exponentiation."""
    rng = np.random.default_rng(0xE2)
    a, b = _ints(rng, 2, R)
    p1, q2 = g1.mul(G1_GEN, a), g2.mul(G2_GEN, b)
    assert pairing.untwist(q2) == jpairing.untwist(q2)
    f = pairing.miller_loop(p1, q2)
    assert f == jpairing.miller_loop(p1, q2)
    assert pairing.final_exp(f) == pairing.final_exp(pairing.miller_loop_projective(p1, q2))
    assert pairing.miller_loop(None, q2) == pairing.miller_loop(p1, None) == fields.FP12_ONE
    x = _fp12(rng)
    want = jpairing.final_exp(x)
    assert pairing.final_exp_chain(x) == jpairing.final_exp_chain(x) == want
    assert pairing.final_exp_slow(x) == want
    assert pairing.pairing(p1, q2) == jpairing.pairing(p1, q2)
    assert pairing.pairing(None, q2) == fields.FP12_ONE


def test_pack_debug_check_raises_at_the_decode(monkeypatch):
    """COCONUT_DEBUG_PACK=1: a packed leaf past the |v| <= 396 bound is
    recorded by _pack_pts and raised (once) at the next decode; within the
    bound, and with the flag off, nothing is recorded."""
    monkeypatch.setattr(limbs, "PACK_DEBUG_VIOLATIONS", [])
    ok = torch.tensor(limbs.fp_encode_batch([3, 5]), dtype=torch.float32)
    wide = ok.clone()
    wide[0, 0] = 500.0
    monkeypatch.delenv("COCONUT_DEBUG_PACK", raising=False)
    gbackend._pack_pts((wide, ok))
    assert limbs.PACK_DEBUG_VIOLATIONS == []
    monkeypatch.setenv("COCONUT_DEBUG_PACK", "1")
    packed = gbackend._pack_pts((ok, ok))
    assert limbs.PACK_DEBUG_VIOLATIONS == []
    assert limbs.fp_decode_batch(packed[0].numpy()) == [3, 5]
    gbackend._pack_pts((ok, wide))
    assert limbs.PACK_DEBUG_VIOLATIONS == [500.0]
    with pytest.raises(AssertionError, match="exceeds the pack bound 396"):
        limbs.fp_decode_batch(packed[0].numpy())
    assert limbs.PACK_DEBUG_VIOLATIONS == []
    assert limbs.fp_decode_batch(packed[0].numpy()) == [3, 5]
