"""The plain reference agrees with the spec at a tiny size: its pairing
checks and its signing-key checks give the verdicts of the port's host
spec (`ps_verify`, `PoKOfSignatureProof.verify`) on honest and forged
credentials and shows, and the frozen arithmetic keeps bilinearity."""

import random

import pytest

from portbench.harness import convert, fixtures
from portbench.reference import checks, curve, pairing
from portbench.reference.fields import FP12_ONE, R


def _forge(m, attr):
    m = list(m)
    m[attr] = (m[attr] + 1) % R
    return m


def test_pairing_is_bilinear():
    a, b = 5, 7
    p, q = curve.g1.mul(curve.G1_GEN, a), curve.g2.mul(curve.G2_GEN, b)
    e1 = pairing.pairing(p, q)
    e2 = pairing.pairing(curve.G1_GEN, curve.g2.mul(curve.G2_GEN, a * b))
    assert e1 == e2 and e1 != FP12_ONE


@pytest.mark.parametrize("attr", [None, 0, 5])
def test_credential_verdicts_match_the_spec(attr):
    from coconut_tpu_torch.ps import ps_verify

    pool = fixtures.credential_pool(2**31 + 3, 2, 6)
    params, vk = convert.params(pool), convert.verkey(pool)
    for (s1, s2, m), logs in zip(pool["creds"], pool["logs"]):
        msgs = m if attr is None else _forge(m, attr)
        want = ps_verify(convert.signature(s1, s2), msgs, vk, params)
        assert want == (attr is None)
        assert checks.ps_verify(s1, s2, msgs, pool["vk"], pool["params"]) == want
        assert checks.ps_verify_exp(logs, msgs, pool["sk"]) == want
    s1, s2, m = pool["creds"][0]
    assert not checks.ps_verify(None, None, m, pool["vk"], pool["params"])
    assert not checks.ps_verify_exp((None, None), m, pool["sk"])


@pytest.mark.parametrize("attr", [None, 2, 5])
def test_show_verdicts_match_the_spec(attr):
    pool = fixtures.show_pool(2**31 + 4, 2, 6, (2, 3, 4, 5))
    params, vk = convert.params(pool), convert.verkey(pool)
    for show, logs in zip(pool["shows"], pool["logs"]):
        s1, s2, J, T, resp, rm, c = show
        if attr is not None:
            rm = dict(rm)
            rm[attr] = (rm[attr] + 1) % R
        proof, _, _ = convert.show_proof((s1, s2, J, T, resp, rm, c), pool["revealed"])
        want = proof.verify(vk, params, rm, c)
        assert want == (attr is None)
        got = checks.show_verify((s1, s2, J, T, resp, rm, c), pool["vk"], pool["params"], pool["hidden"])
        assert got == want
        assert checks.show_verify_exp(logs, resp, rm, c, pool["sk"], pool["hidden"]) == want


def test_show_with_a_bad_response_fails_both_forms():
    pool = fixtures.show_pool(2**31 + 5, 1, 6, (2, 3, 4, 5))
    s1, s2, J, T, resp, rm, c = pool["shows"][0]
    bad = [(resp[0] + 1) % R] + resp[1:]
    assert not checks.show_verify((s1, s2, J, T, bad, rm, c), pool["vk"], pool["params"], pool["hidden"])
    assert not checks.show_verify_exp(pool["logs"][0], bad, rm, c, pool["sk"], pool["hidden"])


def test_fixed_base_equals_plain_multiplication():
    fb = fixtures.FixedBase(curve.g1, curve.G1_GEN)
    rng = random.Random(1)
    for _ in range(3):
        k = rng.randrange(R)
        assert fb.mul(k) == curve.g1.mul(curve.G1_GEN, k)
