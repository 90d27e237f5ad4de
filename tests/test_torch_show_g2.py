"""The port's show family under the G2 signature assignment (signatures and
sigma' in G2; the verkey, g_tilde, J and the Schnorr commitment in G1)
against the JAX package on the CPU: the batched prover with one seeded
draw against `coconut_tpu.pok_sig.batch_show` on PythonBackend, the show
encoder's operands against JaxBackend's, and the exact and combined show
verify against `coconut_tpu.ps`'s sequential spec verify, challenges
recomputed.

Shapes are tiny (B <= 8, 4 attributes, comb window 4 for the programs).
No JAX program but the G1 comb-table build of the JAX encoder is
compiled. Tolerance: exact — points, challenges, limbs and verdict bits
must be equal.
"""


import numpy as np
import pytest
import torch

from coconut_tpu import pok_sig as jpok, ps as jps
from coconut_tpu.tpu.backend import JaxBackend
from coconut_tpu_torch import entry, pok_sig, ps
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend
from torch_show_helpers import (  # noqa: F401 (two_torch_threads: autouse)
    as_jax, fields_of, seeded_randbelow, spec_proof, two_torch_threads,
)

REVEALED = {2, 3}
MSGS = 4


@pytest.fixture(scope="module")
def g2_shows():
    """B = 8 shows under G2 made by the port's batched prover (CPU, window
    4), lanes 1, 3, 5, 7 forged the four ways of entry.forge_shows."""
    params, _, vk, sigs, msgs = entry.fixture(8, msg_count=MSGS, ctx="G2")
    be = TorchBackend(device="cpu", comb_window=4)
    proofs, chals, rms = pok_sig.batch_show(sigs, vk, params, msgs, REVEALED, be)
    fproofs, frms, expect = entry.forge_shows(params, proofs, rms, every=2)
    jparams, jvk, _ = as_jax(params, vk, sigs)
    return params, vk, fproofs, frms, chals, expect, jparams, jvk, be


def test_batch_show_g2_matches_jax(monkeypatch):
    """B = 3 under G2 (the distinct MSM over Fp2 without GLV, the comb MSMs
    over G1): TorchBackend's batch_show and the JAX package's on
    PythonBackend, one seeded draw, give equal proofs, challenges and
    revealed maps, and each proof passes the port's spec verifier."""
    params, _, vk, sigs, msgs = entry.fixture(3, msg_count=MSGS, ctx="G2")
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    be = TorchBackend(device="cpu", comb_window=4)
    seeded_randbelow(monkeypatch, 21)
    plain = cuda_fp.PLAIN_CALLS
    proofs, chals, rms = pok_sig.batch_show(sigs, vk, params, msgs, REVEALED, be)
    assert cuda_fp.PLAIN_CALLS > plain
    seeded_randbelow(monkeypatch, 21)
    jproofs, jchals, jrms = jpok.batch_show(jsigs, jvk, jparams, msgs, REVEALED, backend="python")
    assert [fields_of(p) for p in proofs] == [fields_of(p) for p in jproofs]
    assert chals == jchals and rms == jrms
    assert isinstance(proofs[0].sigma_prime_1[0], tuple) and isinstance(proofs[0].J[0], int)
    assert all(pok_sig.show_verify(p, vk, params, rm) for p, rm in zip(proofs, rms))


def test_g2_show_encoder_matches_jax(g2_shows):
    """Window 6, int16 wire on both sides: JaxBackend's G2 show operands
    equal the port's leaf for leaf (dtype, shape, values); J and t are Fp
    pairs, sigma' Fp2 pairs."""
    params, vk, proofs, rms, chals, _, jparams, jvk, _ = g2_shows
    sproofs = [spec_proof(p) for p in proofs]
    jops = JaxBackend().encode_show_verify_batch(sproofs, jvk, jparams, rms, chals)
    pops = TorchBackend(device="cpu").encode_show_verify_batch(proofs, vk, params, rms, chals)
    pl, jl = tw.leaves(pops), tw.leaves(_tuple_tree(jops))
    assert len(pops) == len(jops) == 19 and len(pl) == len(jl)
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        assert p.numpy().dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p.numpy(), j)
    assert pops[3][0].dtype == torch.int16 and pops[3][0].shape == (8, 52)  # J's x in Fp
    assert pops[13][0][0].shape == (8, 52)  # sigma'_1's x in Fp2


def _tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(_tuple_tree(x) for x in t)
    return t


def test_g2_show_verify_exact_matches_spec(g2_shows):
    """ps.batch_show_verify under G2 with challenges=None, exact mode on the
    backend: the bits equal coconut_tpu.ps's sequential spec verify and the
    expected verdicts; the given challenges give the same bits."""
    params, vk, proofs, rms, chals, expect, jparams, jvk, be = g2_shows
    want = jps.batch_show_verify([spec_proof(p) for p in proofs], jvk, jparams, rms)
    assert want == expect == [True, False] * 4
    assert ps.batch_show_verify(proofs, vk, params, rms, backend=be) == want
    assert be.batch_show_verify(proofs, vk, params, rms, chals) == want


def test_g2_show_verify_combined_matches_spec(g2_shows):
    """The combined show check under G2: on the honest lanes, one combined
    check through ps.batch_show_verify(mode="batched") gives the spec's
    all-true bits; on the forged batch, the backend's Schnorr bits fail
    exactly the corrupted response (lane 3) and the identity sigma' (lane
    7), and the batch's pairing bool is False, as the spec's per-lane
    verdicts imply."""
    params, vk, proofs, rms, chals, expect, jparams, jvk, be = g2_shows
    honest = [0, 2, 4, 6]
    hp, hr = [proofs[i] for i in honest], [rms[i] for i in honest]
    want = jps.batch_show_verify([spec_proof(p) for p in hp], jvk, jparams, hr)
    checks = be.combined_checks
    assert ps.batch_show_verify(hp, vk, params, hr, backend=be, mode="batched") == want == [True] * 4
    assert be.combined_checks == checks + 1
    bits, pair_ok = be.batch_show_verify_combined(proofs, vk, params, rms, chals)
    assert [i for i, b in enumerate(bits) if not b] == [3, 7]
    assert pair_ok is False and not all(expect)
