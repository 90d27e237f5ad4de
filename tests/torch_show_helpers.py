"""Helpers shared by the port's show-prover tests (tests/test_torch_prove.py,
tests/test_torch_show_g2.py and the card tests in tests/test_torch_gpu.py).

The card tests run where JAX is not installed, so the helpers that build
the JAX package's objects import it when they are called, not here.
"""

import random
import secrets

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more. Autouse in every module
    that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_randbelow(monkeypatch, seed):
    """Patch secrets.randbelow, which both packages' rand_fr call, with a
    seeded sequence."""
    monkeypatch.setattr(secrets, "randbelow", random.Random(seed).randrange)


def as_jax(params, vk, sigs):
    """The port's holders -> the JAX package's own objects (same points)."""
    from coconut_tpu.params import GroupContext, Params
    from coconut_tpu.signature import Signature, Verkey

    jparams = Params(params.g, params.g_tilde, params.h, GroupContext(params.ctx.name))
    return jparams, Verkey(vk.X_tilde, vk.Y_tilde), [
        Signature(s.sigma_1, s.sigma_2) for s in sigs
    ]


def spec_proof(p):
    """Any proof with the port's fields -> the JAX package's own object."""
    from coconut_tpu.pok_vc import Proof
    from coconut_tpu.ps import PoKOfSignatureProof

    return PoKOfSignatureProof(
        p.sigma_prime_1, p.sigma_prime_2, p.J,
        Proof(p.proof_vc.t, p.proof_vc.responses), p.revealed_msg_indices,
    )


def fields_of(p):
    """A shown credential's fields, comparable across the two packages."""
    return (
        p.sigma_prime_1, p.sigma_prime_2, p.J, p.proof_vc.t, p.proof_vc.responses,
        p.revealed_msg_indices,
    )
