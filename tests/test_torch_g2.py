"""The port's verify family under the G2 signature assignment (signatures in
G2, verkeys and g_tilde in G1) against the JAX package and the spec, on the
CPU: the G2 fixture, the JAX package's G2 encoder operands equal to the
port's and through the port's fused_verify, and the combined check's
bisection ladder naming the forged lane. The grouped verify's G2 cases are
in tests/test_torch_grouped.py, the combined program's G2 call against
PythonBackend in tests/test_torch_combined.py.

Shapes are tiny (B <= 6, q = 2). No JAX pairing program is compiled; the
JAX G2 encode compiles only its G1 comb-table build.

Tolerance: exact — limbs, dtypes and verdict bits must be equal.
"""

import numpy as np
import pytest
import torch

from coconut_tpu.params import GroupContext as SpecContext, Params as SpecParams
from coconut_tpu.ps import ps_verify
from coconut_tpu.signature import Signature as SpecSignature, Verkey as SpecVerkey
from coconut_tpu.tpu.backend import JaxBackend
from coconut_tpu_torch import entry, ps
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend, fused_verify

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def as_jax(params, vk, sigs):
    """The port's holders -> the JAX package's own objects (same points)."""
    jparams = SpecParams(params.g, params.g_tilde, params.h, SpecContext(params.ctx.name))
    jsigs = [SpecSignature(s.sigma_1, s.sigma_2) for s in sigs]
    return jparams, SpecVerkey(vk.X_tilde, vk.Y_tilde), jsigs


def tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(tuple_tree(x) for x in t)
    return np.asarray(t)


def test_g2_fixture_is_in_the_swapped_groups():
    """entry.fixture(ctx="G2"): g, sigma and h in G2, g_tilde and the verkey
    in G1, and every credential verifies under the spec."""
    params, _, vk, sigs, msgs = entry.fixture(2, msg_count=2, ctx="G2")
    assert params.ctx.name == "G2"
    assert isinstance(params.g[0], tuple) and isinstance(sigs[0].sigma_1[0], tuple)
    assert isinstance(params.g_tilde[0], int) and isinstance(vk.X_tilde[0], int)
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    assert all(ps_verify(s, m, jvk, jparams) for s, m in zip(jsigs, msgs))


def test_jax_g2_operands_through_port_fused_verify():
    """B = 6 under G2 with lanes 1 (sigma_2 doubled), 3 (wrong message) and
    5 (identity sigma_1) forged: the JAX package's encode_verify_batch
    operands equal the port's own, leaf for leaf (window 6, int16 wire),
    and through the port's fused_verify give the spec's bits."""
    params, _, vk, sigs, msgs = entry.fixture(6, msg_count=2, ctx="G2")
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=2)
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    jops = operands_from_numpy(
        tuple_tree(JaxBackend().encode_verify_batch(jsigs, msgs, jvk, jparams)), CPU
    )
    pops = TorchBackend(device="cpu").encode_verify_batch(sigs, msgs, vk, params)
    assert pops[3][0][0].dtype == torch.int16  # sigma_1's x: an Fp2 pair
    for p, j in zip(tw.leaves(pops), tw.leaves(jops)):
        assert p.dtype == j.dtype and torch.equal(p, j)
    plain = cuda_fp.PLAIN_CALLS
    bits = fused_verify(False, *jops).tolist()
    assert cuda_fp.PLAIN_CALLS > plain  # CPU tensors: the plain path
    spec = [ps_verify(s, m, jvk, jparams) for s, m in zip(jsigs, msgs)]
    assert bits == spec == expect == [True, False] * 3


class _Recorder:
    """Forwards to a backend and records each combined check (first lane,
    lanes, pairing bool); lanes are found by identity."""

    def __init__(self, be, lanes):
        self.be, self.calls = be, []
        self._index = {id(x): i for i, x in enumerate(lanes)}

    def batch_verify_combined(self, sigs, msgs, vk, params, epoch=None):
        ok = self.be.batch_verify_combined(sigs, msgs, vk, params, epoch=epoch)
        self.calls.append((self._index[id(sigs[0])], len(sigs), ok))
        return ok

    def batch_verify(self, sigs, msgs, vk, params):
        return self.be.batch_verify(sigs, msgs, vk, params)


def test_combined_ladder_g2_names_the_forged_lane():
    """B = 4 under G2 with lane 2's sigma_2 doubled, through
    ps.batch_verify(mode="batched") on TorchBackend("cpu"): the bits are
    the spec's, and the ladder (rejected batch, both halves, both lanes of
    the failing half) has lane 2 as its only failed leaf. Its order of
    checks is held against coconut_tpu.ps's in tests/test_torch_combined.py."""
    params, _, vk, sigs, msgs = entry.fixture(4, msg_count=2, ctx="G2")
    sigs = list(sigs)
    s = sigs[2]
    sigs[2] = type(s)(s.sigma_1, params.ctx.sig.mul(s.sigma_2, 2))
    jparams, jvk, jsigs = as_jax(params, vk, sigs)
    rec = _Recorder(TorchBackend(device="cpu", comb_window=4), sigs)
    bits = ps.batch_verify(sigs, msgs, vk, params, rec, mode="batched")
    assert bits == [ps_verify(s, m, jvk, jparams) for s, m in zip(jsigs, msgs)]
    assert bits == [True, True, False, True]
    assert [(lo, n) for lo, n, _ in rec.calls] == [(0, 4), (0, 2), (2, 2), (2, 1), (3, 1)]
    assert [lo for lo, n, ok in rec.calls if n == 1 and not ok] == [2]
    assert (rec.be.combined_checks, rec.be.final_exps) == (5, 5)
