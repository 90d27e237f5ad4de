"""The port's attribute-grouped one-bool verify against the JAX package and
the spec, on the CPU, under both signature assignments: _grouped_msms limb
for limb against coconut_tpu's (both against the spec's MSM), the JAX
encoder's operands through the port's fused_verify_grouped, the port's
encode_grouped_batch element for element against JaxBackend's under one
seeded combiner draw, and TorchBackend.batch_verify_grouped against the
spec's ps_verify.

Shapes are tiny (B <= 4, q <= 2, as tests/test_backends.py's G2 test).
The JAX package's whole grouped program is never compiled here; only its
pairing-free _grouped_msms is (jax.jit at B = 4).

Tolerance: exact — limbs, digits, dtypes and verdict bits must be equal.
"""

import random
import secrets

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coconut_tpu.ops.curve import G1_GEN, G2_GEN, g1 as sg1, g2 as sg2
from coconut_tpu.params import GroupContext as SpecContext, Params as SpecParams
from coconut_tpu.ps import ps_verify
from coconut_tpu.signature import Signature as SpecSignature, Verkey as SpecVerkey
from coconut_tpu.tpu import backend as jbe
from coconut_tpu.tpu import curve as jcv
from coconut_tpu.tpu import tower as jtw
from coconut_tpu_torch import entry
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import curve as cv
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend, _grouped_msms, fused_verify_grouped
from coconut_tpu_torch.gpu.limbs import fr_digits_signed_np
from coconut_tpu_torch.ops.fields import R
from coconut_tpu_torch.params import Signature

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def as_jax(fix):
    """entry.fixture's output -> (params, vk, sigs, msgs) as the JAX
    package's own objects (same points)."""
    params, _, vk, sigs, msgs = fix
    jparams = SpecParams(params.g, params.g_tilde, params.h, SpecContext(params.ctx.name))
    jsigs = [SpecSignature(s.sigma_1, s.sigma_2) for s in sigs]
    return jparams, SpecVerkey(vk.X_tilde, vk.Y_tilde), jsigs, msgs


def seeded_randbits(monkeypatch, seed):
    """Patch secrets.randbits, which both packages' encode_grouped_batch
    call, with a seeded sequence."""
    rng = random.Random(seed)
    monkeypatch.setattr(secrets, "randbits", rng.getrandbits)


def tuple_tree(t):
    if isinstance(t, (tuple, list)):
        return tuple(tuple_tree(x) for x in t)
    return np.asarray(t)


@pytest.fixture(scope="module", params=["G1", "G2"])
def tiny(request):
    """B = 2 credentials over q = 1 attribute under each assignment."""
    return as_jax(entry.fixture(2, msg_count=1, ctx=request.param))


# --- the shared-point MSMs --------------------------------------------------


@pytest.mark.parametrize("group", ["FP", "FP2"])
def test_grouped_msms_match_jax_and_spec(group):
    """M = 2 MSMs over B = 4 points (lane 2 the identity; row 1 with a zero
    scalar at lane 1): projective limbs equal to the JAX package's, and
    the affine results equal to the spec's MSM."""
    spec, gen = (sg1, G1_GEN) if group == "FP" else (sg2, G2_GEN)
    rng = random.Random(0x6E0 + len(group))
    pts = [spec.mul(gen, rng.randrange(1, R)) for _ in range(4)]
    inf = [False, False, True, False]
    rows = [[rng.randrange(R) for _ in range(4)] for _ in range(2)]
    rows[1][1] = 0
    rec = [fr_digits_signed_np(r, nwin=43, window=6) for r in rows]
    mag, sgn = np.stack([m for m, _ in rec]), np.stack([s for _, s in rec])

    x = tw.encode_batch([p[0] for p in pts], CPU)
    y = tw.encode_batch([p[1] for p in pts], CPU)
    fl = getattr(cv, group)
    acc = _grouped_msms(
        fl, x, y, torch.tensor(inf), torch.from_numpy(mag), torch.from_numpy(sgn)
    )
    jfl = getattr(jcv, group)
    jacc = jax.jit(lambda x, y, i, m, s: jbe._grouped_msms(jfl, x, y, i, m, s))(
        jtw.encode_batch([p[0] for p in pts]), jtw.encode_batch([p[1] for p in pts]),
        jnp.asarray(inf), jnp.asarray(mag), jnp.asarray(sgn),
    )
    for got, want in zip(tw.leaves(acc), jax.tree_util.tree_leaves(jacc)):
        assert torch.equal(got, torch.from_numpy(np.array(want)))

    ax, ay, ainf = cv.to_affine(fl, acc)
    live = [p for p, i in zip(pts, inf) if not i]
    for m, row in enumerate(rows):
        want = spec.msm(live, [k for k, i in zip(row, inf) if not i])
        got = None if ainf[m] else (
            tw.decode_batch(tw.tree_map(lambda t: t[m : m + 1], ax))[0],
            tw.decode_batch(tw.tree_map(lambda t: t[m : m + 1], ay))[0],
        )
        assert got == want


# --- the whole program on the JAX encoder's operands -------------------------


def test_jax_operands_through_port_fused_verify_grouped(tiny, monkeypatch):
    """The honest batch passes; lane 1 with sigma_2 doubled, and lane 1
    with a wrong message, each fail the whole batch — as the spec's
    ps_verify says of their lanes."""
    params, vk, sigs, msgs = tiny
    is_g1 = params.ctx.name == "G1"
    forged = [sigs[0], SpecSignature(sigs[1].sigma_1, params.ctx.sig.mul(sigs[1].sigma_2, 2))]
    wrong = [msgs[0], [(msgs[1][0] + 1) % R]]
    plain = cuda_fp.PLAIN_CALLS
    for batch, bmsgs in ((sigs, msgs), (forged, msgs), (sigs, wrong)):
        seeded_randbits(monkeypatch, 5)
        jops = jbe.JaxBackend().encode_grouped_batch(batch, bmsgs, vk, params)
        ok = fused_verify_grouped(is_g1, *operands_from_numpy(tuple_tree(jops), CPU))
        spec = all(ps_verify(s, m, vk, params) for s, m in zip(batch, bmsgs))
        assert ok.shape == () and bool(ok) == spec
        assert spec is (batch is sigs and bmsgs is msgs)
    assert cuda_fp.PLAIN_CALLS > plain  # CPU tensors: the plain path


# --- the host encode ----------------------------------------------------------


@pytest.mark.parametrize("ctx", ["G1", "G2"])
def test_encode_grouped_batch_matches_jax(ctx, monkeypatch):
    """B = 3 (padded to 4 with clones of lane 0) over q = 2 attributes,
    under one seeded combiner draw: every operand equal to JaxBackend's,
    dtype, shape and value; the static half cached under kind "grouped"."""
    params, vk, sigs, msgs = as_jax(entry.fixture(3, msg_count=2, ctx=ctx))
    seeded_randbits(monkeypatch, 9)
    want = operands_from_numpy(
        tuple_tree(jbe.JaxBackend().encode_grouped_batch(sigs, msgs, vk, params)), CPU
    )
    be = TorchBackend(device="cpu")
    seeded_randbits(monkeypatch, 9)
    got = be.encode_grouped_batch(sigs, msgs, vk, params)
    assert len(got) == len(want) == 12
    assert got[4].shape == (3, 4, 43) and got[6].shape == (1, 4, 23)
    for g, w in zip(tw.leaves(got), tw.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    misses = be.encode_cache_misses
    be.encode_grouped_batch(sigs, msgs, vk, params)
    assert (be.encode_cache_hits, be.encode_cache_misses) == (1, misses)
    assert ("grouped", ctx) == next(iter(be._static_cache._d))[:2]


def test_combiner_width_guard(monkeypatch):
    """A combiner draw far wider than 128 bits would lose its top windows
    on the r-row's 23-window schedule: both packages refuse it."""
    params, vk, sigs, msgs = as_jax(entry.fixture(2, msg_count=1))
    monkeypatch.setattr(secrets, "randbits", lambda bits: 1 << 200)
    with pytest.raises(ValueError, match="128 bits"):
        TorchBackend(device="cpu").encode_grouped_batch(sigs, msgs, vk, params)
    with pytest.raises(ValueError, match="128 bits"):
        jbe.JaxBackend().encode_grouped_batch(sigs, msgs, vk, params)


# --- the entry point ------------------------------------------------------------


def test_batch_verify_grouped_matches_spec():
    """TorchBackend(device="cpu").batch_verify_grouped: B = 3 honest
    (padded to 4) is all(ps_verify) = True from ONE final exponentiation;
    an empty batch is True and an identity sigma False without device
    work; mismatched lengths raise."""
    fix = entry.fixture(3, msg_count=2)
    params, _, vk, sigs, msgs = fix
    jparams, jvk, jsigs, _ = as_jax(fix)
    be = TorchBackend(device="cpu")
    plain = cuda_fp.PLAIN_CALLS
    assert be.batch_verify_grouped([], [], vk, params) is True
    assert be.batch_verify_grouped_async([Signature(None, None)] + sigs[1:], msgs, vk, params)() is False
    assert cuda_fp.PLAIN_CALLS == plain and be.final_exps == 0
    assert be.batch_verify_grouped(sigs, msgs, vk, params) is True
    assert all(ps_verify(s, m, jvk, jparams) for s, m in zip(jsigs, msgs))
    assert (be.grouped_checks, be.final_exps) == (3, 1)
    with pytest.raises(ValueError, match="batch size mismatch"):
        be.batch_verify_grouped(sigs, msgs[:2], vk, params)
    with pytest.raises(ValueError, match="msg_count"):
        be.batch_verify_grouped(sigs, [m[:1] for m in msgs], vk, params)
