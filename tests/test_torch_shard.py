"""The port's sharded programs (`coconut_tpu_torch/gpu/shard.py`), the mesh
lanes of `verify_stream` and `CredentialService`, and `FrameworkConfig`,
against the JAX package and the spec, on the CPU.

Every Mesh here is `[torch.device("cpu")] * n`: logical shards on one
device, as one card holds them. The JAX package's sharded programs are
never compiled; only its pairing-free pieces are (`jax.jit` of
`curve.msm_shared_comb`, `curve.jadd` and `backend.grouped_accumulators`
over the operand slices a shard gets, at B <= 2 a shard), and its
`require_axes`, `_dispatchers`, `default_mesh` and `FrameworkConfig` are
called on meshes that build no program. Verdicts are held against the
JAX package's spec (`ps_verify`, `show_verify`, `BlindSignature.new`) and
the port's unsharded `TorchBackend(device="cpu")`.

Shapes are tiny (B <= 8, q <= 6). Tolerance: exact — limbs, dtypes,
verdict bits, error types and texts.
"""

import dataclasses
import random
from types import SimpleNamespace

import pytest
import torch

import jax
import jax.numpy as jnp

from coconut_tpu import config as jconfig
from coconut_tpu import elgamal as jelgamal
from coconut_tpu import keygen as jkeygen
from coconut_tpu import params as jparams
from coconut_tpu import signature as jsig
from coconut_tpu import stream as jstream
from coconut_tpu.backend import get_backend as jget_backend
from coconut_tpu.pok_sig import show_verify as jshow_verify
from coconut_tpu.ps import ps_verify
from coconut_tpu.tpu import backend as jbe
from coconut_tpu.tpu import curve as jcv
from coconut_tpu.tpu import shard as jshard
from coconut_tpu_torch import config, convert, entry, metrics
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.backend import SpecBackend
from coconut_tpu_torch.convert import operands_from_numpy
from coconut_tpu_torch.gpu import backend as bk
from coconut_tpu_torch.gpu import cuda_fp
from coconut_tpu_torch.gpu import shard
from coconut_tpu_torch.gpu import tower as tw
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.ops.fields import R
from coconut_tpu_torch.serve import CredentialService
from coconut_tpu_torch.stream import _dispatchers, verify_stream
from test_torch_grouped import as_jax, seeded_randbits, tuple_tree
from torch_show_helpers import as_jax as show_as_jax
from torch_show_helpers import seeded_randbelow, spec_proof, two_torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def cpu_mesh(ndp, ntp):
    return shard.default_mesh(ndp, ntp, devices=[CPU] * (ndp * ntp))


def forged(params, sigs, lane, k=2):
    """`sigs` with lane `lane`'s sigma_2 multiplied by k."""
    out = list(sigs)
    s = out[lane]
    out[lane] = jsig.Signature(s.sigma_1, params.ctx.sig.mul(s.sigma_2, k))
    return out


@pytest.fixture(scope="module")
def creds():
    """B = 8 credentials over q = 2 attributes as the JAX package's own
    objects (the port's backend reads them by duck typing)."""
    return as_jax(entry.fixture(8, msg_count=2, seed=0x51A2D))


@pytest.fixture(scope="module")
def be():
    return TorchBackend(device="cpu", comb_window=4)


# --- (1), (2) the encoders' padding ------------------------------------------------


@pytest.fixture(scope="module")
def creds_g2():
    """B = 4 credentials over q = 2 attributes under the G2 assignment
    (signatures in G2, the verkey and its comb tables in G1), lane 1
    forged."""
    params, vk, sigs, msgs = as_jax(entry.fixture(4, msg_count=2, ctx="G2"))
    return params, vk, forged(params, sigs, 1), msgs


@pytest.fixture(scope="module")
def padded(creds_g2):
    """creds_g2 encoded with pad_bases_to=8 (3 bases padded by 5 identity
    ones) by both packages: JaxBackend's operands (as tensors) and the
    port's, both on the JAX package's CPU comb schedule (window 6)."""
    params, vk, sigs, msgs = creds_g2
    jops = operands_from_numpy(
        tuple_tree(jbe.JaxBackend().encode_verify_batch(sigs, msgs, vk, params, pad_bases_to=8)),
        CPU,
    )
    port = TorchBackend(device="cpu")
    pops = port.encode_verify_batch(sigs, msgs, vk, params, pad_bases_to=8)
    return jops, pops, port


def test_encode_verify_batch_pad_bases_to_matches_jax(padded, creds_g2):
    """Every operand equal to JaxBackend's (dtype, shape, value): identity
    rows for the padded bases, zero digits for their scalars; padded and
    unpadded encodes of one verkey are two cache misses, each then a hit."""
    params, vk, sigs, msgs = creds_g2
    jops, pops, port = padded
    assert pops[1].shape == (4, 8, 43)
    for p, j in zip(tw.leaves(pops), tw.leaves(jops)):
        assert p.dtype == j.dtype and torch.equal(p, j)
    assert not pops[1][:, 3:].any() and not pops[2][:, 3:].any()
    assert (port.encode_cache_hits, port.encode_cache_misses) == (0, 1)
    unpadded = port.encode_verify_batch(sigs[:2], msgs[:2], vk, params)
    assert unpadded[1].shape == (2, 3, 43)
    assert (port.encode_cache_hits, port.encode_cache_misses) == (0, 2)
    port.encode_verify_batch(sigs[:2], msgs[:2], vk, params, pad_bases_to=8)
    port.encode_verify_batch(sigs[:2], msgs[:2], vk, params)
    assert (port.encode_cache_hits, port.encode_cache_misses) == (2, 2)
    assert [key[7] for key in port._static_cache._d] == [8, None]


@pytest.fixture(scope="module")
def grouped_padded(creds):
    """B = 3 encoded with pad_batch_to=8 (clones of lane 0) by both
    packages under one seeded combiner draw."""
    params, vk, sigs, msgs = creds
    with pytest.MonkeyPatch.context() as mp:
        seeded_randbits(mp, 0x5A)
        jops = jbe.JaxBackend().encode_grouped_batch(sigs[:3], msgs[:3], vk, params, pad_batch_to=8)
        seeded_randbits(mp, 0x5A)
        pops = TorchBackend(device="cpu").encode_grouped_batch(
            sigs[:3], msgs[:3], vk, params, pad_batch_to=8
        )
    return operands_from_numpy(tuple_tree(jops), CPU), pops


def test_encode_grouped_batch_pad_batch_to_matches_jax(grouped_padded):
    jops, pops = grouped_padded
    assert pops[4].shape == (3, 8, 43) and pops[6].shape == (1, 8, 23)
    for p, j in zip(tw.leaves(pops), tw.leaves(jops)):
        assert p.dtype == j.dtype and torch.equal(p, j)


# --- (3) the combined partial accumulators -------------------------------------------


def _cut(tree, sl, dim=0):
    return jax.tree_util.tree_map(lambda t: t[(slice(None),) * dim + (sl,)], tree)


def _equal(port_tree, jax_tree):
    got = tw.leaves(port_tree)
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(jax.device_get(w).copy()))


def test_tp_combined_comb_partials_match_jax(padded, monkeypatch):
    """The per-credential program on (dp = 2, tp = 4) over the JAX
    encoder's operands (G2 assignment: the accumulator in G1): each dp
    row's four partial comb MSMs (2 bases each; the last two shards all
    identity), combined on the row's lead, limb for limb equal to the JAX
    package's curve.msm_shared_comb over the same slices folded by
    curve.jadd in its order."""
    jops, _, _ = padded
    seen = []

    def tail(sig_is_g1, acc, *rest):
        seen.append(acc)
        return torch.zeros(rest[-1].shape, dtype=torch.bool)

    monkeypatch.setattr(bk, "verify_tail", tail)
    bits = shard.make_sharded_verify(cpu_mesh(2, 4), False)(*jops)
    assert bits.shape == (4,) and len(seen) == 2

    wt, mag, sgn = (jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), x) for x in jops[:3])
    comb = jax.jit(lambda w, m, s: jcv.msm_shared_comb(jcv.FP, w, m, s))
    jadd = jax.jit(lambda a, b: jcv.jadd(jcv.FP, a, b))
    for i, acc in enumerate(seen):
        lanes = slice(2 * i, 2 * i + 2)
        parts = [
            comb(_cut(wt, slice(2 * j, 2 * j + 2)), mag[lanes, 2 * j : 2 * j + 2],
                 sgn[lanes, 2 * j : 2 * j + 2])
            for j in range(4)
        ]
        want = parts[0]
        for p in parts[1:]:
            want = jadd(want, p)
        _equal(acc, want)


def test_dp_combined_grouped_accumulators_match_jax_and_accept(grouped_padded, monkeypatch):
    """The grouped program on (dp = 4, tp = 1) over the JAX encoder's
    operands (3 honest lanes padded to 8): the four shards' q+2
    accumulators over 2 lanes each, combined on the lead, limb for limb
    equal to the JAX package's backend.grouped_accumulators over the same
    lane slices folded by curve.jadd; the death flag false; the tail then
    accepts, as the spec does."""
    jops, _ = grouped_padded
    seen = []
    tail = bk.grouped_tail

    def capture(sig_is_g1, allacc, ox, oy, gtx, gty, any_dead):
        seen.append((allacc, any_dead))
        return tail(sig_is_g1, allacc, ox, oy, gtx, gty, any_dead)

    monkeypatch.setattr(bk, "grouped_tail", capture)
    ok = shard.make_sharded_grouped_verify(cpu_mesh(4, 1), True)(*jops)
    assert ok.shape == () and bool(ok)
    (allacc, any_dead), = seen
    assert any_dead.shape == () and not bool(any_dead)

    ops = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), jops[:8])
    acc = jax.jit(lambda *a: jbe.grouped_accumulators(jcv.FP, *a))
    jadd = jax.jit(lambda a, b: jcv.jadd(jcv.FP, a, b))
    parts = []
    for i in range(4):
        lanes = slice(2 * i, 2 * i + 2)
        parts.append(acc(*(_cut(o, lanes) for o in ops[:4]), *(_cut(o, lanes, 1) for o in ops[4:])))
    want = parts[0]
    for p in parts[1:]:
        want = jadd(want, p)
    _equal(allacc, want)


# --- (4) verdicts --------------------------------------------------------------------


def test_sharded_per_credential_verify_and_ragged_batch(creds, be):
    """dp+tp sharded per-credential verify on (2, 2) at B = 4 (3 bases
    padded to 4) with lane 1 forged: the spec's bits, and those of the
    unsharded program on the same operands. B = 3 pads one identity lane
    and returns 3 bits."""
    params, vk, sigs, msgs = creds
    sigs, msgs = forged(params, sigs[:4], 1), msgs[:4]
    want = [ps_verify(s, m, vk, params) for s, m in zip(sigs, msgs)]
    assert want == [True, False, True, True]
    mesh = cpu_mesh(2, 2)
    assert shard.batch_verify_sharded(be, sigs, msgs, vk, params, mesh) == want
    ops = be.encode_verify_batch(sigs, msgs, vk, params, pad_bases_to=4)
    assert bk.fused_verify(True, *ops).tolist() == want
    bits = be.batch_verify_sharded(sigs[:3], msgs[:3], vk, params, mesh)
    assert bits == want[:3]
    assert shard.batch_verify_sharded(be, [], [], vk, params, mesh) == []


def test_sharded_grouped_verify_rejects_a_forgery(creds, be):
    """The grouped program on (4, 1), one lane a shard: lane 2's sigma_2
    tripled fails the whole batch, as the spec says of that lane; an
    identity sigma fails it with no device work."""
    params, vk, sigs, msgs = creds
    bad = forged(params, sigs[:4], 2, k=3)
    assert not ps_verify(bad[2], msgs[2], vk, params)
    mesh = cpu_mesh(4, 1)
    assert be.batch_verify_grouped_sharded(bad, msgs[:4], vk, params, mesh, pad_batch_to=4) is False
    plain = cuda_fp.PLAIN_CALLS
    dead = [jsig.Signature(None, None)] + list(sigs[1:4])
    assert shard.batch_verify_grouped_sharded(be, dead, msgs[:4], vk, params, mesh) is False
    assert shard.batch_verify_grouped_sharded(be, [], [], vk, params, mesh) is True
    assert cuda_fp.PLAIN_CALLS == plain


def test_sharded_show_verify_with_a_tampered_proof(be):
    """dp-sharded show verify on (4, 1) at B = 4, lane 2's first response
    bumped: the JAX package's show_verify bits."""
    params, _, vk, proofs, rmsgs, chals = entry.show_fixture(4)
    p = proofs[2]
    proofs[2] = type(p)(
        p.sigma_prime_1, p.sigma_prime_2, p.J,
        type(p.proof_vc)(p.proof_vc.t, [(p.proof_vc.responses[0] + 1) % R] + p.proof_vc.responses[1:]),
        p.revealed_msg_indices,
    )
    jp, jvk, _ = show_as_jax(params, vk, [])
    want = [jshow_verify(spec_proof(q), jvk, jp, rm, c) for q, rm, c in zip(proofs, rmsgs, chals)]
    assert want == [True, True, False, True]
    got = shard.batch_show_verify_sharded(be, proofs, vk, params, rmsgs, chals, cpu_mesh(4, 1))
    assert got == want
    with pytest.raises(ValueError, match="batch size 3 not divisible by dp=4"):
        shard.batch_show_verify_sharded(be, proofs[:3], vk, params, rmsgs, chals, cpu_mesh(4, 1))


def test_sharded_issuance_matches_the_reference():
    """Config 4 on (4, 1): prepare, blind-sign and unblind with every
    issuance MSM program dp-sharded, byte-equal to the JAX package's
    prepare (same seeded draws) and BlindSignature.new, each credential
    verifying under its signer's verkey; a batch of 3 rows is refused as
    not divisible before any multiply."""
    with pytest.MonkeyPatch.context() as mp:
        seeded_randbelow(mp, 0x5AD)
        jp = jparams.Params.new(6, b"shard-test")
        _, _, jsigners = jkeygen.trusted_party_SSS_keygen(3, 5, jp)
        esk, epk = jelgamal.elgamal_keygen(jp.ctx.sig, jp.g)
    pp = convert.params_from(jp)
    rng = random.Random(0x5AD)
    msgs = [[rng.randrange(R) for _ in range(6)] for _ in range(4)]
    sb = shard.ShardedIssuanceBackend(cpu_mesh(4, 1), comb_window=4)
    with pytest.MonkeyPatch.context() as mp:
        seeded_randbelow(mp, 0x9E)
        want = jsig.batch_prepare_blind_sign(msgs, 2, epk, jp, backend="python")
        seeded_randbelow(mp, 0x9E)
        got = sig.batch_prepare_blind_sign(msgs, 2, epk, pp, backend=sb)
    assert [r.to_bytes(pp.ctx) for r, _ in got] == [r.to_bytes(jp.ctx) for r, _ in want]
    signer = jsigners[0]
    blinded = sig.batch_blind_sign([r for r, _ in got], convert.sigkey_from(signer.sigkey), pp, backend=sb)
    for (jreq, _), bs in zip(want, blinded):
        ref = jsig.BlindSignature.new(jreq, signer.sigkey, jp)
        assert (bs.h, bs.blinded) == (ref.h, ref.blinded)
    creds = sig.batch_unblind(blinded, esk, pp.ctx, backend=sb)
    for c, m in zip(creds, msgs):
        assert ps_verify(jsig.Signature(c.sigma_1, c.sigma_2), m, signer.verkey, jp)
    assert sb.msm_offset_dispatches == 1 and sb.msm_horner_dispatches >= 3
    plain = cuda_fp.PLAIN_CALLS
    with pytest.raises(ValueError, match="row count 3 not divisible by dp=4"):
        sig.batch_prepare_blind_sign(msgs[:3], 2, epk, pp, backend=sb)
    assert cuda_fp.PLAIN_CALLS == plain


# --- (5) the reference's errors ----------------------------------------------------------


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("shape", [{}, {"dp": 2}, {"tp": 1}])
def test_require_axes_matches_the_reference(shape):
    ns = SimpleNamespace(shape=shape)
    for axes in (("dp",), ("dp", "tp")):
        want = _raised(jshard.require_axes, ns, *axes) if set(axes) - set(shape) else None
        if want is None:
            shard.require_axes(ns, *axes)
            continue
        assert _raised(shard.require_axes, ns, *axes) == want
    assert _raised(shard.ShardedIssuanceBackend, SimpleNamespace(shape={"tp": 1})) == _raised(
        jshard.ShardedIssuanceBackend, SimpleNamespace(shape={"tp": 1})
    )


def test_mesh_errors_match_the_reference():
    """default_mesh's size check, the grouped program's power-of-two dp
    extent, the show batch's divisibility and _dispatchers' mode,
    capability and mesh-and-device checks: the JAX package's error types
    and texts (the capability probe names the port's backend)."""
    assert _raised(shard.default_mesh, 2, 2, [CPU] * 3) == _raised(
        jshard.default_mesh, 2, 2, jax.devices()[:3]
    )
    dp3 = SimpleNamespace(shape={"dp": 3})
    assert _raised(shard.batch_verify_grouped_sharded, None, [], [], None, None, dp3) == _raised(
        jshard.batch_verify_grouped_sharded, None, [], [], None, None, dp3
    )
    dp2 = SimpleNamespace(shape={"dp": 2})
    assert _raised(shard.batch_show_verify_sharded, None, [1] * 3, None, None, [], [], dp2) == _raised(
        jshard.batch_show_verify_sharded, None, [1] * 3, None, None, [], [], dp2
    )
    mesh = SimpleNamespace(shape={"dp": 2, "tp": 1})
    spec, jpy = SpecBackend(), jget_backend("python")
    assert _raised(_dispatchers, spec, "batched", mesh=mesh) == _raised(
        jstream._dispatchers, jpy, "batched", mesh=mesh
    )
    assert _raised(_dispatchers, be_stub(), "grouped", mesh=mesh, device=CPU) == _raised(
        jstream._dispatchers, be_stub(), "grouped", mesh=mesh, device="d0"
    )
    for mode, needed in (("per_credential", "encode_verify_batch"), ("grouped", "encode_grouped_batch")):
        kind, text = _raised(_dispatchers, spec, mode, mesh=mesh)
        jkind, jtext = _raised(jstream._dispatchers, jpy, mode, mesh=mesh)
        assert kind == jkind == "ValueError"
        assert text == "backend %r cannot shard over a mesh (no %s); use the torch backend" % (spec, needed)
        assert jtext == "backend %r cannot shard over a mesh (no %s); use the jax backend" % (jpy, needed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.default_mesh()


def be_stub():
    return SimpleNamespace(encode_grouped_batch=None, encode_verify_batch=None)


def test_mesh_shape_and_grid():
    """A Mesh reads as the reference's: shape a dict by axis, devices an
    object array; one device may stand at several places."""
    mesh = cpu_mesh(2, 3)
    assert mesh.shape == {"dp": 2, "tp": 3} and "tp" in mesh.shape
    assert mesh.devices.shape == (2, 3) and all(d == CPU for d in mesh.devices.flat)
    named = shard.Mesh([["cpu", "cpu"]], ("tp", "dp"))
    assert named.shape == {"tp": 1, "dp": 2}
    assert shard._grid(named, "dp", "tp") == [[CPU], [CPU]]
    assert shard.pad_to_multiple(7, 2) == 8 and shard.pad_to_multiple(8, 4) == 8
    assert shard.PAD_LANE.sigma_1 is None and shard.PAD_LANE.sigma_2 is None


# --- (6) FrameworkConfig ---------------------------------------------------------------


def test_framework_config_matches_the_reference(monkeypatch):
    """The same fields and defaults (the backend's default is "torch" by
    the port's rules, the reference's "python"), the same env overrides,
    the same params; make_mesh over the CUDA cards."""
    names = lambda cls: [(f.name, f.type) for f in dataclasses.fields(cls)]
    assert names(config.FrameworkConfig) == names(jconfig.FrameworkConfig)
    monkeypatch.delenv("COCONUT_BACKEND", raising=False)
    monkeypatch.delenv("COCONUT_BATCH", raising=False)
    got, want = config.FrameworkConfig(), jconfig.FrameworkConfig()
    assert (got.backend, want.backend) == ("torch", "python")
    assert dataclasses.asdict(dataclasses.replace(got, backend="python")) == dataclasses.asdict(want)
    monkeypatch.setenv("COCONUT_BACKEND", "spec")
    monkeypatch.setenv("COCONUT_BATCH", "64")
    got, want = config.FrameworkConfig(signature_group="G2"), jconfig.FrameworkConfig(signature_group="G2")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.batch_size == 64 and isinstance(got.resolve_backend(), SpecBackend)
    assert got.group_context().name == want.group_context().name == "G2"
    gp, wp = config.FrameworkConfig(msg_count=2).make_params(), jconfig.FrameworkConfig(msg_count=2).make_params()
    assert (gp.g, gp.g_tilde, gp.h, gp.ctx.name) == (wp.g, wp.g_tilde, wp.h, wp.ctx.name)
    for bad in (config.FrameworkConfig(signature_group="G3"), jconfig.FrameworkConfig(signature_group="G3")):
        with pytest.raises(ValueError, match="signature_group must be 'G1' or 'G2'"):
            bad.group_context()
    assert config.FrameworkConfig().make_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = config.FrameworkConfig(mesh_shape=(2, 2)).make_mesh()
    assert mesh.shape == {"dp": 2, "tp": 2}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    with pytest.raises(ValueError, match="mesh 3x2 != 4 devices"):
        config.FrameworkConfig(mesh_shape=(3, 2)).make_mesh()


# --- (7) verify_stream on a mesh -------------------------------------------------------------


def test_sharded_grouped_stream(creds, be, tmp_path):
    """verify_stream(mode="grouped") on (2, 1): three batches of 4, lane 3
    of batch 1 forged — batch verdicts [True, False, True] as the spec's,
    honest tallies (the reference's asserts scaled to B = 4), checkpoint
    at 3."""
    params, vk, sigs, msgs = creds
    sigs, msgs = sigs[:4], msgs[:4]
    bad = forged(params, sigs, 3)
    seen = []
    state = verify_stream(
        lambda i: (bad if i == 1 else sigs, msgs), 3, vk, params, be,
        state_path=str(tmp_path / "g.json"), mode="grouped", mesh=cpu_mesh(2, 1),
        on_batch=lambda i, ok: seen.append((i, ok)),
    )
    assert seen == [(0, True), (1, False), (2, True)]
    assert not ps_verify(bad[3], msgs[3], vk, params)
    assert state.batches_ok == 2 and state.batches_failed == 1
    assert state.verified == 8 and state.failed == 4
    assert state.next_batch == 3


def test_sharded_per_credential_stream(creds, be, tmp_path):
    """verify_stream(mode="per_credential") on (1, 2): three batches of 4,
    lane 2 of batch 1 forged — 11 verified, 1 failed (the reference's
    asserts at B = 4)."""
    params, vk, sigs, msgs = creds
    sigs, msgs = sigs[:4], msgs[:4]
    bad = forged(params, sigs, 2)
    seen = []
    state = verify_stream(
        lambda i: (bad if i == 1 else sigs, msgs), 3, vk, params, be,
        state_path=str(tmp_path / "pc.json"), mode="per_credential", mesh=cpu_mesh(1, 2),
        on_batch=lambda i, bits: seen.append(bits),
    )
    assert seen[1] == [ps_verify(s, m, vk, params) for s, m in zip(bad, msgs)] == [True, True, False, True]
    assert state.verified == 11 and state.failed == 1
    assert state.next_batch == 3


# --- (8) CredentialService on a mesh -----------------------------------------------------------


def test_mesh_service_routes_bulk_batches_sharded(creds, be):
    """The reference's routing and counters (tests/test_serve.py's mesh
    integration test): 8 bulk requests submitted before start, max_batch
    4, lane 5 forged — two full batches placed on the sharded executor,
    every future its own lane's verdict."""
    params, vk, sigs, msgs = creds
    sigs = forged(params, sigs, 5)
    metrics.reset()
    svc = CredentialService(
        be, vk, params, mode="per_credential", max_batch=4, max_wait_ms=20.0,
        mesh=cpu_mesh(1, 2), watchdog_interval_s=None,
    )
    try:
        futs = [svc.submit(s, m, lane="bulk") for s, m in zip(sigs, msgs)]
        svc.start()
        assert svc.drain(timeout=600.0)
        assert [f.result(0) for f in futs] == [i != 5 for i in range(8)]
        assert metrics.get_count("serve_placed_sharded") == 2
        assert metrics.get_count("serve_devmesh_dispatches") == 2
        assert metrics.get_count("serve_devmesh_requests") == 8
        snap = metrics.snapshot()
        assert snap["counters"]["serve_devmesh_dispatches"] == 2
        assert "serve_devmesh_busy_s" in snap["timers_s"]
    finally:
        metrics.reset()
