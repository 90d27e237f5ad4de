"""The port's native seam (`coconut_tpu_torch/native.py`) against the JAX
package's (`coconut_tpu/native.py`) and the port's host spec, and the
batched-verify counters of `ps.py` against the reference's.

Every comparison is exact (tolerance 0): canonical affine coordinates,
Fr residues and verdict bits. Inputs are drawn from numpy seeds. The port
builds `native/ccbls.cpp` with g++ into `build/`; the reference loads its
own library, so the two bindings are held against each other, and both
against the spec.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import __graft_entry__ as graft
from coconut_tpu import metrics as jmetrics
from coconut_tpu import native as jnative
from coconut_tpu import ps as jps
from coconut_tpu import sss as jsss
from coconut_tpu_torch import entry, metrics, native, ps, sss
from coconut_tpu_torch import signature as sig
from coconut_tpu_torch.backend import CurveBackend, SpecBackend, get_backend
from coconut_tpu_torch.errors import GeneralError
from coconut_tpu_torch.ops import hashing
from coconut_tpu_torch.ops.curve import G1_GEN, G2_GEN, g1, g2
from coconut_tpu_torch.ops.fields import R
from torch_show_helpers import as_jax, spec_proof

ROOT = Path(__file__).resolve().parent.parent
COUNTERS = ("verify_batched_fallbacks", "verify_bisection_depth")


def _scalars(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _points(rng, ops, gen, n):
    return [ops.mul(gen, s) for s in _scalars(rng, n)]


def _counts(registry):
    return {name: registry.get_count(name) for name in COUNTERS}


def _deltas(registry, before):
    return {name: registry.get_count(name) - before[name] for name in COUNTERS}


# --- repair: the batched-verify counters -------------------------------------


def test_batched_verify_counts_the_ladder_as_the_reference():
    """8 credentials, lane 5's sigma_2 doubled, mode "batched" on both
    packages' spec backends: equal bits, and the combined check's fallback
    and the ladder's splits counted as the reference counts them."""
    jparams, _, jvk, jsigs, jmsgs = graft._fixture(batch=8, msg_count=2)
    params, _, vk, sigs, msgs = entry.fixture(8, msg_count=2)
    jsigs[5] = type(jsigs[5])(jsigs[5].sigma_1, jparams.ctx.sig.mul(jsigs[5].sigma_2, 2))
    sigs[5] = type(sigs[5])(sigs[5].sigma_1, params.ctx.sig.mul(sigs[5].sigma_2, 2))

    jbefore, before = _counts(jmetrics), _counts(metrics)
    want = jps.batch_verify(jsigs, jmsgs, jvk, jparams, backend="python", mode="batched")
    got = ps.batch_verify(sigs, msgs, vk, params, ps.SPEC, mode="batched")
    assert got == want == [i != 5 for i in range(8)]
    assert _deltas(metrics, before) == _deltas(jmetrics, jbefore) == {
        "verify_batched_fallbacks": 1, "verify_bisection_depth": 3,
    }


def test_batched_show_counts_the_ladder_as_the_reference():
    """4 shows, lane 2's revealed value bumped (its pairing check fails),
    mode "batched" on both packages' CppBackend: equal bits and counts."""
    params, _, vk, proofs, rmsgs, chals = entry.show_fixture(4)
    rmsgs = [dict(rm) for rm in rmsgs]
    j = min(rmsgs[2])
    rmsgs[2][j] = (rmsgs[2][j] + 1) % R
    jparams, jvk, _ = as_jax(params, vk, [])
    jproofs = [spec_proof(p) for p in proofs]

    jbefore, before = _counts(jmetrics), _counts(metrics)
    want = jps.batch_show_verify(
        jproofs, jvk, jparams, rmsgs, chals, backend=jnative.CppBackend(), mode="batched"
    )
    got = ps.batch_show_verify(proofs, vk, params, rmsgs, chals, "cpp", mode="batched")
    assert got == want == [i != 2 for i in range(4)]
    assert _deltas(metrics, before) == _deltas(jmetrics, jbefore) == {
        "verify_batched_fallbacks": 1, "verify_bisection_depth": 2,
    }
    # exact mode: CppBackend has no fused show check, so both packages
    # verify proof by proof on the spec
    assert ps.batch_show_verify(proofs, vk, params, rmsgs, chals, "cpp") == got


# --- the backend -------------------------------------------------------------


def test_registry_names_the_native_backends():
    cpp, ct = get_backend("cpp"), get_backend("cpp_ct")
    assert isinstance(cpp, native.CppBackend) and isinstance(cpp, CurveBackend)
    assert (cpp._ct, ct._ct, cpp.name) == (0, 1, "cpp")


@pytest.mark.parametrize("ct", [False, True])
def test_cpp_backend_matches_the_reference_and_the_spec(ct):
    """The MSM primitives (identity bases and zero scalars included) and the
    pairing product, on the port's CppBackend, the reference's and the
    port's spec."""
    rng = np.random.default_rng(0x0C7 + ct)
    mine, ref, spec = native.CppBackend(ct=ct), jnative.CppBackend(ct=ct), SpecBackend()
    b1, b2 = _points(rng, g1, G1_GEN, 3), _points(rng, g2, G2_GEN, 3)
    b1[1] = b2[2] = None
    rows = [_scalars(rng, 3) for _ in range(3)]
    rows[1][0] = 0
    for name, args in [
        ("msm_g1_shared", (b1, rows)),
        ("msm_g2_shared", (b2, rows)),
        ("msm_g1_distinct", ([b1, b1[::-1]], rows[:2])),
        ("msm_g2_distinct", ([b2[::-1], b2], rows[1:])),
    ]:
        got = getattr(mine, name)(*args)
        assert got == getattr(ref, name)(*args) == getattr(spec, name)(*args), name
    p, q = _points(rng, g1, G1_GEN, 1)[0], _points(rng, g2, G2_GEN, 1)[0]
    pairs = [[(p, q), (g1.neg(p), q)], [(p, q), (p, q)], [(None, q), (p, None)]]
    assert mine.pairing_product_is_one(pairs) == ref.pairing_product_is_one(pairs) == [
        True, False, True,
    ]
    with pytest.raises(ValueError, match="ragged"):
        mine.pairing_product_is_one([[(p, q)], [(p, q), (p, q)]])


def test_cpp_backend_verifies_as_the_spec():
    """The composed verify surface over the native primitives: per-lane and
    combined checks on 4 credentials, one forged."""
    params, _, vk, sigs, msgs = entry.fixture(4, msg_count=2)
    msgs = [list(m) for m in msgs]
    msgs[3][0] = (msgs[3][0] + 1) % R
    want = [True, True, True, False]
    for name in ("cpp", "cpp_ct"):
        be = get_backend(name)
        assert be.batch_verify(sigs, msgs, vk, params) == want
        assert ps.batch_verify(sigs, msgs, vk, params, name, mode="batched") == want
        assert be.batch_verify_combined(sigs[:3], msgs[:3], vk, params) is True


# --- hashing, single MSMs ----------------------------------------------------


def test_hashes_match_the_reference_and_the_spec():
    rng = np.random.default_rng(0xA5)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 80, size=5)]
    for m in msgs:
        assert native.hash_to_fr(m) == jnative.hash_to_fr(m) == hashing.hash_to_fr(m)
        assert native.hash_to_g1(m) == jnative.hash_to_g1(m) == hashing.hash_to_g1(m)
    assert native.hash_to_g2(msgs[0]) == jnative.hash_to_g2(msgs[0]) == hashing.hash_to_g2(msgs[0])
    dst = b"OTHER-DST"
    assert native.hash_to_g1(msgs[1], dst) == hashing.hash_to_g1(msgs[1], dst)
    assert native.hash_to_g1_batch(msgs) == jnative.hash_to_g1_batch(msgs) == [
        hashing.hash_to_g1(m) for m in msgs
    ]
    assert native.hash_to_g1_batch([]) == []


@pytest.mark.parametrize("force", [False, True])
def test_single_msms_match_the_reference_and_the_spec(force):
    """Below PIPPENGER_MIN the windowed rows, above it (or forced) the
    buckets; an identity point and a zero scalar among the lanes."""
    rng = np.random.default_rng(0x51 + force)
    for n in (1, 5, native.PIPPENGER_MIN + 1):
        pts, ss = _points(rng, g1, G1_GEN, n), _scalars(rng, n)
        if n > 2:
            pts[1], ss[2] = None, 0
        got = native.msm_g1_single(pts, ss, force_pippenger=force)
        assert got == jnative.msm_g1_single(pts, ss, force_pippenger=force) == g1.msm(pts, ss)
    pts, ss = _points(rng, g2, G2_GEN, 4), _scalars(rng, 4)
    got = native.msm_g2_single(pts, ss, force_pippenger=force)
    assert got == jnative.msm_g2_single(pts, ss, force_pippenger=force) == g2.msm(pts, ss)
    assert native.msm_g1_single([], []) is None


# --- Shamir, Pedersen, DVSS --------------------------------------------------


def test_shamir_helpers_match_sss():
    rng = np.random.default_rng(0x5A)
    for ids in ({1, 2, 3}, {2, 5, 7}, {1, 4, 9, 11, 30}):
        for i in ids:
            want = sss.lagrange_basis_at_0(ids, i)
            assert native.lagrange_basis_at_0(ids, i) == jnative.lagrange_basis_at_0(ids, i) == want
    with pytest.raises(GeneralError, match="not in interpolation set"):
        native.lagrange_basis_at_0({1, 2}, 3)
    with pytest.raises(GeneralError, match="uint32"):
        native.lagrange_basis_at_0({1, 1 << 33}, 1)
    coeffs = _scalars(rng, 3)
    for x in (1, 2, 77):
        assert native.poly_eval(coeffs, x) == jnative.poly_eval(coeffs, x) == sss.poly_eval(coeffs, x)
    shares = {i: sss.poly_eval(coeffs, i) for i in range(1, 6)}
    sub = {i: shares[i] for i in (1, 3, 5)}
    assert native.reconstruct_secret(3, sub) == sss.reconstruct_secret(3, sub) == coeffs[0]
    with pytest.raises(GeneralError, match="need 3 shares"):
        native.reconstruct_secret(3, {1: 1})
    assert 0 <= native.rand_fr() < R


def _gens():
    return sss.PedersenVSS.gens(b"native-vss-test")


def test_pedersen_deal_and_verify_match_sss():
    rng = np.random.default_rng(0x9E)
    g, h = _gens()
    t, n = 3, 5
    fc, gc = _scalars(rng, t), _scalars(rng, t)
    comms, s_sh, t_sh = native.pedersen_deal_from_coeffs(t, n, g, h, fc, gc)
    assert (comms, s_sh, t_sh) == jnative.pedersen_deal_from_coeffs(t, n, g, h, fc, gc)
    assert comms == {j: g1.add(g1.mul(g, fc[j]), g1.mul(h, gc[j])) for j in range(t)}
    assert s_sh == {i: sss.poly_eval(fc, i) for i in range(1, n + 1)}
    assert t_sh == {i: sss.poly_eval(gc, i) for i in range(1, n + 1)}
    with pytest.raises(GeneralError, match="invalid threshold"):
        native.pedersen_deal_from_coeffs(6, 5, g, h, fc, gc)

    sec, _, comms, s_sh, t_sh = native.pedersen_deal(t, n, g, h)
    for i in range(1, n + 1):
        share = (s_sh[i], t_sh[i])
        assert native.pedersen_verify_share(t, i, share, comms, g, h)
        assert sss.PedersenVSS.verify_share(t, i, share, comms, g, h)
    bad = ((s_sh[2] + 1) % R, t_sh[2])
    assert not native.pedersen_verify_share(t, 2, bad, comms, g, h)
    assert not jnative.pedersen_verify_share(t, 2, bad, comms, g, h)
    assert sss.reconstruct_secret(t, {i: s_sh[i] for i in (1, 3, 5)}) == sec


def test_dvss_matches_and_interoperates_with_sss():
    g, h = _gens()
    t = 2
    ps_ = native.share_secret_dvss(t, 4, g, h)
    shares = {p.id: p.secret_share for p in ps_}
    first = sss.reconstruct_secret(t, {1: shares[1], 2: shares[2]})
    assert sss.reconstruct_secret(t, {2: shares[2], 4: shares[4]}) == first
    assert all(p.final_comm_coeffs == ps_[0].final_comm_coeffs for p in ps_)
    for p in ps_:
        assert sss.PedersenVSS.verify_share(
            t, p.id, (p.secret_share, p.t_secret_share), p.final_comm_coeffs, g, h
        )
    # a native participant among the port's spec participants
    py = sss.PedersenDVSSParticipant(1, t, 3, g, h)
    nat = native.DvssParticipant(2, t, 3, g, h)
    py3 = sss.PedersenDVSSParticipant(3, t, 3, g, h)
    group = [py, nat, py3]
    for recv in group:
        for sender in group:
            if sender.id != recv.id:
                recv.received_share(
                    sender.id, sender.comm_coeffs,
                    (sender.s_shares[recv.id], sender.t_shares[recv.id]), t, 3, g, h,
                )
    for p in group:
        p.compute_final_comm_coeffs_and_shares(t, 3, g, h)
    assert nat.final_comm_coeffs == py.final_comm_coeffs
    assert sss.reconstruct_secret(t, {1: py.secret_share, 2: nat.secret_share}) == (
        sss.reconstruct_secret(t, {2: nat.secret_share, 3: py3.secret_share})
    )
    with pytest.raises(GeneralError, match="already has a share"):
        nat.received_share(1, py.comm_coeffs, (py.s_shares[2], py.t_shares[2]))
    with pytest.raises(GeneralError, match="its own share"):
        nat.received_share(2, nat.comm_coeffs, (nat.s_shares[2], nat.t_shares[2]))
    fresh = native.DvssParticipant(3, t, 3, g, h)
    with pytest.raises(GeneralError, match="failed verification"):
        fresh.received_share(1, py.comm_coeffs, ((py.s_shares[3] + 1) % R, py.t_shares[3]))
    with pytest.raises(GeneralError, match="missing pairwise shares"):
        fresh.compute_final_comm_coeffs_and_shares()
    # the reference's native participants deal and combine the same way
    jps_ = jnative.share_secret_dvss(t, 3, g, h)
    assert jsss.reconstruct_secret(t, {p.id: p.secret_share for p in jps_[:2]}) == (
        jsss.reconstruct_secret(t, {p.id: p.secret_share for p in jps_[1:]})
    )


def test_derive_params_matches_the_reference():
    assert native.derive_params(2, b"label") == jnative.derive_params(2, b"label")


# --- the build ---------------------------------------------------------------


def test_library_is_built_into_build_only():
    lib = native.build()
    assert lib.parent == ROOT / "build" and lib.name.startswith("libccbls-")
    assert Path(native.load()._name) == lib
    assert native.SOURCE == ROOT / "native" / "ccbls.cpp"


def test_concurrent_builds_publish_one_whole_library(tmp_path, monkeypatch):
    """Two threads building at once into an empty directory: each compiles
    to its own temporary name and renames, so both return one library
    that loads and passes its selftest, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = [None, None]

    def run(i):
        out[i] = native.build()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out[0] == out[1] and out[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [out[0].name]
    native._bind(str(out[0]))


def test_ccbls_so_names_the_library_to_load(tmp_path):
    """CCBLS_SO loads the named library and builds nothing."""
    lib = tmp_path / "libccbls-copy.so"
    lib.write_bytes(native.build().read_bytes())
    code = (
        "from coconut_tpu_torch import native\n"
        "native.BUILD_DIR = None\n"
        "print(native.load()._name)\n"
    )
    env = dict(os.environ, CCBLS_SO=str(lib))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        check=True,
    )
    assert out.stdout.strip() == str(lib)


# --- the spec path of batch_prepare_blind_sign -------------------------------


def test_spec_prepare_hashes_through_the_native_batch(monkeypatch):
    """With no device hash the spec path hashes every request's generator
    in one native batch; the generators are the spec's hash_to_g1 of the
    same bytes. Without the library it hashes on the spec: the same bits."""
    params, _, _, epk, msgs = entry.issue_fixture(3)
    calls = []
    batch = native.hash_to_g1_batch
    monkeypatch.setattr(native, "hash_to_g1_batch", lambda d: calls.append(len(d)) or batch(d))
    out = sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epk, params, ps.SPEC)
    assert calls == [3]
    ctx = params.ctx
    datas = [sig.SignatureRequest.hash_input(r.commitment, r.known_messages, ctx) for r, _ in out]
    want = [hashing.hash_to_g1(d) for d in datas]
    assert [r.get_h(ctx) for r, _ in out] == want == jnative.hash_to_g1_batch(datas)

    monkeypatch.setattr(native, "available", lambda: False)
    again = sig.batch_prepare_blind_sign(msgs, entry.ISSUANCE_HIDDEN, epk, params, ps.SPEC)
    assert calls == [3]
    fresh = [sig.SignatureRequest.hash_input(r.commitment, r.known_messages, ctx) for r, _ in again]
    assert [r.get_h(ctx) for r, _ in again] == [hashing.hash_to_g1(d) for d in fresh]
