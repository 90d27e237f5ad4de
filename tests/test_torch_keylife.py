"""The port's dealerless key lifecycle (`coconut_tpu_torch.keylife`, the
Pedersen VSS / DVSS of `sss.py`, the lifecycle errors) and the epoch-keyed
verify path against the JAX package's, on the CPU.

- DKG, refresh and reshare: both packages' KeyLifecycleManager run the same
  rounds under one seeded `secrets.randbelow` stream (both packages'
  `rand_fr` call it); complaints, QUAL, every share and the verkey bytes
  must be equal. Also the typed abort when QUAL is short.
- The VSS reject paths and a scripted EpochRegistry sequence: the same
  exception types, dealer ids and messages, states, wire codes and
  `keylife_*` counters as the reference.
- No master secret: the online lifecycle never calls an in-process
  aggregation entry point.
- Epoch-keyed verify: two epochs' verkeys coexist in TorchBackend's
  static-operand LRU, and a CredentialService with a keychain splits a
  batch over two epochs into two dispatches whose verdicts equal the
  reference's PythonBackend under each epoch's verkey.

Two attributes (`MSGS`), 3-of-5 authorities. Tolerance: exact — shares,
bytes, verdicts and counters.
"""

import random
import secrets

import pytest

from coconut_tpu_torch import convert
from torch_show_helpers import two_torch_threads  # noqa: F401 (autouse)

PACKAGES = ("coconut_tpu", "coconut_tpu_torch")
MSGS = 2
LABEL = b"test-torch-keylife"
SEED = 0x4B1F


def _mods(name):
    import importlib

    imp = lambda m: importlib.import_module("%s.%s" % (name, m))
    return imp("keylife"), imp("params"), imp("sss"), imp("errors"), imp("metrics")


def _tamper_one(dealer, recipient, dim=0):
    def tamper(d, r, dm, share):
        if (d, r, dm) == (dealer, recipient, dim):
            return (share[0] + 1, share[1])
        return None

    return tamper


def _shares(signers):
    return [(s.id, s.sigkey.x, tuple(s.sigkey.y)) for s in signers]


def _vk_bytes(vk, params):
    return vk.to_bytes(params.ctx)


def _lifecycle(name):
    """Bootstrap (dealer 2 tampers its share to 4), refresh, reshare to
    2-of-5, all under one seeded draw stream."""
    keylife, params_mod, _, _, metrics = _mods(name)
    metrics.reset()
    saved = secrets.randbelow
    secrets.randbelow = random.Random(SEED).randrange
    try:
        params = params_mod.Params.new(MSGS, LABEL)
        mgr = keylife.KeyLifecycleManager(params, label=LABEL, window=3)
        out = {"params": params, "mgr": mgr, "rounds": [], "keysets": []}
        for step in (
            lambda: mgr.bootstrap(3, 5, tamper=_tamper_one(2, 4)),
            mgr.refresh,
            lambda: mgr.reshare(threshold=2, total=5),
        ):
            out["keysets"].append(step())
            out["rounds"].append(mgr.last_round)
    finally:
        secrets.randbelow = saved
    out["counters"] = {
        k: v for k, v in metrics.snapshot()["counters"].items() if k.startswith("keylife_")
    }
    metrics.reset()
    return out


@pytest.fixture(scope="module")
def lifecycles():
    return {name: _lifecycle(name) for name in PACKAGES}


def test_dkg_refresh_reshare_match_the_reference(lifecycles):
    ref, port = lifecycles["coconut_tpu"], lifecycles["coconut_tpu_torch"]
    for jr, tr in zip(ref["rounds"], port["rounds"]):
        assert tr._fields == jr._fields
        assert (tr.complaints, tr.qual, tr.excluded, tr.threshold, tr.total) == (
            jr.complaints, jr.qual, jr.excluded, jr.threshold, jr.total,
        )
        assert _shares(tr.signers) == _shares(jr.signers)
        assert [_vk_bytes(s.verkey, port["params"]) for s in tr.signers] == [
            _vk_bytes(s.verkey, ref["params"]) for s in jr.signers
        ]
    assert port["rounds"][0].complaints == {2: (4,)}
    assert port["rounds"][0].excluded == (2,)
    for jk, tk in zip(ref["keysets"], port["keysets"]):
        assert (tk.epoch, tk.gen, tk.threshold, tk.qual, tk.excluded) == (
            jk.epoch, jk.gen, jk.threshold, jk.qual, jk.excluded,
        )
        assert _vk_bytes(tk.vk, port["params"]) == _vk_bytes(jk.vk, ref["params"])
    # the refresh kept the verkey byte for byte and moved every share
    boot, refreshed, reshared = port["keysets"]
    assert _vk_bytes(refreshed.vk, port["params"]) == _vk_bytes(boot.vk, port["params"])
    assert all(a[1:] != b[1:] for a, b in zip(_shares(boot.signers), _shares(refreshed.signers)))
    assert _vk_bytes(reshared.vk, port["params"]) != _vk_bytes(boot.vk, port["params"])
    from coconut_tpu_torch.keylife import aggregate_vk

    assert _vk_bytes(aggregate_vk(reshared), port["params"]) == _vk_bytes(reshared.vk, port["params"])
    assert port["counters"] == ref["counters"]
    assert port["counters"]["keylife_refreshes"] == 1


def test_dkg_aborts_typed_when_qual_is_short():
    got = {}
    for name in PACKAGES:
        keylife, params_mod, sss, errors, _ = _mods(name)
        params = params_mod.Params.new(MSGS, LABEL)
        g, h = sss.PedersenVSS.gens(LABEL)
        with pytest.raises(errors.DkgAbortedError) as ei:
            keylife.run_dkg(2, 3, params, g, h, unreachable={1, 2})
        err = ei.value
        assert isinstance(err, errors.ServiceRetryableError)
        got[name] = (str(err), err.code, err.needed, err.qualified, err.excluded)
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    assert got["coconut_tpu"][1:] == ("dkg_aborted", 2, 1, (1, 2))


# --- the VSS reject paths ------------------------------------------------------


def _reject(case, sss, g, h):
    V = sss.PedersenVSS
    if case == "bad_threshold":
        return lambda: V.deal(4, 3, g, h)
    if case in ("own_share", "duplicate_dealer"):
        p = sss.PedersenDVSSParticipant(1, 2, 3, g, h)
        dealer = sss.PedersenDVSSParticipant(2, 2, 3, g, h)
        if case == "own_share":
            return lambda: p.received_share(
                1, p.comm_coeffs, (p.s_shares[1], p.t_shares[1]), 2, 3, g, h
            )
        share = (dealer.s_shares[1], dealer.t_shares[1])
        p.received_share(2, dealer.comm_coeffs, share, 2, 3, g, h)
        return lambda: p.received_share(2, dealer.comm_coeffs, share, 2, 3, g, h)
    _, _, comm, s_shares, t_shares = V.deal(2, 3, g, h)
    if case == "tampered_share":
        return lambda: V.check_share(
            2, 2, (s_shares[2] + 1, t_shares[2]), comm, g, h, dealer_id=7, round="dkg"
        )
    if case == "tampered_commitment":
        bad = dict(comm)
        bad[1] = V.ops.add(bad[1], g)
        return lambda: V.check_share(2, 1, (s_shares[1], t_shares[1]), bad, g, h, dealer_id=1)
    assert case == "wrong_recipient"
    return lambda: V.check_share(2, 3, (s_shares[2], t_shares[2]), comm, g, h, dealer_id=1)


@pytest.mark.parametrize(
    "case",
    ["tampered_share", "tampered_commitment", "wrong_recipient", "own_share",
     "duplicate_dealer", "bad_threshold"],
)
def test_vss_reject_paths_match_the_reference(case, monkeypatch):
    got = {}
    for name in PACKAGES:
        _, _, sss, _, _ = _mods(name)
        monkeypatch.setattr(secrets, "randbelow", random.Random(SEED).randrange)
        g, h = sss.PedersenVSS.gens(LABEL)
        call = _reject(case, sss, g, h)
        with pytest.raises(Exception) as ei:
            call()
        err = ei.value
        got[name] = (type(err).__name__, str(err), getattr(err, "dealer_id", None),
                     getattr(err, "round", None), getattr(err, "code", None))
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    want_type = "GeneralError" if case == "bad_threshold" else "ShareVerificationError"
    assert got["coconut_tpu"][0] == want_type


def test_deal_zero_and_the_dvss_round_match_the_reference(monkeypatch):
    got = {}
    for name in PACKAGES:
        _, params_mod, sss, _, _ = _mods(name)
        import importlib

        keygen = importlib.import_module("%s.keygen" % name)
        monkeypatch.setattr(secrets, "randbelow", random.Random(SEED).randrange)
        g, h = sss.PedersenVSS.gens(LABEL)
        b0, comm, s_shares, t_shares = sss.PedersenVSS.deal_zero(3, 5, g, h)
        assert comm[0] == sss.PedersenVSS.ops.mul(h, b0)
        assert sss.reconstruct_secret(3, s_shares) == 0
        params = params_mod.Params.new(1, LABEL)
        sx, sy, signers = keygen.dvss_keygen(2, 3, params, g, h)
        pv = keygen.trusted_party_PVSS_keygen(2, 3, params, g, h)
        assert all(
            sss.PedersenVSS.verify_share(2, i, (pv.x_shares[i], pv.x_t_shares[i]),
                                         pv.comm_coeff_x, g, h)
            for i in (1, 2, 3)
        )
        got[name] = (b0, comm, s_shares, sx, sy, _shares(signers), pv.secret_x, pv.x_shares)
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]


# --- the epoch registry --------------------------------------------------------


def _registry_script(name):
    """register, activate, install_gen, pins across a refresh, window
    pressure with a pinned epoch, resolve of unknown / pending / retired."""
    keylife, _, _, errors, metrics = _mods(name)
    metrics.reset()
    ks = lambda e, gen=0: keylife.KeySet(e, gen, 2, [], vk=None)
    reg = keylife.EpochRegistry(window=2)
    log = []
    retired = []
    reg.add_retire_hook(retired.append)

    def note(what, fn):
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — the class and message are the record
            log.append((what, type(e).__name__, str(e), getattr(e, "code", None),
                        getattr(e, "epoch", None), getattr(e, "live", None)))
            return None
        log.append((what, "ok", repr(out)))
        return out

    note("next", reg.next_epoch)
    note("register1", lambda: reg.register(ks(1)))
    note("resolve_pending", lambda: reg.resolve(1))
    note("activate1", lambda: reg.activate(1))
    note("register1_again", lambda: reg.register(ks(1)))
    note("activate1_again", lambda: reg.activate(1))
    note("activate9", lambda: reg.activate(9))
    old = note("pin_g0", reg.pin_active)
    note("install_gen1", lambda: reg.install_gen(ks(1, gen=1)))
    note("install_gen5", lambda: reg.install_gen(ks(1, gen=5)))
    new = note("pin_g1", reg.pin_active)
    note("pins1", lambda: reg.pin_count(1))
    for e in (2, 3):
        note("register%d" % e, lambda e=e: reg.register(ks(e)))
        note("activate%d" % e, lambda e=e: reg.activate(e))
        log.append(("live%d" % e, reg.live_epochs(), reg.state(1), reg.active_epoch))
    note("resolve1_pinned", lambda: reg.resolve(1).key)
    note("unpin_old", lambda: reg.unpin(old))
    log.append(("after_unpin_old", reg.live_epochs(), reg.state(1)))
    note("unpin_new", lambda: reg.unpin(new))
    log.append(("after_unpin_new", reg.live_epochs(), reg.state(1), reg.state(2), reg.state(99)))
    note("resolve2_retired", lambda: reg.resolve(2))
    note("resolve99", lambda: reg.resolve(99))
    note("vk_for3", lambda: reg.vk_for(3))
    log.append(("codes", keylife.EPOCH_STATE_CODES, keylife.EPOCH_STATE_OF_CODE))
    log.append(("retired_hooks", retired))
    snap = metrics.snapshot()
    counters = {k: v for k, v in snap["counters"].items() if k.startswith("keylife_")}
    gauges = {k: v for k, v in snap["gauges"].items() if k.startswith("keylife_")}
    metrics.reset()
    return log, counters, gauges


def test_registry_sequence_matches_the_reference():
    ref = _registry_script("coconut_tpu")
    port = _registry_script("coconut_tpu_torch")
    assert port == ref
    log, counters, _ = port
    records = {rec[0]: rec[1:] for rec in log}
    # the pinned epoch 1 deferred its retirement, so the window retired
    # the younger unpinned epoch 2 first
    assert records["resolve1_pinned"] == ("ok", "(1, 1)")
    assert records["resolve2_retired"][0] == "EpochRetiredError"
    assert records["resolve99"][0] == "EpochUnknownError"
    assert counters["keylife_retirements"] == 1
    assert counters["keylife_epoch_unknown"] == 2  # the pending epoch and 99


def test_registry_store_is_refused_until_state_is_ported(tmp_path):
    """The port has `state/` now, so `store=` is accepted: a registry over
    a StateStore journals its epochs, and a new registry over the same
    store knows them. A window of 0 still refuses."""
    from coconut_tpu_torch.keylife import EpochRegistry
    from coconut_tpu_torch.keylife.epoch import KeySet
    from coconut_tpu_torch.state import StateStore

    store = StateStore(str(tmp_path / "s"))
    reg = EpochRegistry(store=store)
    reg.register(KeySet(1, 0, 2, [], None))
    assert store.get("epoch", "1") == {"event": "registered"}
    assert EpochRegistry(store=store).next_epoch() == 2
    store.close()
    with pytest.raises(ValueError, match="window"):
        EpochRegistry(window=0)


# --- no master secret ----------------------------------------------------------


def test_online_lifecycle_never_aggregates_in_process(monkeypatch):
    """Every in-process master-secret entry point of the port is booby-
    trapped; bootstrap, refresh and reshare complete without them."""
    import coconut_tpu_torch.keygen as keygen_mod
    import coconut_tpu_torch.sss as sss_mod
    from coconut_tpu_torch.keylife import DkgResult, KeyLifecycleManager
    from coconut_tpu_torch.params import Params

    def boom(*a, **k):
        raise AssertionError("master-secret aggregation on the online DKG path")

    for mod, name in (
        (sss_mod, "reconstruct_secret"),
        (sss_mod, "get_shared_secret"),
        (sss_mod, "share_secret_dvss"),
        (keygen_mod, "get_shared_secret"),
        (keygen_mod, "dvss_keygen"),
        (keygen_mod, "setup_signers_for_test"),
        (keygen_mod, "trusted_party_SSS_keygen"),
        (keygen_mod, "trusted_party_PVSS_keygen"),
    ):
        monkeypatch.setattr(mod, name, boom)
    assert DkgResult._fields == (
        "signers", "qual", "excluded", "complaints", "threshold", "total",
    )
    mgr = KeyLifecycleManager(Params.new(MSGS, LABEL), label=b"keylife-noagg")
    ks1 = mgr.bootstrap(2, 3)
    ks1r = mgr.refresh()
    ks2 = mgr.reshare()
    assert (ks1.epoch, ks1r.gen, ks2.epoch) == (1, 1, 2)


# --- epoch-keyed verify ----------------------------------------------------------


def test_epoch_verkeys_coexist_in_the_static_operand_cache(lifecycles):
    """Across a rollover both epochs' verkeys are in play. On a cpu
    TorchBackend their static-operand entries coexist in the 32-entry LRU:
    one build each, then hits only, also with 30 other entries crowding."""
    from coconut_tpu_torch.gpu.backend import TorchBackend

    port = lifecycles["coconut_tpu_torch"]
    params = port["params"]
    ks1, _, ks2 = port["keysets"]
    be = TorchBackend(device="cpu")
    builds = []

    def lookup(ks):
        return be._static_operands(
            "verify", ks.vk, params, None, lambda: builds.append(ks.epoch) or ("tables", ks.epoch)
        )

    assert lookup(ks1) == ("tables", 1)
    assert lookup(ks2) == ("tables", 2)
    for _ in range(8):
        assert lookup(ks1)[1] == 1
        assert lookup(ks2)[1] == 2
    assert builds == [1, 2]
    assert (be.encode_cache_misses, be.encode_cache_hits) == (2, 16)
    for i in range(30):
        be._static_operands("verify", ks1.vk, params, ("pad", i), lambda: ("other",))
        lookup(ks1)
        lookup(ks2)
    assert builds == [1, 2]


def _mint(sig_mod, params, keyset, msgs, seed):
    """A credential under `keyset` from `threshold` partials signed on the
    host spec with the authorities' shares (h drawn from `seed`)."""
    rng = random.Random(seed)
    ctx = params.ctx
    h = ctx.sig.mul(params.g, rng.randrange(1, _R()))
    parts = []
    for s in keyset.signers[: keyset.threshold]:
        e = (s.sigkey.x + sum(y * m for y, m in zip(s.sigkey.y, msgs))) % _R()
        parts.append((s.id, sig_mod.Signature(h, ctx.sig.mul(h, e))))
    return sig_mod.Signature.aggregate(keyset.threshold, parts, ctx)


def _R():
    from coconut_tpu_torch.ops.fields import R

    return R


def test_epoch_dispatch_matches_the_reference(lifecycles):
    """One coalesced batch of 4 credentials over epochs 1 and 2 (lane 2
    forged) through CredentialService(keychain=...) on a cpu TorchBackend:
    two dispatches, one an epoch, each under its own verkey; the verdicts
    equal PythonBackend.batch_verify under each epoch's verkey. An unknown
    epoch refuses at submit."""
    from coconut_tpu import signature as jsig
    from coconut_tpu.backend import PythonBackend
    from coconut_tpu_torch.errors import EpochUnknownError
    from coconut_tpu_torch.gpu.backend import TorchBackend
    from coconut_tpu_torch.keylife import EpochRegistry
    from coconut_tpu_torch.serve import CredentialService

    ref = lifecycles["coconut_tpu"]
    jparams = ref["params"]
    jk1, _, jk2 = ref["keysets"]
    rng = random.Random(SEED)
    msgs = [[rng.randrange(_R()) for _ in range(MSGS)] for _ in range(4)]
    epochs = [1, 2, 1, 2]
    jcreds = [
        _mint(jsig, jparams, jk1 if e == 1 else jk2, m, seed=i)
        for i, (e, m) in enumerate(zip(epochs, msgs))
    ]
    jcreds[2] = jsig.Signature(jcreds[2].sigma_1, jparams.ctx.sig.mul(jcreds[2].sigma_2, 2))
    want = [None] * 4
    for e, jk in ((1, jk1), (2, jk2)):
        idx = [i for i in range(4) if epochs[i] == e]
        bits = PythonBackend().batch_verify([jcreds[i] for i in idx], [msgs[i] for i in idx], jk.vk, jparams)
        for i, b in zip(idx, bits):
            want[i] = bool(b)
    assert want == [True, True, False, True]

    params = lifecycles["coconut_tpu_torch"]["params"]
    reg = EpochRegistry(window=3)
    for jk in (jk1, jk2):
        reg.register(convert.keyset_from(jk))
        reg.activate(jk.epoch)
    creds = []
    for c, e in zip(jcreds, epochs):
        pc = convert.signature_from(c)
        pc.epoch = e
        creds.append(pc)
    svc = CredentialService(
        TorchBackend(device="cpu", comb_window=4), reg.vk_for(1), params,
        max_batch=4, max_wait_ms=1.0, keychain=reg,
    )
    launched = []
    split = svc._program._dispatch_by_epoch

    def counting(fn, sigs, messages_list):
        def counted(s, m, vk):
            launched.append((len(s), vk.to_bytes(params.ctx)))
            return fn(s, m, vk)

        return split(counted, sigs, messages_list)

    svc._program._dispatch_by_epoch = counting
    futs = [svc.submit(c, m) for c, m in zip(creds, msgs)]
    with pytest.raises(EpochUnknownError, match="unknown key epoch 42"):
        bad = convert.signature_from(jcreds[0])
        bad.epoch = 42
        svc.submit(bad, msgs[0])
    svc.start()
    got = [f.result(300.0) for f in futs]
    assert svc.drain(timeout=120.0)
    assert got == want
    assert launched == [
        (2, reg.vk_for(1).to_bytes(params.ctx)), (2, reg.vk_for(2).to_bytes(params.ctx)),
    ]
    with pytest.raises(ValueError, match="per_credential"):
        CredentialService("spec", None, params, mode="grouped", keychain=reg)
