"""The port's online verify service (`coconut_tpu_torch.serve`, the engine
under it, retry, faults, errors, metrics) against the JAX package's.

Each scripted scenario runs once through `coconut_tpu`'s classes and once
through `coconut_tpu_torch`'s, on the same stub backends and a fake clock
with the watchdog thread off, and the two runs must agree exactly on every
request's verdict (or error class), the dead-letter records (trace and span
ids masked), and every counter of the package's own metrics registry.
The stubs decide verdicts from a flag on each credential, so no pairing
runs; the fallback case and the slice test use real credentials on the
host spec and on `TorchBackend(device="cpu")`. JaxBackend is never built.
Tolerance: exact — verdicts are bits and counters integers.
"""

import importlib
import random
import threading
from types import SimpleNamespace

import pytest

PACKAGES = ("coconut_tpu", "coconut_tpu_torch")


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        errors=imp("errors"),
        faults=imp("faults"),
        retry=imp("retry"),
        serve=imp("serve"),
        health=imp("serve.health"),
        service=imp("serve.service"),
        stream=imp("stream"),
    )


# --- stubs (the kind tests/test_serve.py defines) ---------------------------


def _cred(ok=True):
    return SimpleNamespace(sigma_1=1, sigma_2=1, ok=ok)


def _lane_bit(s):
    return s.sigma_1 is not None and bool(getattr(s, "ok", False))


class StubPerCred:
    def __init__(self):
        self.batch_sizes = []

    def batch_verify(self, sigs, msgs, vk, params):
        self.batch_sizes.append(len(sigs))
        return [_lane_bit(s) for s in sigs]


class StubGrouped:
    def batch_verify_grouped(self, sigs, msgs, vk, params):
        return all(_lane_bit(s) for s in sigs)


class StubCombined:
    def batch_verify_combined(self, sigs, msgs, vk, params):
        return all(_lane_bit(s) for s in sigs)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- harness -----------------------------------------------------------------


def _service(pkg, backend, clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("watchdog_interval_s", None)
    kw.setdefault(
        "watchdog",
        pkg.health.Watchdog(clock=clock, k=2.0, min_timeout_s=1.0, initial_timeout_s=1.0),
    )
    kw.setdefault("health_policy", pkg.health.HealthPolicy(probe_after_s=5.0, probe_successes=1))
    return pkg.serve.CredentialService(backend, None, None, clock=clock, **kw)


def _outcomes(futs, timeout=20.0):
    """Each future's verdict, or the class name of its exception."""
    out = []
    for f in futs:
        exc = f.exception(timeout)
        out.append(type(exc).__name__ if exc is not None else f.result(0))
    return out


def _dead_letters(pkg, path):
    recs = pkg.faults.DeadLetterLog.read(str(path))
    return [dict(r, trace_id=None, span_id=None) for r in recs]


def _counters(pkg):
    return pkg.metrics.snapshot()["counters"]


def _run_both(scenario, tmp_path):
    """scenario(pkg, dir) -> dict of observations, for both packages."""
    got = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        pkg.metrics.reset()
        d = tmp_path / name
        d.mkdir()
        try:
            got[name] = scenario(pkg, d)
        finally:
            pkg.metrics.reset()
    return got[PACKAGES[0]], got[PACKAGES[1]]


# --- scenarios ---------------------------------------------------------------


def per_credential_padded(pkg, d):
    be = StubPerCred()
    svc = _service(pkg, be, FakeClock())
    futs = [svc.submit(_cred(i != 2), [i]) for i in range(6)]
    svc.start()
    assert svc.drain(timeout=20.0)
    return {
        "verdicts": _outcomes(futs), "sizes": be.batch_sizes, "counters": _counters(pkg),
        "watchdog": (svc._watchdog.inflight(), svc._watchdog.ema("0") is not None),
    }


def _one_bad_lane(mode, backend):
    def scenario(pkg, d):
        dl = d / "dead.jsonl"
        svc = _service(pkg, backend(), FakeClock(), mode=mode, dead_letter_path=str(dl))
        futs = [svc.submit(_cred(i != 2), [i]) for i in range(4)]
        futs += [svc.submit(_cred(), [i]) for i in range(4)]
        svc.start()
        assert svc.drain(timeout=20.0)
        return {
            "verdicts": _outcomes(futs),
            "dead_letters": _dead_letters(pkg, dl),
            "counters": _counters(pkg),
        }

    return scenario


def retried_dispatch(pkg, d):
    be = pkg.faults.FaultyBackend(StubPerCred(), raise_on={0})
    sleeps = []
    policy = pkg.retry.RetryPolicy(max_attempts=2, base_delay=0.0, sleep=sleeps.append)
    svc = _service(pkg, be, FakeClock(), retry_policy=policy)
    futs = [svc.submit(_cred(i != 1), [i]) for i in range(4)]
    svc.start()
    assert svc.drain(timeout=20.0)
    return {"verdicts": _outcomes(futs), "sleeps": sleeps, "counters": _counters(pkg)}


def crash_redistributed(pkg, d):
    be = pkg.faults.FaultyBackend(StubPerCred(), crash_on={0})
    svc = _service(pkg, be, FakeClock(), devices=2, max_batch=2)
    futs = [svc.submit(_cred(), [i]) for i in range(2)]
    svc.start()
    first = _outcomes(futs)
    health = [pkg.metrics.get_gauge("serve_dev%d_health" % i) for i in range(2)]
    futs2 = [svc.submit(_cred(i == 0), [i]) for i in range(2)]
    out = {"verdicts": first + _outcomes(futs2), "health": health, "crashes": be.crashes}
    assert svc.drain(timeout=20.0)
    out["counters"] = _counters(pkg)
    return out


def hop_cap(pkg, d):
    be = pkg.faults.FaultyBackend(StubPerCred(), crash_on={0, 1})
    svc = _service(pkg, be, FakeClock(), devices=3, max_batch=2, max_redispatch=1)
    futs = [svc.submit(_cred(), [i]) for i in range(2)]
    svc.start()
    first = _outcomes(futs)
    futs2 = [svc.submit(_cred(), [i]) for i in range(2)]
    out = {
        "verdicts": first + _outcomes(futs2),
        "crashed": svc._crashed is not None,
        "health": [pkg.metrics.get_gauge("serve_dev%d_health" % i) for i in range(3)],
    }
    assert svc.drain(timeout=20.0)
    out["counters"] = _counters(pkg)
    return out


def watchdog_hang(pkg, d):
    clock = FakeClock()
    be = pkg.faults.FaultyBackend(StubPerCred(), hang_on={0})
    svc = _service(pkg, be, clock, devices=2, max_batch=2)
    futs = [svc.submit(_cred(), [i]) for i in range(2)]
    svc.start()
    try:
        assert be.hang_entered.wait(10.0)
        clock.advance(2.0)  # past the 1 s initial budget
        svc.health_tick()
        out = {
            "verdicts": _outcomes(futs),
            "health": [pkg.metrics.get_gauge("serve_dev%d_health" % i) for i in range(2)],
            "healthy": pkg.metrics.get_gauge("serve_healthy_executors"),
            "counters": _counters(pkg),
        }
    finally:
        be.hang_release.set()
    assert svc.drain(timeout=20.0)
    return out


def admission_and_close(pkg, d):
    svc = _service(pkg, StubPerCred(), FakeClock(), max_depth=2)
    futs = [svc.submit(_cred(), [i], lane="bulk") for i in range(1)]
    futs += [svc.submit(_cred(), [1])]
    errors = []
    try:
        svc.submit(_cred(), [2])
    except pkg.errors.ServiceOverloadedError as e:
        errors.append((type(e).__name__, e.code, e.depth, e.max_depth, e.retry_after_s, str(e)))
    svc.start()
    assert svc.drain(timeout=20.0)
    try:
        svc.submit(_cred(), [3])
    except pkg.errors.ServiceClosedError as e:
        errors.append((type(e).__name__, e.code, e.retry_after_s, str(e)))
    return {"verdicts": _outcomes(futs), "errors": errors, "counters": _counters(pkg)}


def brownout_sheds_bulk(pkg, d):
    svc = _service(
        pkg, StubPerCred(), FakeClock(), devices=2, max_batch=2,
        brownout=pkg.health.BrownoutPolicy(capacity_threshold=0.9, retry_after_s=0.25),
    )
    svc._health_of("0").on_crash("injected for the brownout case")
    shed = []
    try:
        svc.submit(_cred(), [0], lane="bulk")
    except pkg.errors.ServiceBrownoutError as e:
        shed.append((e.code, e.lane, e.retry_after_s, e.capacity_fraction, str(e)))
    svc.start()
    futs = [svc.submit(_cred(), [i]) for i in range(2)]
    out = {"verdicts": _outcomes(futs), "shed": shed}
    assert svc.drain(timeout=20.0)
    out["counters"] = _counters(pkg)
    return out


SCENARIOS = {
    "per_credential_padded": per_credential_padded,
    "grouped_bisected": _one_bad_lane("grouped", StubGrouped),
    "batched_bisected": _one_bad_lane("batched", StubCombined),
    "retried_dispatch": retried_dispatch,
    "crash_redistributed": crash_redistributed,
    "hop_cap": hop_cap,
    "watchdog_hang": watchdog_hang,
    "admission_and_close": admission_and_close,
    "brownout_sheds_bulk": brownout_sheds_bulk,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_matches_the_reference(name, tmp_path):
    ref, port = _run_both(SCENARIOS[name], tmp_path)
    assert port == ref
    assert port["counters"]  # the scenario moved the port's own registry


def test_scenarios_show_what_they_claim(tmp_path):
    """The shared scenarios' outcomes, pinned on the port."""
    pkg = _pkg("coconut_tpu_torch")
    pkg.metrics.reset()
    try:
        got = per_credential_padded(pkg, tmp_path)
        assert got["verdicts"] == [True, True, False, True, True, True]
        assert got["sizes"] == [4, 4] and got["counters"]["serve_pad_lanes"] == 2
        pkg.metrics.reset()
        (tmp_path / "g").mkdir()
        got = _one_bad_lane("grouped", StubGrouped)(pkg, tmp_path / "g")
        assert got["verdicts"] == [True, True, False, True] + [True] * 4
        assert [(r["batch"], r["credential"], r["program"]) for r in got["dead_letters"]] == [
            (0, 2, "verify")
        ]
        assert got["counters"]["bisections"] == 2
        pkg.metrics.reset()
        got = hop_cap(pkg, tmp_path)
        assert got["verdicts"] == ["InjectedCrash"] * 2 + [True, True]
        assert got["counters"]["serve_redispatch_exhausted"] == 1 and not got["crashed"]
        pkg.metrics.reset()
        got = watchdog_hang(pkg, tmp_path)
        assert got["verdicts"] == [True, True]
        assert got["counters"]["serve_watchdog_timeouts"] == 1
        assert got["health"] == ["quarantined", "healthy"]
    finally:
        pkg.metrics.reset()


# --- the fallback ladder on real credentials ---------------------------------


def _credentials(n, msg_count=2, forged=(), seed=0x5E7E):
    """(params, vk, sigs, msgs) of the JAX package, from the host spec."""
    from coconut_tpu.ops.curve import G1_GEN, G2_GEN
    from coconut_tpu.ops.fields import R
    from coconut_tpu.params import SIGNATURES_IN_G1, Params
    from coconut_tpu.signature import Signature, Verkey

    rng = random.Random(seed)
    ctx = SIGNATURES_IN_G1
    g = ctx.sig.mul(G1_GEN, rng.randrange(1, R))
    g_tilde = ctx.other.mul(G2_GEN, rng.randrange(1, R))
    h = [ctx.sig.mul(G1_GEN, rng.randrange(1, R)) for _ in range(msg_count)]
    params = Params(g, g_tilde, h, ctx)
    x, ys = rng.randrange(1, R), [rng.randrange(1, R) for _ in range(msg_count)]
    vk = Verkey(ctx.other.mul(g_tilde, x), [ctx.other.mul(g_tilde, y) for y in ys])
    sigs, msgs = [], []
    for i in range(n):
        m = [rng.randrange(R) for _ in range(msg_count)]
        s1 = ctx.sig.mul(g, rng.randrange(1, R))
        s2 = ctx.sig.mul(s1, (x + sum(y * v for y, v in zip(ys, m))) % R)
        if i in forged:
            s2 = ctx.sig.mul(s2, 2)
        sigs.append(Signature(s1, s2))
        msgs.append(m)
    return params, vk, sigs, msgs


def _port_credentials(params, vk, sigs):
    from coconut_tpu_torch import convert

    return (
        convert.params_from(params),
        convert.verkey_from(vk),
        [convert.signature_from(s) for s in sigs],
    )


def test_always_raising_primary_falls_back_to_the_spec(tmp_path):
    """A primary that raises on every dispatch, no retries: each batch
    lands on the host spec fallback ("python" in the reference, "spec" in
    the port) and the verdicts are the spec's."""
    params, vk, sigs, msgs = _credentials(3, forged={1})
    pparams, pvk, psigs = _port_credentials(params, vk, sigs)
    got = {}
    for name, fallback, state in (
        ("coconut_tpu", "python", (params, vk, sigs)),
        ("coconut_tpu_torch", "spec", (pparams, pvk, psigs)),
    ):
        pkg = _pkg(name)
        pkg.metrics.reset()
        p, v, ss = state
        be = pkg.faults.FaultyBackend(StubPerCred(), raise_every=1)
        svc = pkg.serve.CredentialService(
            be, v, p, max_batch=4, max_wait_ms=2.0, clock=FakeClock(),
            fallback_backend=fallback, watchdog_interval_s=None,
        )
        futs = [svc.submit(s, m) for s, m in zip(ss, msgs)]
        svc.start()
        assert svc.drain(timeout=60.0)
        got[name] = (_outcomes(futs), _counters(pkg))
        pkg.metrics.reset()
    assert got["coconut_tpu_torch"] == got["coconut_tpu"]
    verdicts, counters = got["coconut_tpu_torch"]
    assert verdicts == [True, False, True]
    assert counters["fallbacks"] == 1 and counters["verify_final_exps"] == 4


def test_spec_backend_matches_the_reference_python_backend():
    """SpecBackend's verify surface against PythonBackend's on the same
    credentials: per-credential bits (a pad lane included) and the combined
    check on an honest and on a forged batch."""
    from coconut_tpu.backend import PythonBackend
    from coconut_tpu_torch.backend import SpecBackend, get_backend
    from coconut_tpu_torch.serve.batcher import PAD_CREDENTIAL

    params, vk, sigs, msgs = _credentials(3, forged={2})
    pparams, pvk, psigs = _port_credentials(params, vk, sigs)
    ref, spec = PythonBackend(), SpecBackend()
    want = ref.batch_verify(sigs + [PAD_CREDENTIAL], msgs + [msgs[0]], vk, params)
    assert want == [True, True, False, False]
    assert spec.batch_verify(psigs + [PAD_CREDENTIAL], msgs + [msgs[0]], pvk, pparams) == want
    for lo, hi in ((0, 2), (0, 3)):
        assert spec.batch_verify_combined(
            psigs[lo:hi], msgs[lo:hi], pvk, pparams
        ) == ref.batch_verify_combined(sigs[lo:hi], msgs[lo:hi], vk, params)
    assert isinstance(get_backend("python"), SpecBackend)
    assert isinstance(get_backend("spec"), SpecBackend)
    with pytest.raises(ValueError):
        get_backend("jax")


# --- the slice: the service over TorchBackend on the CPU ---------------------


class _Recording:
    """Passes batch_verify_async through and keeps every batch's raw bits,
    pad lanes included."""

    def __init__(self, inner):
        self.inner = inner
        self.bits = []

    def batch_verify_async(self, sigs, msgs, vk, params):
        fin = self.inner.batch_verify_async(sigs, msgs, vk, params)

        def finalize():
            out = fin()
            self.bits.append(list(out))
            return out

        return finalize


def test_slice_service_on_torch_cpu_matches_the_spec():
    """CredentialService(TorchBackend(device="cpu")) in per_credential mode
    at max_batch=4: three requests, one forged, plus one identity pad lane.
    The verdicts equal the JAX package's PythonBackend.batch_verify on the
    same credentials (carried across by convert.py), the pad lane is False
    and dropped by demux, and the batch went through the backend once."""
    import torch

    from coconut_tpu.backend import PythonBackend
    from coconut_tpu_torch import metrics
    from coconut_tpu_torch.gpu.backend import TorchBackend
    from coconut_tpu_torch.serve import CredentialService

    params, vk, sigs, msgs = _credentials(3, msg_count=6, forged={1}, seed=0x51CE)
    want = PythonBackend().batch_verify(sigs, msgs, vk, params)
    assert want == [True, False, True]
    pparams, pvk, psigs = _port_credentials(params, vk, sigs)
    be = _Recording(TorchBackend(device="cpu", comb_window=4))
    metrics.reset()
    # two intra-op threads, as the other port test modules run: with
    # torch's default of one a core in each of several workers, these
    # small ops slow down many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        svc = CredentialService(be, pvk, pparams, max_batch=4, max_wait_ms=1.0)
        # queued before start, as the other scenarios: the batcher then
        # sees all three at its first pop and flushes them as one batch
        futs = [svc.submit(s, m) for s, m in zip(psigs, msgs)]
        svc.start()
        got = [f.result(120.0) for f in futs]
        assert svc.drain(timeout=120.0)
        assert got == want
        assert be.bits == [want + [False]]
        assert metrics.get_count("serve_pad_lanes") == 1
        assert metrics.get_count("serve_dev0_dispatches") == 1
        assert metrics.get_count("serve_valid") == 2
        assert metrics.get_count("serve_invalid") == 1
    finally:
        torch.set_num_threads(threads)
        metrics.reset()


def test_default_backend_is_torch_on_cuda_and_a_mesh_is_accepted():
    """backend=None is a TorchBackend on cuda (raises without a card); a
    mesh adds the sharded executor, and a mesh without its tp axis raises
    the reference's ValueError, word for word."""
    import torch

    from coconut_tpu.tpu import shard as ref_shard
    from coconut_tpu_torch.gpu.backend import TorchBackend
    from coconut_tpu_torch.gpu.shard import default_mesh
    from coconut_tpu_torch.serve import CredentialService

    if torch.cuda.is_available():
        svc = CredentialService(None, None, None)
        assert svc.backend.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CredentialService(None, None, None)
    be = TorchBackend(device="cpu")
    mesh = default_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    svc = CredentialService(be, None, None, mesh=mesh, watchdog_interval_s=None)
    assert [ex.label for ex in svc._all_executors()] == ["0", "mesh"]
    assert svc.mesh is mesh
    no_tp = SimpleNamespace(shape={"dp": 2})
    with pytest.raises(ValueError) as want:
        ref_shard.require_axes(no_tp, "dp", "tp")
    with pytest.raises(ValueError) as got:
        CredentialService(be, None, None, mesh=no_tp)
    assert str(got.value) == str(want.value)


# --- retry and errors ---------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"base_delay": 0.1, "max_delay": 1.0, "jitter": 0.0},
        {"base_delay": 0.02, "max_delay": 0.5, "jitter": 1.0},
        {"base_delay": 0.3, "max_delay": 30.0, "jitter": 0.25},
    ],
)
def test_retry_backoff_grid_matches_the_reference(kw):
    from coconut_tpu import retry as ref
    from coconut_tpu_torch import retry as port

    a, b = ref.RetryPolicy(**kw), port.RetryPolicy(**kw)
    grid = [(att, key) for att in range(1, 9) for key in (0, 1, 7, 1023, "b3", (2, 5))]
    assert [b.backoff(att, key=key) for att, key in grid] == [
        a.backoff(att, key=key) for att, key in grid
    ]


def test_call_with_retry_ladder_matches_the_reference():
    """The same flaky callable through both ladders: attempt records,
    sleeps, counters, then the fallback on exhaustion."""
    out = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        pkg.metrics.reset()
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise pkg.errors.TransientBackendError("flake %d" % len(calls))
            return "ok"

        policy = pkg.retry.RetryPolicy(max_attempts=4, base_delay=0.05, sleep=sleeps.append)
        attempts = []
        first = pkg.retry.call_with_retry(flaky, policy, key=9, attempts=attempts)
        always = lambda: (_ for _ in ()).throw(pkg.errors.TransientBackendError("down"))
        second = pkg.retry.call_with_retry(
            always, policy, key=3, fallback=lambda: "fallback"
        )
        out[name] = (first, attempts, sleeps, second, _counters(pkg))
        pkg.metrics.reset()
    assert out["coconut_tpu_torch"] == out["coconut_tpu"]


ERROR_CASES = [
    ("TransientBackendError", ("dispatch lost",), {}),
    ("ServiceRetryableError", ("busy",), {"program": "verify", "retry_after_s": float("inf")}),
    ("ServiceOverloadedError", (7, 7), {"program": "verify", "retry_after_s": 0.02}),
    ("ServiceBrownoutError", ("bulk", 0.75), {"depth": 3, "capacity_fraction": 0.5}),
    ("ServiceClosedError", ("draining",), {"retry_after_s": -1}),
    ("CheckpointCorruptError", ("checkpoint CRC mismatch",), {}),
    ("CheckpointMismatchError", ("0123abcd", "feedbeef"), {}),
]


@pytest.mark.parametrize("cls,args,kw", ERROR_CASES, ids=[c[0] for c in ERROR_CASES])
def test_error_classes_match_the_reference(cls, args, kw):
    """Name, code, retriable flag (a ServiceRetryableError), message and
    the attributes each class carries."""
    seen = []
    for name in PACKAGES:
        errors = importlib.import_module(name + ".errors")
        e = getattr(errors, cls)(*args, **kw)
        attrs = {
            k: v for k, v in vars(e).items() if not k.startswith("_")
        }
        seen.append((
            type(e).__name__, e.code, isinstance(e, errors.ServiceRetryableError),
            isinstance(e, errors.CoconutError), str(e), attrs,
        ))
    assert seen[1] == seen[0]


def test_future_callbacks_and_single_assignment():
    from coconut_tpu_torch.serve import ServeFuture

    f, seen = ServeFuture(), []
    f.add_done_callback(lambda fut: seen.append(fut.result(0)))
    f.set_result(True)
    f.set_exception(RuntimeError("late"))  # ignored
    f.add_done_callback(lambda fut: seen.append("again"))
    assert seen == [True, "again"] and f.result(0) is True
    g = ServeFuture()
    with pytest.raises(TimeoutError):
        g.result(timeout=0.001)
    done = threading.Event()
    g.add_done_callback(lambda fut: done.set())
    g.set_exception(ValueError("x"))
    assert done.is_set() and isinstance(g.exception(0), ValueError)


# --- threads: the executor pool calls the backend concurrently --------------


def test_plain_calls_and_caches_are_exact_under_threads():
    """More threads than cores with a short switch interval: every call of
    the plain multiply is counted, and the backend's LRU survives
    concurrent gets and puts with evictions (a lost update or a KeyError
    out of move_to_end would show)."""
    import sys

    import torch

    from coconut_tpu_torch.gpu import cuda_fp
    from coconut_tpu_torch.gpu.backend import _LRU

    a = torch.zeros(2, 52)
    lru = _LRU(4)
    errors, n_threads, per = [], 16, 40
    start = threading.Barrier(n_threads)

    def work(t):
        try:
            start.wait(10.0)
            for i in range(per):
                cuda_fp.mul_plain(a, a)
                lru.put((t, i % 6), i)
                lru.get((t, (i + 3) % 6))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = cuda_fp.PLAIN_CALLS
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert cuda_fp.PLAIN_CALLS == before + n_threads * per
    assert len(lru._d) <= 4
