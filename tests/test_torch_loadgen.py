"""The port's load generator (`coconut_tpu_torch.serve.loadgen`) and the
metrics it reads against the JAX package's, on the CPU.

- The mixed verify + issue workload on stub backends (a verify stub and a
  stub authority pool with a stub minter, as tests/test_issue.py drives
  the reference's): the port's report has the reference's keys, section by
  section, and its counts agree with the port's own metrics registry.
- `issue_fraction` and the other refusals, `latency_percentiles`,
  `restart_to_first_slo`, the availability timeline, `_Tally`'s outcome
  split and the metrics readers, each on the same inputs in both packages.

Runs use the wall clock (the report's rates do); the comparisons hold
only what does not depend on it. Tolerance: exact.
"""

import importlib
import time
from concurrent.futures import Future
from types import SimpleNamespace

import pytest

PACKAGES = ("coconut_tpu", "coconut_tpu_torch")


def _pkg(name):
    imp = lambda mod: importlib.import_module("%s.%s" % (name, mod))
    return SimpleNamespace(
        name=name,
        metrics=imp("metrics"),
        errors=imp("errors"),
        issue=imp("issue"),
        serve=imp("serve"),
        loadgen=imp("serve.loadgen"),
    )


class VerifyStub:
    def batch_verify(self, sigs, msgs, vk, params):
        return [s.sigma_1 is not None and s.ok for s in sigs]


class StubSign:
    def batch_blind_sign(self, sig_requests, sigkey, params):
        return [("partial", sigkey, req) for req in sig_requests]


class StubMinter:
    def unblind(self, blind_rows, sks):
        return blind_rows

    def aggregate(self, subset, sig_rows):
        return [SimpleNamespace(subset=tuple(subset)) for _ in sig_rows]

    def verify(self, creds, messages_list, subset):
        return [True] * len(creds)

    def verify_partial(self, signer_id, sig, messages):
        return True


def _services(pkg):
    vsvc = pkg.serve.CredentialService(
        VerifyStub(), None, None, max_batch=4, max_wait_ms=1.0, watchdog_interval_s=None,
    )
    signers = [SimpleNamespace(id=i + 1, sigkey="sk", verkey="vk") for i in range(5)]
    isvc = pkg.issue.IssuanceService(
        signers, None, 3, backends=[StubSign() for _ in range(5)], minter=StubMinter(),
        max_batch=4, max_wait_ms=1.0, watchdog_interval_s=None,
    )
    return vsvc.start(), isvc.start()


def _mixed(pkg, arrival):
    vsvc, isvc = _services(pkg)
    good = SimpleNamespace(sigma_1=1, sigma_2=1, ok=True)
    bad = SimpleNamespace(sigma_1=1, sigma_2=1, ok=False)
    try:
        report = pkg.loadgen.run_loadgen(
            vsvc, [(good, [0], True), (bad, [0], False)], duration_s=0.3, arrival=arrival,
            concurrency=4, rate_per_s=400.0, issue_service=isvc,
            issue_pool=[("req", ["m"], "esk")], issue_fraction=0.5,
        )
    finally:
        assert vsvc.drain(timeout=10.0) and isvc.drain(timeout=10.0)
    return report


def _keys(report):
    """The report's key structure: nested sections' keys, the rest None."""
    return {
        k: _keys(v) if isinstance(v, dict) and k in ("issue", "availability", "latency_s") else None
        for k, v in report.items()
    }


@pytest.mark.parametrize("arrival", ["closed", "open"])
def test_mixed_workload_report_matches_the_reference(arrival):
    """Both packages' mixed reports have the same keys in every section;
    the port's counts agree with its metrics: every verify completed with
    its expected verdict, every issuance minted, nothing dropped, and the
    issue section's minted count, fan-outs and occupancy are the
    counters' deltas."""
    reports = {}
    for name in PACKAGES:
        p = _pkg(name)
        p.metrics.reset()
        try:
            report = _mixed(p, arrival)
            m = p.metrics
            issue = report["issue"]
            assert report["issue_fraction"] == 0.5 and report["arrival"] == arrival
            assert issue["minted"] > 0 and report["completed"] > 0
            assert issue["minted"] == m.get_count("issue_minted") == issue["submitted"]
            assert issue["fanouts"] == m.get_count("issue_batches")
            assert issue["mean_batch_occupancy"] == round(
                m.get_count("issue_batched_requests") / (issue["fanouts"] * 4), 4
            )
            assert (issue["errors"], issue["dropped_futures"], issue["mint_mismatches"]) == (0, 0, 0)
            assert report["completed"] == report["submitted"] == m.get_count("serve_admitted")
            assert report["valid"] == m.get_count("serve_valid")
            assert report["invalid"] == m.get_count("serve_invalid")
            assert (report["verdict_mismatches"], report["dropped_futures"], report["errors"]) == (0, 0, 0)
            assert report["batches"] == m.get_count("serve_batches")
            assert sum(report["availability"]["per_second_goodput"]) == report["completed"]
            assert report["rpc_overhead_s"] is None
            reports[name] = report
        finally:
            p.metrics.reset()
    assert _keys(reports["coconut_tpu_torch"]) == _keys(reports["coconut_tpu"])


def _refusal(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


def test_refusals_match_the_reference():
    """The argument checks raise ValueError with the reference's messages;
    transport="rpc" raises ValueError in the port, in run_loadgen and in
    run_session_loadgen, until the gateway is ported."""
    out = {}
    for name in PACKAGES:
        lg = _pkg(name).loadgen
        out[name] = [
            _refusal(lambda: lg.run_loadgen(None, [], issue_fraction=0.0)),
            _refusal(lambda: lg.run_loadgen(None, [1], arrival="burst")),
            _refusal(lambda: lg.run_loadgen(None, [1], transport="carrier-pigeon")),
            _refusal(lambda: lg.run_loadgen(None, [1], issue_fraction=0.5)),
            _refusal(lambda: lg.run_loadgen(None, [1], issue_fraction=0.5,
                                            issue_service=object(), issue_pool=[])),
            _refusal(lambda: lg.run_loadgen(None, [1], issue_fraction=1.5,
                                            issue_service=object(), issue_pool=[1])),
            _refusal(lambda: lg.run_loadgen(None, [1], issue_fraction=-0.1)),
            _refusal(lambda: lg.run_session_loadgen(None, [])),
            _refusal(lambda: lg.run_session_loadgen(None, [1], transport="x")),
        ]
    assert out["coconut_tpu_torch"] == out["coconut_tpu"]
    assert all(out["coconut_tpu"])
    lg = _pkg("coconut_tpu_torch").loadgen
    with pytest.raises(ValueError, match="not ported"):
        lg.run_loadgen(None, [1], transport="rpc")
    with pytest.raises(ValueError, match="not ported"):
        lg.run_session_loadgen(None, [1], transport="rpc")


@pytest.mark.parametrize(
    "samples",
    [[], [0.5], [0.3, 0.1, 0.2], [float(i) / 7 for i in range(1, 101)], [2.0, 2.0, 1.0, 9.5]],
    ids=["empty", "one", "three", "hundred", "ties"],
)
def test_latency_percentiles_match_the_reference(samples):
    got = [_pkg(n).loadgen.latency_percentiles(list(samples)) for n in PACKAGES]
    assert got[1] == got[0]


def _events():
    """(t_absolute, latency | None, ok) events of a 4-second run from t0 =
    100: errors in second 1, a slow completion, then compliant ones."""
    return [
        (100.2, 0.1, True), (101.1, None, False), (101.5, None, False),
        (102.0, 3.0, True), (102.4, 0.4, True), (103.9, 0.2, True), (104.0, 0.05, True),
    ]


@pytest.mark.parametrize("t_mark,slo_s", [(0.0, 0.5), (1.0, 0.5), (1.0, 5.0), (3.5, 0.1), (9.0, 1.0)])
def test_availability_and_restart_to_first_slo_match_the_reference(t_mark, slo_s):
    got = []
    for name in PACKAGES:
        lg = _pkg(name).loadgen
        avail = lg.availability_timeline(_events(), 100.0, 4.0)
        got.append((avail, lg.restart_to_first_slo(avail, t_mark, slo_s)))
    assert got[1] == got[0]
    assert got[0][0]["per_second_errors"] == [0, 2, 0, 0]


def test_tally_splits_outcomes_as_the_reference():
    """_Tally.settle on a verdict, a mismatch, a retryable refusal, a
    transient error, a terminal error and a future that never resolves."""
    got = []
    for name in PACKAGES:
        p = _pkg(name)
        tally = p.loadgen._Tally()
        clock = lambda: 5.0
        outcomes = [
            (True, True), (False, True),
            (p.errors.ServiceOverloadedError(3, 3), True),
            (p.errors.TransientBackendError("x"), True),
            (RuntimeError("boom"), True),
            (None, True),  # never resolves
        ]
        for value, expect in outcomes:
            fut = Future()
            if isinstance(value, BaseException):
                fut.set_exception(value)
            elif value is not None:
                fut.set_result(value)
            tally.settle(fut, expect, 4.0, clock, 0.01)
        got.append({
            k: getattr(tally, k) for k in (
                "submitted", "completed", "errors", "errors_retryable", "errors_terminal",
                "dropped", "valid", "invalid", "mismatches", "latencies", "events",
            )
        })
    assert got[1] == got[0]
    assert (got[0]["errors_retryable"], got[0]["errors_terminal"], got[0]["dropped"]) == (2, 1, 1)


def test_metrics_readers_match_the_reference():
    """timers_with_prefix, hist_totals and rate after the same records."""
    got = []
    for name in PACKAGES:
        m = _pkg(name).metrics
        m.reset()
        try:
            with m.timer("serve_dev0_busy_s"):
                time.sleep(0.001)
            m.count("serve_dev0_dispatches", 3)
            for v in (0.5, 1.5, 2.0):
                m.observe("issue_latency_s", v)
            timers = m.timers_with_prefix("serve_dev")
            rate = m.rate("serve_dev0_dispatches", "serve_dev0_busy_s")
            got.append((
                sorted(timers), rate == 3 / timers["serve_dev0_busy_s"],
                m.hist_totals("issue_latency_s"), m.hist_totals("absent"),
                m.rate("absent", "serve_dev0_busy_s"), m.timers_with_prefix("none"),
            ))
        finally:
            m.reset()
    assert got[1] == got[0] == (["serve_dev0_busy_s"], True, (3, 4.0), (0, 0.0), None, {})
