"""The port's invariant lint suite (`coconut_tpu_torch/analysis/`), with
the cases of tests/test_analysis.py carried over to the port's checkers.

  - NON-VACUITY: each checker fires on a seeded-bad fixture tree under
    `coconut_tpu_torch/` (an ABBA lock pair, an un-wired exception raise,
    a secret-tainted branch, a bare durable write, an undocumented
    counter);
  - REAL TREE: one cached `run_all` over the repo scans the port and must
    report zero NEW findings against the port's own baseline
    (`coconut_tpu_torch/analysis_baseline.json`), the gate
    `python -m coconut_tpu_torch.analysis --fail-on-new` applies;
  - the runtime tracker (`analysis/lockcheck.py`): the ABBA, Condition and
    re-entry cases, and a short CredentialService run with the tracker
    installed before the port is imported, so every lock the port
    allocates is tracked, `gpu/serial.DEVICE_LOCK` included;
  - the dead-letter schema validator.

Host-only AST and threading work: no device, no torch kernel.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from coconut_tpu_torch import errors
from coconut_tpu_torch.analysis import core, lockcheck, run_all, schema
from coconut_tpu_torch.analysis import (
    consttime,
    durability,
    lockorder,
    metricsdoc,
    wirecontract,
)
from coconut_tpu_torch.analysis.__main__ import main as analysis_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_tree(tmp_path, files):
    """Materialize {relpath: source} under tmp_path; returns the root."""
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(tmp_path)


# -- lock-order (static) ----------------------------------------------------


LOCK_ABBA = """
    import threading

    class Pool:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def fwd(self):
            with self._a:
                with self._b:
                    pass

        def rev(self):
            with self._b:
                with self._a:
                    pass
    """


def test_lockorder_fires_on_abba(tmp_path):
    root = make_tree(tmp_path, {"coconut_tpu_torch/pool.py": LOCK_ABBA})
    findings = lockorder.run(core.Context(root))
    assert len(findings) == 1
    f = findings[0]
    assert f.checker == "lock-order" and f.rule == "cycle"
    assert "_a" in f.message and "_b" in f.message
    assert "fwd" in f.message and "rev" in f.message


def test_lockorder_clean_on_consistent_order(tmp_path):
    consistent = LOCK_ABBA.replace(
        "with self._b:\n                with self._a:",
        "with self._a:\n                with self._b:",
    )
    root = make_tree(tmp_path, {"coconut_tpu_torch/pool.py": consistent})
    assert lockorder.run(core.Context(root)) == []


def test_lockorder_real_tree_graph_is_acyclic():
    ctx = core.Context(REPO_ROOT)
    edges, attr_owners, _mods = lockorder.build_graph(ctx)
    # the tree defines real locks; the pass must SEE them (non-vacuous)
    assert len(attr_owners) >= 5
    assert lockorder.run(ctx) == []


# -- wire-contract ----------------------------------------------------------


RAISES_UNWIRED = """
    from . import errors

    def handler(n):
        if n > 2:
            raise errors.UnsupportedNoOfMessages(
                "valid for 2 messages but given %d" % n
            )
    """


def test_wirecontract_fires_on_unwired_raise(tmp_path, monkeypatch):
    # simulate the pre-fix tree: the class exists but its code was never
    # registered in WIRE_ERROR_CODES
    monkeypatch.delitem(errors.WIRE_ERROR_CODES, "unsupported_messages")
    root = make_tree(tmp_path, {"coconut_tpu_torch/rpcmod.py": RAISES_UNWIRED})
    findings = wirecontract.check_raised_classes(core.Context(root))
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "missing-code"
    assert "UnsupportedNoOfMessages" in f.message


def test_wirecontract_skips_non_rpc_paths(tmp_path, monkeypatch):
    monkeypatch.delitem(errors.WIRE_ERROR_CODES, "unsupported_messages")
    root = make_tree(
        tmp_path, {"coconut_tpu_torch/serve/loadgen.py": RAISES_UNWIRED}
    )
    assert wirecontract.check_raised_classes(core.Context(root)) == []


def test_wirecontract_round_trip_clean_on_real_module():
    # every registered code decodes as its class, preserves the message,
    # survives repr() (class-level defaults), and normalizes junk
    # retry_after_s — the executable half of the contract
    assert wirecontract.check_round_trip(core.Context(REPO_ROOT)) == []


# -- const-time -------------------------------------------------------------


SECRET_BRANCH = """
    def poly_eval(coeffs, x):
        if len(coeffs) == 0:   # len() sanitizes: sizes are public
            return 0
        acc = 0
        for c in coeffs:
            if c:              # secret-branch: c is tainted via coeffs
                acc += int(c)  # secret-cast: big-int cost leaks bits
        return acc
    """


def test_consttime_fires_on_tainted_branch_and_cast(tmp_path):
    root = make_tree(tmp_path, {"coconut_tpu_torch/sss.py": SECRET_BRANCH})
    findings = consttime.run(core.Context(root))
    rules = sorted(f.rule for f in findings)
    assert rules == ["secret-branch", "secret-cast"]
    assert all("poly_eval" in f.message for f in findings)
    # the len() guard on line 2 must NOT be among the flagged lines
    assert all(f.line != 2 for f in findings)


def test_consttime_secret_call_results_are_tainted(tmp_path):
    src = """
    def blind(params):
        r = rand_fr(params)
        if r:
            return 1
        return 0
    """
    root = make_tree(tmp_path, {"coconut_tpu_torch/signature.py": src})
    findings = consttime.run(core.Context(root))
    assert [f.rule for f in findings] == ["secret-branch"]


def test_consttime_out_of_scope_files_are_ignored(tmp_path):
    root = make_tree(tmp_path, {"coconut_tpu_torch/serve/queue.py": SECRET_BRANCH})
    assert consttime.run(core.Context(root)) == []


# -- durability -------------------------------------------------------------


BARE_WRITE = """
    import json

    def save(path, doc):
        with open(path, "w") as f:
            json.dump(doc, f)

    def save_logged(path, doc):
        # lint: allow(durability, test fixture: append-only artifact)
        with open(path, "a") as f:
            json.dump(doc, f)

    def load(path):
        with open(path) as f:
            return json.load(f)
    """


def test_durability_fires_on_bare_write_and_respects_pragma(tmp_path):
    root = make_tree(tmp_path, {"coconut_tpu_torch/store.py": BARE_WRITE})
    ctx = core.Context(root)
    findings = durability.run(ctx)
    # both write-mode opens are findings; the read-mode open is not
    assert len(findings) == 2
    assert all(f.rule == "bare-write" for f in findings)
    new = core.apply_suppressions(findings, ctx, {})
    # the pragma'd append is suppressed; the bare "w" open is NEW
    assert len(new) == 1
    assert new[0].line == min(f.line for f in findings)
    assert "open(path" in new[0].message


def test_durability_blessed_modules_exempt(tmp_path):
    root = make_tree(tmp_path, {"coconut_tpu_torch/state/atomic.py": BARE_WRITE})
    assert durability.run(core.Context(root)) == []


# -- metrics-doc ------------------------------------------------------------


METRICS_FIXTURE = {
    "coconut_tpu_torch/mod.py": """
    from . import metrics

    def work(i):
        metrics.count("zz_alive_total")
        metrics.count("zz_rogue_counter")
        metrics.count("zz_dev%d_load" % i)
    """,
    "README.md": """
    # fixture

    Metric glossary: counters `zz_alive_total`, `zz_dev<d>_load` and
    `zz_gone_counter`.
    """,
}


def test_metricsdoc_fires_both_directions(tmp_path):
    root = make_tree(tmp_path, METRICS_FIXTURE)
    findings = metricsdoc.run(core.Context(root))
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    # zz_rogue_counter emitted but undocumented
    assert len(by_rule.get("undocumented", [])) == 1
    assert "zz_rogue_counter" in by_rule["undocumented"][0].message
    # zz_gone_counter documented but never emitted (family zz IS emitted)
    assert len(by_rule.get("stale", [])) == 1
    assert "zz_gone_counter" in by_rule["stale"][0].message


def test_metricsdoc_wildcard_matches_placeholder():
    norm = metricsdoc._normalize_doc_token("serve_dev<d>_busy_s")
    assert metricsdoc.patterns_match("serve_dev*_busy_s", norm)
    assert metricsdoc.patterns_match("serve_dev*_busy_s", "serve_dev3_busy_s")
    assert not metricsdoc.patterns_match("serve_dev*_busy_s", "serve_depth")


# -- fingerprints / pragmas / runner ---------------------------------------


def test_fingerprint_ignores_line_numbers():
    a = core.Finding("durability", "bare-write", "coconut_tpu_torch/x.py", 10,
                     "msg", key="bare-write:open:path")
    b = core.Finding("durability", "bare-write", "coconut_tpu_torch/x.py", 99,
                     "other msg", key="bare-write:open:path")
    assert a.fingerprint == b.fingerprint


def test_pragma_reason_may_wrap(tmp_path):
    src = """
    def f(path):
        # lint: allow(durability, a long justification that wraps onto
        # the following comment line and keeps wrapping a little more)
        with open(path, "w") as f:
            f.write("x")
    """
    root = make_tree(tmp_path, {"coconut_tpu_torch/m.py": src})
    ctx = core.Context(root)
    findings = durability.run(ctx)
    assert len(findings) == 1
    assert core.apply_suppressions(findings, ctx, {}) == []
    assert findings[0].suppressed_by == "pragma"


def test_cli_gate_and_write_baseline(tmp_path, capsys):
    root = make_tree(
        tmp_path,
        {
            "coconut_tpu_torch/store.py": """
            def save(path, doc):
                with open(path, "w") as f:
                    f.write(doc)
            """
        },
    )
    baseline = str(tmp_path / "baseline.json")
    args = ["--root", root, "--baseline", baseline,
            "--checkers", "durability"]
    assert analysis_main(args + ["--fail-on-new"]) == 1
    assert analysis_main(args + ["--write-baseline"]) == 0
    with open(baseline) as f:
        doc = json.load(f)
    assert len(doc["suppressions"]) == 1
    # baselined finding no longer fails the gate
    assert analysis_main(args + ["--fail-on-new"]) == 0
    capsys.readouterr()


@pytest.fixture(scope="module")
def repo_run():
    baseline = os.path.join(REPO_ROOT, core.DEFAULT_BASELINE)
    return run_all(REPO_ROOT, baseline_path=baseline)


def test_clean_tree_zero_new_findings(repo_run):
    findings, new = repo_run
    assert new == [], "NEW findings (fix or justify with a pragma):\n%s" % (
        "\n".join(repr(f) for f in new)
    )


def test_remaining_suppressions_are_pragmas_with_reasons(repo_run):
    findings, _new = repo_run
    # the shipped baseline is empty: every accepted exception lives as an
    # inline pragma next to the code it excuses
    with open(os.path.join(REPO_ROOT, core.DEFAULT_BASELINE)) as f:
        doc = json.load(f)
    assert doc["suppressions"] == []
    assert all(f.suppressed_by == "pragma" for f in findings
               if f.suppressed_by is not None)


# -- runtime lock-order tracker --------------------------------------------


@pytest.fixture
def tracked(request):
    """A track-all tracker patched in for this test only, restoring any
    tracker installed before it."""
    prior = lockcheck._installed
    if prior is not None:
        lockcheck.uninstall()
    tracker = lockcheck.install(track_all=True)
    try:
        yield tracker
    finally:
        lockcheck.uninstall()
        if prior is not None:
            lockcheck.install(track_all=prior.track_all)


def test_lockcheck_detects_abba_inversion(tracked):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    inv = tracked.drain_inversions()
    assert len(inv) == 1
    assert inv[0]["held"] != inv[0]["acquiring"]
    assert "->" in inv[0]["prior_edge"]


def test_lockcheck_condition_and_thread_bootstrap(tracked):
    # regression: current_thread() inside note_acquire used to recurse
    # infinitely when thread bootstrap touched a tracked Condition lock
    cond = threading.Condition()
    hits = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hits.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify()
    t.join(5)
    assert hits == [1] and not t.is_alive()
    assert tracked.drain_inversions() == []


def test_lockcheck_rlock_reentry_is_not_an_edge(tracked):
    r = threading.RLock()
    with r:
        with r:
            pass
    assert tracked.edges == {}
    assert tracked.drain_inversions() == []


def test_lockcheck_consistent_order_records_no_inversion(tracked):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert tracked.drain_inversions() == []
    assert len(tracked.edges) == 1


def test_lockcheck_uninstall_restores_factories(request):
    prior = lockcheck._installed
    if prior is not None:
        lockcheck.uninstall()
    lockcheck.install(track_all=True)
    lockcheck.uninstall()
    assert threading.Lock is lockcheck._ORIG_LOCK
    assert threading.RLock is lockcheck._ORIG_RLOCK
    if prior is not None:
        lockcheck.install(track_all=prior.track_all)


# -- dead-letter schema validator ------------------------------------------


def _rec(**kw):
    rec = {
        "schema": 4,
        "batch": 1,
        "credential": 2,
        "reason": "forged",
        "attempts": [{"attempt": 1}],
        "trace_id": None,
        "span_id": None,
        "program": "verify",
        "nullifier": None,
    }
    rec.update(kw)
    return rec


def test_schema_valid_record():
    assert schema.validate_record(_rec()) == []


@pytest.mark.parametrize(
    "mutation, needle",
    [
        ({"schema": 3}, "schema"),
        ({"batch": "one"}, "type"),
        ({"batch": True}, "type"),  # bool is not an index
        ({"reason": None}, "null"),
        ({"credential": -1}, "negative"),
        ({"surprise": 1}, "unexpected"),
    ],
)
def test_schema_catches_bad_records(mutation, needle):
    problems = schema.validate_record(_rec(**mutation))
    assert problems and any(needle in p for p in problems)


def test_schema_missing_key():
    rec = _rec()
    del rec["nullifier"]
    problems = schema.validate_record(rec)
    assert any("missing key 'nullifier'" in p for p in problems)


def test_schema_file_torn_line_and_expectations(tmp_path):
    p = tmp_path / "dead.jsonl"
    p.write_text(
        json.dumps(_rec())
        + "\n"
        + json.dumps(_rec(batch=2, credential=0))
        + "\n"
        + '{"schema": 4, "ba'  # torn tail: crash mid-append
    )
    records, problems = schema.validate_file(str(p), [("batch", 1)])
    assert len(records) == 2
    assert any("unparseable" in x for x in problems)
    _records, problems = schema.validate_file(str(p), [("batch", 99)])
    assert any("no record with" in x for x in problems)


def test_schema_cli_gate(tmp_path, capsys):
    p = tmp_path / "dead.jsonl"
    p.write_text(json.dumps(_rec()) + "\n")
    assert schema.main([str(p), "--expect", "batch=1",
                        "--expect", "credential=2"]) == 0
    assert schema.main([str(p), "--expect", "batch=7"]) == 1
    capsys.readouterr()


# -- the runtime tracker over a service run -----------------------------------


SERVICE_RUN = """
import json
from coconut_tpu_torch.analysis import lockcheck

tracker = lockcheck.install()
from coconut_tpu_torch import entry
from coconut_tpu_torch.backend import SpecBackend
from coconut_tpu_torch.gpu import serial
from coconut_tpu_torch.serve import CredentialService


@serial.serialize_methods
class SerialSpec(SpecBackend):
    # the spec backend under the card backend's discipline: each call
    # holds gpu/serial.DEVICE_LOCK, as every TorchBackend method does
    def batch_verify(self, sigs, messages_list, vk, params):
        return SpecBackend.batch_verify(self, sigs, messages_list, vk, params)


params, _, vk, sigs, msgs = entry.fixture(8, msg_count=2)
msgs = [list(m) for m in msgs]
msgs[6][0] += 1
svc = CredentialService(SerialSpec(), vk, params, max_batch=8, max_wait_ms=5.0)
futs = [svc.submit(s, m) for s, m in zip(sigs, msgs)]
svc.start()
bits = [f.result(120.0) for f in futs]
drained = svc.drain(timeout=120.0)
print(json.dumps({
    "bits": bits,
    "drained": drained,
    "edges": sorted(tracker.edges),
    "inversions": tracker.drain_inversions(),
    "device_lock": getattr(serial.DEVICE_LOCK, "_site", None),
}))
"""


@pytest.fixture(scope="module")
def service_lock_graph():
    """The tracker's report of one CredentialService run at B = 8 (lane 6
    forged), in a fresh interpreter that installs it before importing the
    port."""
    out = subprocess.run(
        [sys.executable, "-c", SERVICE_RUN], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_service_run_records_no_lock_inversion(service_lock_graph):
    g = service_lock_graph
    assert g["bits"] == [i != 6 for i in range(8)] and g["drained"]
    assert g["inversions"] == []
    assert len(g["edges"]) >= 1


def test_service_lock_graph_holds_the_device_lock(service_lock_graph):
    site = service_lock_graph["device_lock"]
    assert site is not None and "coconut_tpu_torch/gpu/serial.py:" in site
    assert any(site in edge for edge in service_lock_graph["edges"])
