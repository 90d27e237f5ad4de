"""The ledger cell `cfg5_ledger.mixed`: its generator and pools, the plain
reference of a ledger, the readers of its six per-layer metrics over
synthetic runs, its BENCHMARK.json entries, and its output check at a
tiny size on the CPU through the whole harness but its look for a card
(`core.execute`): sound (correct), the control (the ledger's grouped mode:
not correct, wrong verdicts above 0) and the three faults of
test_portbench_faults.py planted under the timed path (not correct), on a
backend that pads the base axis as the card's does. A few minutes on one
CPU core."""

import collections
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import core, ledger
from portbench.reference import checks
from portbench.reference import ledger as reference
from portbench.reference.fields import R
from portbench.tests.test_portbench_faults import Faulty, _fault

SPEC = core.load_spec()
CELL = "cfg5_ledger.mixed"
SEED = 2**31 + 2111
SCHEMAS = [2, 3, 4, 5, 6, 6, 7, 8]
#: three segments of 16 records, each record's issuer drawn from the seed:
#: issuer batches of 8, full ones and padded tails; half the records forged
SIZES = {"segment": 16, "batch": 8, "batch_s": 0.34, "pool": 8, "forge_every": 2, "spec_sample": 4}
METRICS = {
    "device.idle_pct.ledger": ("device_trace", "device", "lower"),
    "fp_mul_roofline.ledger": ("device_trace", "field kernel", "higher"),
    "program.graph_replay_pct.ledger": ("program_counter", "backend programs", "higher"),
    "program.graph_captures.ledger": ("program_counter", "backend programs", "lower"),
    "program.pad_lane_pct.ledger": ("program_counter", "stream", "lower"),
    "stream.route_ms.ledger": ("program_span", "stream", "lower"),
}


# --- the generator, the pools and the reference ------------------------------


@pytest.mark.parametrize("seed", (1, 2**31 + 977, 2**33 + 5))
def test_segment_plans_repeat_draw_issuers_per_record_and_forge_within_the_schema(seed):
    plan = ledger.segment_plan(seed, 5, 1024, 4096, 64, SCHEMAS)
    assert plan == ledger.segment_plan(seed, 5, 1024, 4096, 64, SCHEMAS)
    assert plan != ledger.segment_plan(seed, 6, 1024, 4096, 64, SCHEMAS)
    owners = collections.Counter(i for (i, _), _ in plan)
    # each issuer's share is binomial(4096, 1/8): mean 512, sd ~21.2
    assert set(owners) == set(range(8)) and sum(owners.values()) == 4096
    assert all(abs(n - 512) < 6 * 21.2 for n in owners.values())
    for i in range(8):
        picks = [p for (j, p), _ in plan if j == i]
        assert len(set(picks)) == owners[i] and all(0 <= p < 1024 for p in picks)
    forged = [(i, a) for (i, _), a in plan if a is not None]
    assert len(forged) == 64 and all(0 <= a < SCHEMAS[i] for i, a in forged)


def test_issuer_shares_vary_by_segment_and_are_uniform_over_many():
    """The issuer of a record is drawn on its own: segments differ in
    their shares, and over 64 segments the shares pass a chi-square test
    of uniformity (7 degrees of freedom, 0.1 % level: 24.32)."""
    plans = [ledger.segment_plan(2**31 + 4099, i, 1024, 4096, 64, SCHEMAS) for i in range(64)]
    shares = [collections.Counter(i for (i, _), _ in plan) for plan in plans]
    assert len({tuple(sorted(c.items())) for c in shares}) > 1
    assert any(c[i] != 512 for c in shares for i in range(8))
    total = sum(shares, collections.Counter())
    expect = 64 * 4096 / 8
    assert sum((total[i] - expect) ** 2 / expect for i in range(8)) < 24.32
    # a position's issuer is independent of the position: no issuer holds
    # a fixed residue of the segment
    for i in range(8):
        assert len({pos % 8 for plan in plans[:4] for pos, ((j, _), _) in enumerate(plan) if j == i}) == 8


def test_small_pools_and_uneven_shares():
    plan = ledger.segment_plan(9, 0, 4, 19, 3, [2, 5])
    owners = collections.Counter(i for (i, _), _ in plan)
    assert sum(owners.values()) == 19 and set(owners) <= {0, 1}
    for i, n in owners.items():
        picks = [p for (j, p), _ in plan if j == i]
        assert len(picks) == n and all(0 <= p < 4 for p in picks)
        assert collections.Counter(picks).most_common(1)[0][1] <= -(-n // 4)
    assert sum(a is not None for _, a in plan) == 6


def test_pools_share_params_and_verify_only_under_their_own_issuer():
    pools = ledger._pools(2**31 + 11, 2, [2, 5])
    assert pools == ledger._pools(2**31 + 11, 2, [2, 5])
    assert len(pools["params"]["h"]) == 5
    keys = {i: iss["sk"] for i, iss in enumerate(pools["issuers"])}
    for i, iss in enumerate(pools["issuers"]):
        assert len(iss["vk"][1]) == [2, 5][i]
        for (_, _, msgs), logs in zip(iss["creds"], iss["logs"]):
            assert len(msgs) == [2, 5][i]
            assert reference.verify_exp((i, logs, msgs), keys)
            assert not reference.verify_exp((1 - i, logs, (msgs + [0] * 5)[: [2, 5][1 - i]]), keys)
            bad = list(msgs)
            bad[-1] = (bad[-1] + 1) % R
            assert not reference.verify_exp((i, logs, bad), keys)


def test_reference_pairing_check_agrees_with_the_signing_key_check():
    pools = ledger._pools(2**31 + 12, 1, [2, 3])
    verkeys = {i: iss["vk"] for i, iss in enumerate(pools["issuers"])}
    keys = {i: iss["sk"] for i, iss in enumerate(pools["issuers"])}
    s1, s2, msgs = pools["issuers"][1]["creds"][0]
    logs = pools["issuers"][1]["logs"][0]
    bad = [msgs[0], (msgs[1] + 1) % R, msgs[2]]
    for m, want in ((msgs, True), (bad, False)):
        assert reference.verify((1, (s1, s2), m), verkeys, pools["params"]) is want
        assert reference.verdicts_exp([(1, logs, m)], keys) == [want]
    assert checks.ps_verify(s1, s2, msgs[:2], verkeys[0], pools["params"]) is False


def test_kept_pools_key_holds_this_files_digest(tmp_path, monkeypatch):
    from portbench.harness import fixtures

    monkeypatch.setattr(fixtures, "CACHE_DIR", tmp_path)
    fresh = ledger.pools(2**31 + 13, 1, [2])
    assert ledger.pools(2**31 + 13, 1, [2]) == fresh
    (kept,) = tmp_path.glob("ledger-*.pickle")
    monkeypatch.setattr(ledger, "_DIGEST", "another")
    ledger.pools(2**31 + 13, 1, [2])
    assert len(list(tmp_path.glob("ledger-*.pickle"))) == 2


# --- the readers --------------------------------------------------------------


def _run(counters=None, stages=None):
    return SimpleNamespace(counters=counters or {}, stages=stages or {}, trace=None, widths={})


def test_readers_over_synthetic_runs():
    read = {m: core.reader(m) for m in METRICS}
    counters = {"ledger_dispatches": 64, "ledger_lanes": 262144, "ledger_pad_lanes": 8192,
                "verify_graph_replays": 64}
    run = _run(counters, {"route": (62, 0.124)})
    assert read["program.graph_replay_pct.ledger"](run) == 100.0
    assert read["program.graph_captures.ledger"](run) == 0
    assert read["program.pad_lane_pct.ledger"](run) == pytest.approx(100.0 * 8192 / 262144)
    assert read["stream.route_ms.ledger"](run) == pytest.approx(2.0)
    run = _run(dict(counters, verify_graph_captures=2, verify_graph_replays=63))
    assert read["program.graph_captures.ledger"](run) == 2
    assert read["program.graph_replay_pct.ledger"](run) == pytest.approx(100.0 * 63 / 64)
    no_pad = dict(counters)
    del no_pad["ledger_pad_lanes"]
    assert read["program.pad_lane_pct.ledger"](_run(no_pad)) == 0.0
    assert read["device.idle_pct.ledger"](run) is None
    assert read["fp_mul_roofline.ledger"](run) is None


def test_readers_read_nothing_from_a_program_without_the_ledger():
    """A program that has no ledger (the parent of the cell) moves none of
    its counters and spans: every reader gives None and none raises."""
    run = _run({"verify_graph_replays": 21, "verify_graph_captures": 1}, {"dispatch": (21, 11.0)})
    for name in METRICS:
        assert core.reader(name)(run) is None, name


def test_entries():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name, (source, layer, better) in METRICS.items():
        m = entries[name]
        assert (m["source"], m["layer"], m["better"]) == (source, layer, better)
        assert m["workloads"] == [CELL] and m["moves"] == "verifies_per_s"
    assert {m["name"] for m in core.cell_metrics(SPEC, CELL, 1)} == set(METRICS)
    assert {m["name"] for m in core.cell_metrics(SPEC, CELL, 0)} == {"verifies_per_s", "setup_s"}
    cell, config, traffic = core.cell_files(SPEC, CELL)
    assert cell["chips"] == 1 and config["schemas"] == SCHEMAS and config["issuers"] == 8
    assert config["published"]["ledger_stream_credentials"] == 1048576
    assert traffic["segment"] == traffic["batch"] == 4096 and traffic["pool"] == 1024


def test_the_runner_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.harness import core\n"
        "from portbench.harness.runners import ledger_verify\n"
        "for m in %r: core.reader(m)\n"
        "print(core.forbidden_modules())\n" % (str(core.ROOT), sorted(METRICS))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- the output check on the CPU ----------------------------------------------


class PaddingFaulty(Faulty):
    """test_portbench_faults.Faulty on a verify that takes pad_bases_to,
    so the ledger pads under it as it does on the card."""

    def batch_verify_async(self, sigs, msgs, vk, params, pad_bases_to=None):
        fin = self._inner.batch_verify_async(sigs, msgs, vk, params, pad_bases_to=pad_bases_to)
        return lambda: self._plant(fin())


def _execute(**kw):
    torch.set_num_threads(2)
    result, _ = core.execute(
        SPEC, CELL, SEED, 1.0, 0, torch.device("cpu"), time.perf_counter(), sizes=SIZES, **kw
    )
    return result


def test_sound_run_is_correct():
    result = _execute()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 48


def test_control_is_not_correct():
    result = _execute(control=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.parametrize("kind", ["altered", "stale", "half"])
def test_planted_fault_is_not_correct(kind):
    plant = _fault(kind)
    result = _execute(wrap=lambda be: PaddingFaulty(be, plant))
    assert not result["correct"], (kind, result["checks"])
