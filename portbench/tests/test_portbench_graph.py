"""The reader of the program's graph-replay counter: its value over a
synthetic run (the counter deltas and `record` that `core.Run` gives),
nothing where the counter did not move or no batch settled, and its
BENCHMARK.json entry."""

from types import SimpleNamespace

import pytest

from portbench.harness import core

SPEC = core.load_spec()
CELL = "cfg2_verify.bulk4096"
METRIC = "program.graph_replay_pct.verify"


def _run(counters, batches=21):
    return SimpleNamespace(counters=counters, record={"batches": batches})


@pytest.mark.parametrize("replays, want", [(21, 100.0), (20, 100.0 * 20 / 21), (1, 100.0 / 21)])
def test_reads_the_counters_delta_over_the_batches(replays, want):
    read = core.reader(METRIC)
    counters = {"verify_graph_replays": replays, "verify_graph_captures": 1, "prefetched_batches": 21}
    assert read(_run(counters)) == pytest.approx(want)


def test_reads_none_where_the_counter_is_absent_or_no_batch_settled():
    """A program without the counter (the parent of the graphs) reports
    no delta for it: None, not 0; no batch: None."""
    read = core.reader(METRIC)
    assert read(_run({"prefetched_batches": 21})) is None
    assert read(_run({})) is None
    assert read(_run({"verify_graph_replays": 3}, batches=0)) is None


def test_entry_names_its_file_and_the_bulk_cell():
    entry = {m["name"]: m for m in SPEC["per_layer"]}[METRIC]
    assert (core.BENCH / "metrics" / ("%s.py" % METRIC)).is_file()
    assert entry["workloads"] == [CELL]
    assert entry["source"] == "program_counter" and entry["unit"] == "%"
    assert entry["better"] == "higher" and entry["moves"] == "verifies_per_s"
    assert entry["layer"] == "backend programs"
    assert METRIC in {m["name"] for m in core.cell_metrics(SPEC, CELL, 1)}
