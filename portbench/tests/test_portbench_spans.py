"""The readers of the program's spans inside the verify dispatch: each
metric file's value over a synthetic run (the `stages` and `record` that
`core.Run` gives), nothing where its span is missing, and their
BENCHMARK.json entries."""

from types import SimpleNamespace

import pytest

from portbench.harness import core

SPEC = core.load_spec()
CELL = "cfg2_verify.bulk4096"

#: metric -> the span its file reads the mean of
SPAN_MEANS = {
    "backend.encode_ms.verify": "encode",
    "backend.enqueue_ms.verify": "enqueue",
    "program.comb_msm_ms.verify": "comb_msm",
    "program.affine_ms.verify": "affine",
    "program.miller_ms.verify": "miller_loop",
    "program.final_exp_ms.verify": "final_exp",
}
LOCK_WAIT = "stream.lock_wait_ms.verify"

#: a window of 4 batches: (count, total seconds) a span
STAGES = {
    "dispatch": (4, 8.0),
    "encode": (4, 0.4),
    "enqueue": (4, 7.2),
    "comb_msm": (4, 0.6),
    "affine": (4, 0.5),
    "miller_loop": (4, 4.0),
    "final_exp": (4, 2.0),
    "lock_wait.dispatch": (3, 0.003),
    "lock_wait.device": (4, 6.0),
}


def _run(stages, batches=4):
    return SimpleNamespace(stages=stages, record={"batches": batches})


def _expected(metric):
    if metric == LOCK_WAIT:
        return 1e3 * 0.003 / 4  # the worker's waits alone
    count, total = STAGES[SPAN_MEANS[metric]]
    return 1e3 * total / count


@pytest.mark.parametrize("metric", sorted(SPAN_MEANS) + [LOCK_WAIT])
def test_reader_value_and_silence(metric):
    """The value over the synthetic window; None where the span (for the
    lock wait: the backend's spans) is missing, and without the tracer."""
    read = core.reader(metric)
    assert read(_run(STAGES)) == pytest.approx(_expected(metric))
    missing = SPAN_MEANS.get(metric, "enqueue")
    assert read(_run({k: v for k, v in STAGES.items() if k != missing})) is None
    assert read(_run({})) is None


def test_lock_wait_reads_zero_without_waits():
    """Batches and backend spans but no wait of the worker's (the
    settle's waits do not count): 0.0, not None; no batch: None."""
    read = core.reader(LOCK_WAIT)
    quiet = {k: v for k, v in STAGES.items() if k != "lock_wait.dispatch"}
    assert read(_run(quiet)) == 0.0
    assert read(_run(quiet, batches=0)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_MEANS) + [LOCK_WAIT])
def test_entries_name_their_file_and_the_bulk_cell(metric):
    entry = {m["name"]: m for m in SPEC["per_layer"]}[metric]
    assert (core.BENCH / "metrics" / ("%s.py" % metric)).is_file()
    assert entry["workloads"] == [CELL]
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["better"] == "lower" and entry["moves"] == "verifies_per_s"
    assert entry["layer"] == ("stream" if metric == LOCK_WAIT else "backend programs")
    assert metric in {m["name"] for m in core.cell_metrics(SPEC, CELL, 1)}
