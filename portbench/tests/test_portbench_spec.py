"""BENCHMARK.json and the files it names: every cell, configuration,
traffic and metric file parses, the names keep the benchmark's rules, and
each metric's end-to-end metric is reported by each of its cells."""

import importlib
import json
import re

import pytest

from portbench.harness import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = core.load_json(core.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data and key in data["published"]
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    entry, config, traffic = core.cell_files(SPEC, cell["name"])
    assert config["name"] == cell["config"]
    importlib.import_module("portbench.harness.runners.%s" % traffic["runner"])
    assert core.cell_metrics(SPEC, cell["name"], 0), "no end-to-end metric"
    assert core.cell_metrics(SPEC, cell["name"], 1), "no per-layer metric"
    names = {m["name"] for m in core.cell_metrics(SPEC, cell["name"], 0)}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries_and_readers(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(core.reader(metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        assert metric["moves"] in e2e
        for cell in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in core.cell_metrics(SPEC, cell, 0)}
        if "roofline" in metric["name"]:
            assert metric["unit"] == "%" and metric["name"].startswith("fp_mul_roofline.")


def test_names_unique_and_file_small():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_layers_are_named_in_perf_md():
    text = (core.ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert "**%s**" % m["layer"] in text, m["layer"]
