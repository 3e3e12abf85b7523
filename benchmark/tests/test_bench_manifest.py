"""The manifest against the contract's shapes, and every file a cell
names."""

import json
import re

import pytest

from benchmark import harness
from conftest import GROUPS, STAGED, manifest

ROOT = harness.ROOT
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]
STAGED_ENTRIES = [e for g in GROUPS for e in STAGED[g]]
#: the manifest with the staged cells, whose files are held to it too
ALL = manifest()
ALL_CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert M["paths"] == ["benchmark"]
    assert M["command"][1] == "benchmark/run.py"


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS
                         + STAGED_ENTRIES, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", ALL["per_layer"], ids=lambda m: m["name"])
def test_each_cell_of_a_metric_reports_what_it_moves(metric):
    moved = next(m for m in ALL["end_to_end"]
                 if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert cell in ALL_CELLS
        assert "workloads" not in moved or cell in moved["workloads"]
    assert (harness.BENCH / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_files_exist(cell):
    c = harness.load_cell(cell, ALL)
    assert (harness.BENCH / "drivers"
            / f"{c.traffic['driver']}.py").is_file()
    assert c.entry["chips"] == 1
    assert c.per_layer and any(m["name"] != "setup_s"
                               for m in c.end_to_end)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.traffic["limits"]


def test_no_four_chip_cell():
    assert all(w["chips"] == 1 for w in M["workloads"])


@pytest.mark.parametrize("config", ALL["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("benchmark/")
    sizes = json.loads(path.read_text())
    assert sizes["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in ALL["workloads"])
    if config in M["configs"]:
        assert any(w["config"] == config["name"] for w in M["workloads"])


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in M["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25
