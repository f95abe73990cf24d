"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: configurations, traffic mixes, limits and metric readers."""

from __future__ import annotations

import json
import re

import pytest

from lpbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == KEYS
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and SPEC["paths"] == ["lpbench"]
    assert SPEC["command"][:2] == ["python3", "lpbench/run.py"] and len(SPEC["command"]) <= 32
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


def test_check_fits_its_time_with_every_cell():
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of compile a cell,
    # 1,200 s spare: within 43,200 s at the full 24 cells
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", METRICS + SPEC["workloads"] + SPEC["configs"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_are_unique():
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entries(metric):
    assert set(metric) - {"workloads"} == E2E_KEYS
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0 < metric["bound"] <= 0.25
    assert metric["bound"] >= 0.01


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_entries(metric):
    assert set(metric) - {"workloads"} == LAYER_KEYS
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    # a layer's metrics give its name letter for letter: no two spellings
    assert len({name.split(" (")[0] for name in layers}) == len(layers)


def test_setup_bound_and_cell_floor():
    (setup,) = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_reports(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]).read)
    # every per-layer metric's end-to-end metric is reported in the cell
    assert {m["moves"] for m in c.per_layer} <= names
    # the limits: the exact ones at 0, every one with its readings
    assert c.limits["unanswered"]["limit"] == 0
    assert c.limits["ref_unconverged"]["limit"] == 0
    assert all("set_from" in v for v in c.limits.values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("lpbench/configs/")
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert data["assumed"]
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(config["file"]) == 1
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


def test_every_file_under_paths_is_named_from_name_characters():
    for path in (harness.HERE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel
