"""BENCHMARK.json and the files it names: every configuration, cell and
per-layer metric parses and is found by its name, names and units keep to
their characters, each per-layer metric's cells report the end-to-end
metric it moves, and every cell reports set-up, another end-to-end metric
and a per-layer one."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_the_day():
    n = 24
    runs = 2 + 14 * n
    total = runs * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and not {"\n", "\t"} & set(text)
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert config["why"] == entry["why"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert set(entry["reduced"]) <= set(config) and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_file_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    _, cell, centry, _ = harness.find_cell(SPEC, entry["name"], ROOT)
    assert cell["config"] == entry["config"] == centry["name"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    # the traffic mix is the cell's file, named <config>.<traffic>; its
    # driver is any file of drivers/, shared by the mixes of an entry point
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    threads = cell.get("host_threads")
    assert threads is None or (isinstance(threads, int) and threads >= 1)
    assert (ROOT / "benchmark" / "drivers" / f"{cell['driver']}.py").is_file()


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if "roofline" in m["name"]:
        # a kernel's share of its roofline: <kernel>_roofline[.<split>]
        assert re.match(r"^[A-Za-z0-9]+_roofline(\.[A-Za-z0-9_]+)?$",
                        m["name"])
        assert m["unit"] == "%"
    # the reader is a file of its own, found by the metric's name
    assert callable(harness.load_reader(m["name"], ROOT))
    # every cell it lists reports the end-to-end metric it moves
    moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moves.get("workloads", [cell])


def test_split_metrics_name_one_layer():
    """A quantity split by the end-to-end metric it moves (``.obs``,
    ``.epochs``, ``.trials``) names its layer letter for letter in every part."""
    layers = {}
    for m in SPEC["per_layer"]:
        base, _, split = m["name"].rpartition(".")
        if split in ("obs", "epochs", "trials"):
            layers.setdefault(base, set()).add(m["layer"])
    assert layers and all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_each_cell_reports_enough(entry):
    e2e, layer = harness.cell_metrics(SPEC, entry["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


def test_files_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", path.name), path
