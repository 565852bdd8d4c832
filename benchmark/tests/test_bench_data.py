"""BENCHMARK.json and the files it names: found by name and well formed."""

import json
import os
import re

import pytest

from benchmark.cells import NAME, UNIT, Bench, BenchError, check_name

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
BENCH = Bench(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
LINE = re.compile(r"[^\n\t]{1,200}")     # fullmatch


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert all(LINE.fullmatch(w) for w in SPEC["command"])


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    check_name(entry["name"], "config")
    assert LINE.fullmatch(entry["source"]) and LINE.fullmatch(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert entry["name"] in {w["config"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4)
    for key in ("config", "traffic"):
        check_name(entry[key], key)
    assert LINE.fullmatch(entry["why"])
    spec, config = BENCH.cell(cell)
    assert spec["why"] == entry["why"]
    assert hasattr(BENCH.driver(spec["traffic"]["kind"]), "Traffic")
    assert hasattr(BENCH.driver(spec["traffic"]["kind"]), "control")
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(cell)


def test_cells_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
    check_name(metric["name"], "metric")
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
    check_name(metric["name"], "metric")
    assert UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert LINE.fullmatch(metric["layer"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e and metric["moves"] != "setup_s"
    # every cell it is read in reports the metric it moves
    reporting = e2e[metric["moves"]].get("workloads", CELLS)
    assert set(metric.get("workloads", reporting)) <= set(reporting)
    assert callable(BENCH.reader(metric["name"]).read)


def test_names_units_and_size():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("name,ok", [
    ("hw5-b1024-f64", True), ("graded.capture_s", True), ("_x", True),
    ("a b", False), ("a/b", False), ("a,b", False), (".a", False),
    ("-a", False), ("x" * 65, False), ("µs", False), ("", False),
    ("a\n", False)])
def test_name_rule(name, ok):
    assert bool(NAME.fullmatch(name)) == ok
    if not ok:
        with pytest.raises(BenchError):
            check_name(name, "cell")


@pytest.mark.parametrize("unit,ok", [
    ("s", True), ("pairs/s", True), ("%", True), ("tokens/s", True),
    ("pairs per s", False), ("µs", False), ("", False), ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(UNIT.fullmatch(unit)) == ok


def test_every_file_under_paths_is_named():
    """Every data file and reader is reached from BENCHMARK.json, so no
    file lies there that no cell or metric uses."""
    used = {f"configs/{c['name']}.json" for c in SPEC["configs"]}
    used |= {f"workloads/{c}.json" for c in CELLS}
    used |= {f"metrics/{m['name']}.py" for m in SPEC["per_layer"]}
    used |= {f"traffic/{BENCH.cell(c)[0]['traffic']['kind']}.py"
             for c in CELLS}
    for folder in ("configs", "workloads", "metrics", "traffic"):
        for name in os.listdir(os.path.join(ROOT, "benchmark", folder)):
            if name.endswith((".json", ".py")) and name != "__init__.py":
                assert f"{folder}/{name}" in used, name
