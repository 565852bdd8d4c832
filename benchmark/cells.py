"""The benchmark's data, found by name.

`BENCHMARK.json` at the root lists the cells and metrics. Each cell has a
file `workloads/<cell>.json` (its configuration, chips, traffic and
limits), each configuration `configs/<config>.json`, each traffic kind a
driver `traffic/<kind>.py`, and each per-layer metric a reader
`metrics/<metric>.py`. Adding a cell, a configuration or a metric is adding
files (and their entries in `BENCHMARK.json`); nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")   # fullmatch
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class BenchError(ValueError):
    """A cell, configuration, driver or reader that is missing or
    malformed."""


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise BenchError(f"missing file {path}") from e


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise BenchError(f"{what} {name!r} is not a name: 1 to 64 of "
                         f"A-Z a-z 0-9 _ . -, not starting with . or -")
    return name


class Bench:
    """The benchmark rooted at `root` (the directory of `BENCHMARK.json`;
    its files under `root/benchmark`)."""

    def __init__(self, root: str | None = None):
        self.root = root or os.path.dirname(HERE)
        self.dir = os.path.join(self.root, "benchmark")
        self.spec = _load_json(os.path.join(self.root, "BENCHMARK.json"))

    def cell(self, name: str) -> tuple[dict, dict]:
        """(cell, configuration) of a cell listed in BENCHMARK.json."""
        check_name(name, "cell")
        entry = next((w for w in self.spec["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise BenchError(f"cell {name!r} is not in BENCHMARK.json")
        cell = _load_json(os.path.join(self.dir, "workloads", name + ".json"))
        for key in ("config", "chips"):
            if cell.get(key) != entry[key]:
                raise BenchError(f"cell {name}: {key} {cell.get(key)!r} in "
                                 f"its file, {entry[key]!r} in "
                                 f"BENCHMARK.json")
        if cell["traffic"].get("name") != entry["traffic"]:
            raise BenchError(f"cell {name}: traffic "
                             f"{cell['traffic'].get('name')!r} in its file, "
                             f"{entry['traffic']!r} in BENCHMARK.json")
        config = _load_json(os.path.join(
            self.dir, "configs", check_name(cell["config"], "config")
            + ".json"))
        return cell, config

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics read in the cell: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if ("workloads" in m and cell in m["workloads"])
                or ("workloads" not in m and m["moves"] in e2e)]

    def driver(self, kind: str):
        """The traffic driver module `traffic/<kind>.py`."""
        return self._module("traffic", kind)

    def reader(self, metric: str):
        """The reader module `metrics/<metric>.py` (its `read(ctx)`)."""
        return self._module("metrics", metric)

    def _module(self, folder: str, name: str):
        check_name(name, folder)
        path = os.path.join(self.dir, folder, name + ".py")
        if not os.path.isfile(path):
            raise BenchError(f"missing file {path}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{folder}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
