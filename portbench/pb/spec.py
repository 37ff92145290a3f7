"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration,
traffic mix and metrics; their files sit under `portbench/`:

    configs/<config>.json    the configuration as it is run
    datagen/<generator>.py   a configuration's data, `generate(...)`
    traffic/<traffic>.json   the mix's parameters, read by pb.traffic
    limits/<cell>.json       the cell's correctness limits and readings
    metrics/<metric>.py      one reader a metric, `read(run)`

A new configuration, mix, cell or metric is a new file and a new entry;
no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parents[1]          # portbench/


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, spec: dict, name: str, base: Path = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.base = base
        conf = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config = load_json(base.parent / conf["file"])
        self.traffic = load_json(base / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(base / "limits" / f"{name}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m, name)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def reader(name: str, base: Path = HERE) -> ModuleType:
    """The reader metrics/<name>.py of a metric."""
    return module("metrics", name, base)


def module(folder: str, name: str, base: Path = HERE) -> ModuleType:
    """The module <folder>/<name>.py (names may hold dots)."""
    path = base / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} module {name!r} at {path}")
    mod_name = f"pb_{folder}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
