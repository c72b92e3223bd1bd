"""Everything of a cell, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
rest sits in files named after them:

- ``<config file>`` (the configuration's ``file`` in BENCHMARK.json): the
  deployment, its CLI flags and the signal levels it assumes;
- ``gpubench/traffic/<traffic>.json``: the mix's CLI preset and the
  generator's parameters (a configuration and a mix make one cell);
- ``gpubench/end_to_end/<metric>.py`` and ``gpubench/metrics/<metric>.py``:
  the reader of each metric.

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List

#: the checkout's root: the directory that holds BENCHMARK.json
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[str] = field(default_factory=list)
    per_layer: List[str] = field(default_factory=list)
    #: metric -> unit, from BENCHMARK.json
    units: Dict[str, str] = field(default_factory=dict)

    @property
    def flags(self) -> List[str]:
        return list(self.config["flags"]) + list(self.traffic["flags"])


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(PKG / "traffic" / f"{w['traffic']}.json")
    e2e = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = set(e2e)
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer, units)


def reader(kind: str, name: str):
    """The reader module of metric ``name``: ``kind`` is ``end_to_end`` or
    ``metrics`` (per layer); its file is ``gpubench/<kind>/<name>.py``."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    module = f"gpubench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    importlib.import_module(f"gpubench.{kind}")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(kind: str, names: List[str]) -> Dict[str, object]:
    return {n: reader(kind, n) for n in names}
