"""Finding a cell's files by name.

A cell (``workloads`` in ``BENCHMARK.json`` at the checkout's root) names
a configuration and a traffic mix. Everything else is found from those
names, so that a new configuration, mix, metric or cell is new files and
new entries, never an edit:

- ``configs/<config>.json`` (the ``file`` of its ``configs`` entry): the
  model's sizes, its weights file, the numerics tier that each mix runs it
  at (``tiers``, by the mix's name), the kernels it calls and with which
  widths;
- ``reference/<config>.py``: its plain PyTorch forward;
- ``traffic/<traffic>.json``: the mix's parameters, which name its driver
  ``drivers/<driver>.py``;
- ``limits/<workload>.json``: the numbers that decide ``correct``, each
  with its limit and the readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    tier: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: Dict, workload: str) -> bool:
    """Whether ``metric`` is reported in the cell ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def path_of(kind: str, name: str, ext: str) -> str:
    return os.path.join(HERE, kind, name + ext)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = path_of(kind, name, ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = "port_bench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench_path: str = BENCHMARK) -> Cell:
    """The cell ``name`` of the benchmark, with its files read."""
    bench = load_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_path} (have {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(path_of("traffic", w["traffic"], ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), tier=config["tiers"][w["traffic"]],
        config=config, traffic=traffic,
        limits=load_json(path_of("limits", name, ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])
