"""Find the benchmark's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell
names a configuration (``uvmbench/configs/<name>.json``) and a traffic mix
(``uvmbench/traffic/<name>.json``); each configuration names the driver that
runs its window (``uvmbench/drivers/<name>.py``) and, through the same name,
its plain reference (``uvmbench/reference/<name>.py``); each per-layer metric
is read by ``uvmbench/metrics/<name>.py``.  Nothing here lists them: a new
cell, mix, configuration, driver or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "uvmbench")
#: the measured program's package lives here in the checkout
PROGRAM_SRC = os.path.join(ROOT, "src")


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str, bench: Dict) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def config(name: str, bench: Dict) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load(kind: str, name: str) -> ModuleType:
    """Import ``uvmbench/<kind>/<name>.py`` (a name may hold dots)."""
    mod_name = f"uvmbench.{kind}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def driver(name: str) -> ModuleType:
    return _load("drivers", name)


def reference(name: str) -> ModuleType:
    return _load("reference", name)


def metric_reader(name: str) -> ModuleType:
    return _load("metrics", name)


def cell_metrics(cell: str, bench: Dict, section: str) -> List[Dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, or that list no cells and move
    (or are) an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
