"""Finds what a run needs by name: the cell in ``BENCHMARK.json``, its
configuration (``gqbench/configs/<name>.json``), its traffic mix
(``gqbench/traffic/<name>.json``), the limits of its correctness check
(``gqbench/limits/<workload>.json``), each per-layer metric's reader
(``gqbench/metrics/<name>.py``) and the module of the configuration's model
family and of its program half (``gqbench/families/<name>.py``, looked up in
the data directory first).  A cell, a mix, a metric or a model family is
added by adding files and entries; no code here or in the rest of the
harness names one."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
#: the manifest, and the directory holding ``configs/``, ``traffic/``,
#: ``limits/`` and ``families/`` (the CPU tests point both at their own; a
#: family that theirs lacks is the benchmark's)
BENCHMARK_FILE = os.path.join(ROOT, "BENCHMARK.json")
DATA_DIR = BENCH_DIR


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(BENCHMARK_FILE)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(has {[w['name'] for w in bench['workloads']]})")


def config(name: str) -> dict:
    return _json(os.path.join(DATA_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(DATA_DIR, "traffic", f"{name}.json"))


def limits(workload_name: str) -> dict:
    return _json(os.path.join(DATA_DIR, "limits", f"{workload_name}.json"))


def end_to_end(bench: dict, workload_name: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]


def per_layer(bench: dict, workload_name: str) -> List[dict]:
    """The per-layer metrics whose reader runs in this cell: those that list
    it, and those without a list whose ``moves`` the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, workload_name)}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (workload_name in cells) if cells is not None else (m["moves"] in reported):
            out.append(m)
    return out


_readers: Dict[str, ModuleType] = {}


def reader(name: str) -> ModuleType:
    """The module ``gqbench/metrics/<name>.py``: its ``UNIT``, ``LAYER``,
    ``MOVES`` and ``read(view)``, which returns the value or None where
    the run holds nothing to read."""
    if name not in _readers:
        path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"gqbench_metric_{len(_readers)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[name] = mod
    return _readers[name]


_families: Dict[str, ModuleType] = {}


def family(name: str) -> ModuleType:
    """The module ``families/<name>.py`` of the data directory, else of the
    benchmark: a model family (``gqbench/families/__init__.py`` says what it
    supplies) or a family's program half."""
    for base in (DATA_DIR, BENCH_DIR):
        path = os.path.join(base, "families", f"{name}.py")
        if os.path.exists(path):
            break
    else:
        raise LookupError(f"no family {name!r}: no families/{name}.py in {DATA_DIR} "
                          f"or {BENCH_DIR}")
    if path not in _families:
        spec = importlib.util.spec_from_file_location(f"gqbench_family_{len(_families)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _families[path] = mod
    return _families[path]
