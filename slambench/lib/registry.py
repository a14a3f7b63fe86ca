"""Find everything by name.

The harness holds no list of configurations, cells, entries or metrics:
`BENCHMARK.json` names them, and each lives in a file of its own under
the benchmark's folder:

    configs/<config>.json     a deployment: sensor, engine, drive recipe
    workloads/<cell>.json     a cell: its configuration, traffic, checks
    traffic/<traffic>.json    a traffic mix: the entry, drive and load
    entries/<entry>.py        a user entry that a window drives
    metrics/<metric>.py       a reader of one per-layer metric

so a later change adds a cell, a configuration or a metric by adding
files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME_RE.match(name or ""):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = REPO_ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs",
                              _name("config", name) + ".json"))


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "workloads",
                              _name("workload", name) + ".json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic",
                              _name("traffic", name) + ".json"))


def _module(path: str, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "entries",
                                _name("entry", name) + ".py"),
                   f"slambench_entry_{name}")


def metric(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return _module(os.path.join(bench_dir, "metrics",
                                _name("metric", name) + ".py"),
                   "slambench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str, kind: str) -> Dict[str, dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it under `workloads`, and those without that key."""
    out = {}
    for m in bench[kind]:
        cells: Optional[list] = m.get("workloads")
        if cells is None or cell in cells:
            out[m["name"]] = m
    return out
