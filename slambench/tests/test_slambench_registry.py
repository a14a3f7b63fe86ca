"""The harness finds every configuration, cell, traffic, entry and metric
by name; a cell added as files only is found with no edit; and
BENCHMARK.json keeps to the contract's names and shapes."""

import json
import os
import re
import shutil

import pytest

from slambench.lib import registry

ROOT = registry.REPO_ROOT
BENCH = registry.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "slambench/run.py"]
    assert BENCH["paths"] == ["slambench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [x["name"] for x in BENCH[kind]]
    assert len(names) == len(set(names))
    for x in BENCH[kind]:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key]
                assert "\t" not in x[key]


def test_cells_and_metrics_refer_to_what_exists():
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"])
        cell = registry.workload(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        traffic = registry.traffic(w["traffic"])
        assert hasattr(registry.entry(traffic["entry"]), "Entry")
        reported = registry.cell_metrics(BENCH, w["name"], "end_to_end")
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.cell_metrics(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert hasattr(registry.metric(m["name"]), "read")
        for c in m["workloads"]:
            assert m["moves"] in registry.cell_metrics(BENCH, c,
                                                       "end_to_end")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = registry.config(c["name"])
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"]
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_a_cell_added_as_files_is_found(tmp_path):
    """Copy the benchmark, add a configuration, a traffic, a cell and a
    metric as new files, and find each by name with no edit to an
    existing file."""
    bench_dir = tmp_path / "slambench"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = registry.config("hdl32e_vehicle")
    cfg.update(name="hdl64e_kitti")
    cfg["sensor"]["model"] = cfg["engine"]["sensor"]["model"] = "hdl64"
    (bench_dir / "configs" / "hdl64e_kitti.json").write_text(
        json.dumps(cfg))
    (bench_dir / "traffic" / "replay_batched_7s.json").write_text(
        json.dumps({"entry": "slam_replay", "stream": "batched",
                    "drive_s": 7.0, "batch": 4096}))
    (bench_dir / "workloads" / "hdl64e_kitti_short.json").write_text(
        json.dumps({"config": "hdl64e_kitti", "traffic": "replay_batched_7s",
                    "check": {"drift_lag_s": 2.0,
                              "limits": {"frames_bad": 0}}}))
    (bench_dir / "metrics" / "slam.passes.py").write_text(
        "def read(ctx):\n    return float(len(ctx.result['passes']))\n")
    cell = registry.workload("hdl64e_kitti_short", str(bench_dir))
    assert registry.config(cell["config"], str(bench_dir))["name"] == \
        "hdl64e_kitti"
    traffic = registry.traffic(cell["traffic"], str(bench_dir))
    assert traffic["drive_s"] == 7.0
    assert hasattr(registry.entry(traffic["entry"], str(bench_dir)),
                   "Entry")
    m = registry.metric("slam.passes", str(bench_dir))

    class Ctx:
        result = {"passes": [1, 2]}
    assert m.read(Ctx) == 2.0
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "slam.passes", "unit": "passes", "better": "higher",
         "source": "program_span", "layer": "benchmark",
         "moves": "slam_frames_per_s"}])
    assert "slam.passes" in registry.cell_metrics(
        bench, "hdl64e_kitti_short", "per_layer")


def test_names_are_files():
    for kind, sub, ext in (("configs", "configs", ".json"),
                           ("per_layer", "metrics", ".py")):
        for x in BENCH[kind]:
            assert os.path.isfile(os.path.join(registry.BENCH_DIR, sub,
                                               x["name"] + ext))
