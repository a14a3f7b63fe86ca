"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and everything else runs, on
the CPU at a small size (each cell's traffic cut to a short drive; the
cells' limits as committed).  Each cell meets the control and every
fault it can have (`faults.py`); the exchange between chips is not one
of them.  The same breaks run on the card at the cells' own
sizes through `python3 -m slambench.tests.faults` (the card test
below)."""

import glob
import json
import os
import shutil

import pytest
import torch

from slambench.lib import registry
from slambench.reference import world
from slambench.tests import faults

# Long enough for the control's INS drift (1 m/s) to pass every cell's
# position limit.
SMALL = {"slam_replay": {"drive_s": 7.0, "batch": 2048}}
LISTED = [w["name"] for w in registry.benchmark()["workloads"]]
CELLS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(registry.BENCH_DIR, "workloads", "*.json")))


@pytest.fixture(scope="module")
def small_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    bench = registry.benchmark()
    for cell in sorted(set(CELLS) - set(LISTED)):
        w = registry.workload(cell)
        bench["workloads"].append({"name": cell, "config": w["config"],
                                   "traffic": w["traffic"], "chips": 1,
                                   "why": "not listed yet"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(registry.BENCH_DIR, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for p in (root / "slambench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(SMALL[t["entry"]])
        p.write_text(json.dumps(t))
    return root


def _run(root, cell, capsys):
    from slambench import run as runmod
    torch.set_num_threads(4)
    rc = runmod.run(cell, 2**31 + 5, 0.5, False, device_name="cpu",
                    bench_dir=str(root / "slambench"), root=str(root),
                    require_card=False)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


@pytest.mark.parametrize("fault", sorted(faults.BREAKS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(small_bench, cell, fault, capsys,
                                   monkeypatch):
    # The short drive shows each post in fewer keyframes than the cells'
    # drives: ask for as large a share of them.
    monkeypatch.setattr(world, "SEEN_KEYFRAMES", 3)
    with faults.BREAKS[fault]():
        res = _run(small_bench, cell, capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_control_fails_on_the_card(cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the cell at its own size")
    assert faults.main(["--workload", cell, "--seconds", "5",
                        "--seeds", "11", "--fault", "control"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
