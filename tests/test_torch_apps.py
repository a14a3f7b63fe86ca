"""Parity of the port's tools with the JAX package, on the CPU: the BEV
viewer (utils/viewer.py) and the frame dumps (utils/dumps.py) write the
same bytes on equal inputs; VoxelMap.bev_layers reads the same layers
from a map with resident and spilled patches; replay_ins_txt builds the
same InsPVA payloads; and the apps `slam_run --bev` and `inspect`
(--checkpoint, --pcap with every dump) run end to end on a small drive.
"""

import json
import os
import re

import numpy as np
import pytest

import chip_smoke as cs
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.apps import replay as jreplay
from veloslam_tpu.config import MapConfig as JMapConfig
from veloslam_tpu.io import udp as judp
from veloslam_tpu.map.voxelmap import VoxelMap as JVoxelMap
from veloslam_tpu.utils import dumps as jdumps
from veloslam_tpu.utils import viewer as jviewer
from veloslam_tpu_torch.apps import inspect as insp
from veloslam_tpu_torch.apps import replay, slam_run
from veloslam_tpu_torch.config import MapConfig
from veloslam_tpu_torch.io import udp
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.map.voxelmap import VoxelMap
from veloslam_tpu_torch.utils import dumps, viewer


def _frame(seed, with_intensity=True, L=8, F=300):
    rng = np.random.default_rng(seed)
    f = {"xyz": rng.normal(0, 15, (L, F, 3)).astype(np.float32),
         "mask": rng.random((L, F)) < 0.7}
    if with_intensity:
        f["intensity"] = rng.integers(0, 256, (L, F)).astype(np.float32)
    return f


def _results(seed, n=40):
    rng = np.random.default_rng(seed)
    return {
        "times_us": np.arange(n, dtype=np.int64) * 100000 + 10**15,
        "positions": np.cumsum(rng.normal(0, 1, (n, 3)), 0),
        "keyframe_positions": rng.normal(0, 5, (6, 3)),
        "n_frames": n, "n_keyframes": 6, "n_closures": 2,
        "registered_fraction": 0.95, "map_patches": 3,
    }


@pytest.mark.parametrize("layers", [True, False])
def test_bev_html_is_byte_equal(layers, tmp_path):
    res = _results(0)
    rng = np.random.default_rng(1)
    kw = (dict(ins_xy=rng.normal(0, 9, (30, 2)),
               landmarks_xy=rng.normal(0, 9, (5, 3)),
               occupancy_xy=rng.normal(0, 9, (200, 2)),
               closures=[(0, 4), (1, 5)], title="a drive")
          if layers else {})
    ours = viewer.write_bev_html(str(tmp_path / "a.html"), res, **kw)
    ref = jviewer.write_bev_html(str(tmp_path / "b.html"), res, **kw)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    html = open(ours).read()
    data = json.loads(re.search(r"const D = (\{.*?\});\n", html,
                                re.S).group(1))
    assert len(data["traj"]) == 40 and "https://" not in html


@pytest.mark.parametrize("with_intensity", [True, False])
def test_dumps_are_byte_equal(with_intensity, tmp_path):
    frame = _frame(2, with_intensity)
    for fn in ("dump_txt", "dump_pcd"):
        a, b = str(tmp_path / f"{fn}_a"), str(tmp_path / f"{fn}_b")
        assert getattr(dumps, fn)(frame, a) == getattr(jdumps, fn)(frame, b)
        assert open(a, "rb").read() == open(b, "rb").read()
    for kw in ({}, {"range_m": 10, "px_per_m": 2}, {"center": (3.0, -2.0)}):
        np.testing.assert_array_equal(dumps.bev_image(frame, **kw),
                                      jdumps.bev_image(frame, **kw))
    a = dumps.dump_bev(frame, str(tmp_path / "bev_a"))
    b = jdumps.dump_bev(frame, str(tmp_path / "bev_b"))
    assert os.path.splitext(a)[1] == os.path.splitext(b)[1]
    assert open(a, "rb").read() == open(b, "rb").read()
    empty = {"xyz": frame["xyz"], "mask": np.zeros_like(frame["mask"])}
    assert dumps.bev_image(empty).max() == 0 == jdumps.bev_image(empty).max()


def test_bev_layers_equal_on_a_spilled_map(tmp_path):
    """Two 20 m patches resident at most, six touched: four spill to
    disk, and bev_layers reads them back; one patch carries posts."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform([-30, -30, 0], [30, 30, 3],
                                      (20000, 3)),
                          rng.normal([5, 5, 1], 0.3, (3000, 3))]
                         ).astype(np.float32)
    maps = (VoxelMap(MapConfig(voxel_size=0.5, patch_size_m=20.0,
                               max_resident_patches=2),
                     spill_dir=str(tmp_path / "a"), device="cpu"),
            JVoxelMap(JMapConfig(voxel_size=0.5, patch_size_m=20.0,
                                 max_resident_patches=2),
                      spill_dir=str(tmp_path / "b")))
    posts = rng.normal(0, 5, (4, 5))
    for m in maps:
        m.integrate_points(pts, np.ones(len(pts), bool), np.zeros(3))
        m.get_patch(5.0, 5.0).landmarks.posts = posts
    assert len(maps[0]._spilled) >= 2 and len(maps[1]._spilled) >= 2
    for kw in ({}, {"max_cells": 500, "min_count": 2.0}):
        (oa, pa), (ob, pb) = maps[0].bev_layers(**kw), maps[1].bev_layers(
            **kw)
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(pa, pb)
    assert len(oa) <= 500 and len(pa) == 4


def test_replay_ins_txt_payloads_equal(tmp_path):
    seq = sim.generate_sequence(duration_s=0.3, model="hdl32", seed=5)
    paths = sim.write_sequence(seq, str(tmp_path), name="d")
    origin = (31.0, 121.5, 0.0)
    ours = cs.ins_payloads(replay.replay_ins_txt, udp, paths["ins"], origin)
    ref = cs.ins_payloads(jreplay.replay_ins_txt, judp, paths["ins"],
                          origin)
    assert len(ours) == len(seq["ins_t_us"]) > 20 and ours == ref


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """slam_run's default mode on a 0.6 s simulated drive with --bev and
    a checkpoint (the CPU)."""
    tmp = tmp_path_factory.mktemp("session")
    out, ck = tmp / "out", tmp / "ck"
    assert slam_run.main(["--simulate", "0.6", "--device", "cpu", "--bev",
                          "--out-dir", str(out),
                          "--checkpoint-dir", str(ck)]) == 0
    return out, ck


def test_slam_run_bev_holds_the_trajectory(session):
    out, _ = session
    traj = np.loadtxt(out / "trajectory.txt", ndmin=2)
    html = (out / "bev.html").read_text()
    data = json.loads(re.search(r"const D = (\{.*?\});\n", html,
                                re.S).group(1))
    assert len(traj) >= 3 and len(data["traj"]) == len(traj)
    np.testing.assert_array_equal([[p["x"], p["y"]] for p in data["traj"]],
                                  np.round(traj[:, 1:3], 3))
    metrics = json.loads((out / "metrics.json").read_text())
    assert data["stats"]["frames"] == metrics["n_frames"]
    assert data["stats"]["keyframes"] == metrics["n_keyframes"]
    assert len(data["occ"]) > 0 and len(data["ins"]) > 0
    assert data["title"] == "veloslam_tpu — sim.pcap"


def test_inspect_checkpoint_fetches_every_frame(session, capsys):
    out, ck = session
    assert insp.main(["--checkpoint", str(ck), "--beams"]) == 0
    text = capsys.readouterr().out
    n = len(np.loadtxt(out / "trajectory.txt", ndmin=2))
    assert f"{n} frames indexed" in text and "failures 0" in text
    assert len(re.findall(r"^frame \d+ @ \d+ us: \d+ points", text,
                          re.M)) == n
    assert text.count("  beam ") == 32 * n


def test_inspect_pcap_frame_dumps(session, tmp_path, capsys):
    out, _ = session
    dump = str(tmp_path / "f1")
    assert insp.main(["--pcap", str(out / "sim.pcap"), "--ins",
                      str(out / "sim_ins.txt"), "--frame", "1", "--bev",
                      dump, "--pcd", dump + ".pcd", "--txt", dump + ".txt",
                      "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert re.search(r"decoded \d+ frames from \d+ packets", text)
    n = int(re.search(r"^frame 1 @ \d+ us: (\d+) points", text,
                      re.M).group(1))
    assert n > 1000
    assert f"\nPOINTS {n}\n" in open(dump + ".pcd").read()
    assert len(np.loadtxt(dump + ".txt", ndmin=2)) == n
    bev = re.search(r"bev -> (\S+)", text).group(1)
    assert os.path.getsize(bev) > 0
    with pytest.raises(SystemExit):
        insp.main(["--device", "cpu"])
