"""Parity of the port's per-frame pipeline (SlamPipeline.run_offline +
finalize, slam_run's default mode) with the JAX package.

* The slice end to end: the "small" and "small_search" drives of
  tests/fixtures/perframe_golden_seed3.npz (gen_torch_perframe_golden.py:
  2 s on a 4 m circle, INS drifting 1 m/s, 8192 points, a 32-keyframe
  graph, closure min_gap 8; "small_search" without the dense index),
  from pcap through finalize on the CPU, against the JAX package's run
  of the same files with chip_smoke.py's per_frame gates: frames and
  times, keyframe times, the closures accepted mid-session (at least one,
  so the graph solve and the incremental map downdate ran) and in all,
  and the landmark count equal; trajectory within 5 cm in x, y and
  0.15 m in z; ATE at most the golden's + 0.02 m.  Here also, tighter:
  the registered flags equal, positions within 1 mm (measured ~7e-5 m),
  the per-tile map counts equal.
* Frames in the FrameStore with their pcap offsets; a dropped payload is
  re-decoded from the pcap: the same points, positions within 0.1 mm and
  times within 1 µs (its batches start elsewhere in the pcap).
* The other registration methods: the "small" drive with D2D and with
  NDT against tests/fixtures/paths_golden_seed3.npz.
* A checkpoint written by either package loads in the other: frame meta
  and payloads, INS track, graph and map equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.runtime.pipeline import SlamPipeline as JSlamPipeline
from veloslam_tpu_torch.config import MeshConfig, SlamConfig
from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

PER_FRAME_STAGES = {"decode", "compensate", "assemble", "frame",
                    "register", "map_update", "loop_verify", "graph_solve",
                    "map_downdate", "landmarks", "pipeline_init",
                    "read_inputs", "batch_prep", "frames_to_host",
                    "frame_prep", "roi", "frame_store", "scan_context",
                    "loop_propose", "map_reintegrate", "map_rebuild",
                    "trajectory"}


@pytest.fixture(scope="module", params=["small", "small_search"])
def run(request, tmp_path_factory):
    gold = np.load(cs.PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[request.param]
    paths, seq = cs.write_pipeline_drive(
        drive, cfg["model"], str(tmp_path_factory.mktemp(request.param)))
    pipe, res, mid, _ = cs.run_perframe(paths, drive, torch.device("cpu"))
    return request.param, pipe, res, mid, seq, gold, paths


def test_per_frame_drive_matches_jax_golden(run):
    name, pipe, res, mid, seq, gold, _ = run
    cs.check_perframe(pipe, res, mid, seq, gold, name)

    def g(k):
        return gold[f"{name}_{k}"]

    assert pipe.cfg.registration.use_dense_index == (name == "small")
    assert len(mid) >= 1 and len(pipe.closures) > len(mid)
    np.testing.assert_array_equal(
        [f.registered for f in pipe.trajectory], g("registered"))
    np.testing.assert_allclose(res["positions"], g("positions"), atol=1e-3)
    np.testing.assert_allclose(res["keyframe_positions"],
                               g("keyframe_positions"), atol=1e-3)
    assert res["n_landmark_obs"] == int(g("n_landmark_obs"))
    tiles, counts = cs.map_tiles(pipe)
    np.testing.assert_array_equal(tiles, g("map_tiles"))
    np.testing.assert_array_equal(counts, g("map_tile_counts"))
    assert res["gps_health"]["grounded"] and pipe._gps_base is not None
    timing = res["timing"]
    assert set(timing) == PER_FRAME_STAGES
    assert timing["map_downdate"]["count"] >= 2   # mid-session + finalize
    assert timing["frame"]["count"] == res["n_frames"]


def test_results_have_the_jax_keys(run):
    _, pipe, res, _, _, _, _ = run
    assert set(res) == set(JSlamPipeline().results())
    assert res["ring_full"] is False
    assert res["dense_index_min_coverage"] is None


def test_frames_are_stored_and_redecode_from_the_pcap(run):
    """Every frame is in the FrameStore with the pcap offset of the
    packet at or before its start; dropping a payload re-decodes it from
    there, the same frame as stored."""
    _, pipe, res, _, _, _, paths = run
    fs = pipe.frames
    assert len(fs) == res["n_frames"]
    times, meta = fs.all_frame_meta()
    np.testing.assert_array_equal(times, res["times_us"])
    assert (meta["n_points"] > 10000).all()
    offsets = [fs._sources[int(t)][1] for t in times]
    assert all(fs._sources[int(t)][0] == paths["pcap"] for t in times)
    assert offsets == sorted(offsets) and len(set(offsets)) == len(offsets)
    for t_us in (int(times[1]), int(times[len(times) // 2])):
        want = fs.get_frame_at(t_us)
        assert want["mask"].sum() == meta["n_points"][list(times).index(
            t_us)]
        got = pipe._redecode_frame(fs._sources[t_us], t_us)
        assert set(got) == set(want)
        # The same points; their float32 times and compensated positions
        # come from batches anchored elsewhere in the pcap.
        for k in ("mask", "intensity", "azimuth"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["xyz"], want["xyz"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got["rel_s"], want["rel_s"], atol=1e-6,
                                   rtol=0)
        del fs._frames[t_us]
        again = fs.get_frame_at(t_us)        # through the redecoder
        np.testing.assert_array_equal(again["xyz"], got["xyz"])


@pytest.mark.parametrize("method", ["d2d", "ndt"])
def test_d2d_and_ndt_raise_on_the_per_frame_path(method, tmp_path):
    """The per-frame path registers with D2D and NDT (it refused them
    before they were ported): the "small" drive with each method, from
    pcap through finalize, against the JAX package's run of the same
    files (paths_golden_seed3.npz) with chip_smoke.py's per_frame gates
    and the registered flags; here also positions within 1 mm (measured
    ~6e-5 m) and the map tiles equal, their counts within 1e-6
    relative."""
    gold = np.load(cs.PATHS_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    name = f"{method}_small"
    drive = {d["name"]: d for d in cfg["per_frame"]}[name]
    paths, seq = cs.write_pipeline_drive(drive, cfg["model"], str(tmp_path))
    pipe, res, mid, _ = cs.run_perframe(paths, drive, torch.device("cpu"))
    assert pipe.cfg.registration.method == method
    cs.check_perframe(pipe, res, mid, seq, gold, name, flags=True,
                      min_closures=cs.PATHS_MIN_CLOSURES[name])
    assert gold[f"{name}_registered"].sum() == res["n_frames"] - 1
    np.testing.assert_allclose(res["positions"], gold[f"{name}_positions"],
                               atol=1e-3)
    tiles, counts = cs.map_tiles(pipe)
    np.testing.assert_array_equal(tiles, gold[f"{name}_map_tiles"])
    np.testing.assert_allclose(counts, gold[f"{name}_map_tile_counts"],
                               rtol=1e-6)


def test_paths_golden_config_is_the_generators():
    """paths_golden_seed3.npz holds what its generator derives today: the
    per-frame golden's drives with method "d2d" / "ndt", the batched
    golden's with use_dense_index=False, the odometry golden's drives;
    the port rebuilds each SlamConfig unchanged."""
    from fixtures.gen_torch_paths_golden import golden_config
    cfg = json.loads(str(np.load(cs.PATHS_GOLDEN)["config"]))
    assert cfg == golden_config()
    assert {d["name"] for d in cfg["per_frame"]} == set(
        cs.PATHS_MIN_CLOSURES)
    for d in cfg["per_frame"] + cfg["batched"]:
        back = dataclasses.asdict(SlamConfig.from_dict(d["slam"]))
        assert back.pop("mesh") == dataclasses.asdict(MeshConfig())
        assert json.loads(json.dumps(back)) == d["slam"]
    for d in cfg["per_frame"]:
        assert d["slam"]["registration"]["method"] == d["name"][:3]
    for d in cfg["batched"]:
        assert not d["slam"]["registration"]["use_dense_index"]
    assert (cfg["fused_batch"], cfg["fast_batch"]) == (512, 2048)


def _jax_session(tmp_path):
    """A JAX SlamPipeline holding a small session: frames with pcap
    sources, an INS track, two scans in the map, a graph with a closure,
    a landmark and observations."""
    from veloslam_tpu.runtime.pipeline import SlamPipeline as J
    rng = np.random.default_rng(3)
    jp = J(spill_dir=str(tmp_path / "jspill"))
    for k in range(4):
        jp.frames.add_frame(
            10_000 * k, {"xyz": rng.normal(size=(32, 6, 3)).astype(np.float32),
                         "mask": rng.random((32, 6)) < 0.8,
                         "intensity": rng.random((32, 6)).astype(np.float32)},
            carpose_q=np.array([1.0, 0, 0, 0]), carpose_t=rng.normal(size=3),
            source=("drive.pcap", 24 + 1248 * k))
    for k in range(6):
        jp.feed_ins_pose(5_000 * k, [1.0, 0, 0, 0], [k, 0.5 * k, 0.0],
                         [1.0, 0.5, 0.0])
    pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    for tx in (0.0, 130.0):
        jp.map.integrate_points(pts + [tx, 0, 0], np.ones(3000, bool),
                                center=np.array([tx, 0.0, 0.0]))
    for k in range(3):
        jp.graph.add_pose([1.0, 0, 0, 0], [2.0 * k, 0, 0])
    jp.graph.add_edge(0, 1, [1.0, 0, 0, 0], [2.0, 0, 0], info=(1e6,) * 6)
    jp.graph.add_edge(0, 2, [1.0, 0, 0, 0], [4.0, 0, 0], info=(1e4,) * 6)
    lm = jp.graph.add_landmark([1.0, 3.0, 0.0])
    for k in range(3):
        jp.graph.add_observation(k, lm, [1.0 - 2 * k, 3.0, 0.0])
    return jp


def _same_session(a, b):
    (ta, va), (tb, vb) = a.frames.all_frame_meta(), b.frames.all_frame_meta()
    np.testing.assert_array_equal(ta, tb)
    for k in va:
        np.testing.assert_array_equal(va[k], vb[k])
    assert a.frames._sources == b.frames._sources
    for t_us in ta:
        fa, fb = a.frames.get_frame_at(int(t_us)), b.frames.get_frame_at(
            int(t_us))
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    (qa, xa), (qb, xb) = a.track.timeline.arrays(), b.track.timeline.arrays()
    np.testing.assert_array_equal(qa, qb)
    for k in xa:
        np.testing.assert_array_equal(xa[k], xb[k])
    for f in ("n_poses", "n_edges", "n_landmarks", "n_obs"):
        assert getattr(a.graph, f) == getattr(b.graph, f), f
    for f in ("q", "t", "e_i", "e_j", "e_q", "e_t", "e_info", "l_pos",
              "o_i", "o_l", "o_z", "o_info"):
        np.testing.assert_array_equal(getattr(a.graph, f),
                                      getattr(b.graph, f), err_msg=f)
    keys = sorted(set(a.map._patches) | set(a.map._spilled))
    assert keys == sorted(set(b.map._patches) | set(b.map._spilled))
    assert len(keys) >= 2
    for k in keys:
        pa = a.map._materialize(k, create=False)
        pb = b.map._materialize(k, create=False)
        for f in ("coords", "count", "s1", "s2"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint the JAX package wrote loads in the port (the state
    carries across), and the port's own loads back in the JAX package."""
    from veloslam_tpu.runtime.pipeline import SlamPipeline as J
    jp = _jax_session(tmp_path)
    jp.save_checkpoint(str(tmp_path / "jck"))
    port = SlamPipeline(device="cpu")
    port.load_checkpoint(str(tmp_path / "jck"))
    _same_session(port, jp)
    port.save_checkpoint(str(tmp_path / "pck"))
    back = J()
    back.load_checkpoint(str(tmp_path / "pck"))
    _same_session(back, jp)
    assert port.map.device.type == "cpu"
    assert os.path.exists(tmp_path / "pck" / "frames_meta_sources.npz")


def test_golden_config_is_the_generators():
    """The golden's drives and SlamConfigs are what its generator derives
    today (bench.py's full-SLAM config, the small drives cut as it says),
    and the port rebuilds each config from them unchanged."""
    from fixtures.gen_torch_perframe_golden import golden_config
    cfg = json.loads(str(np.load(cs.PERFRAME_GOLDEN)["config"]))
    assert cfg == golden_config()
    drives = {d["name"]: d for d in cfg["drives"]}
    assert set(drives) == set(cs.PERFRAME_MIN_CLOSURES)
    for d in drives.values():
        back = dataclasses.asdict(SlamConfig.from_dict(d["slam"]))
        assert back.pop("mesh") == dataclasses.asdict(MeshConfig())
        assert json.loads(json.dumps(back)) == d["slam"]
    full = SlamConfig.from_dict(drives["full"]["slam"])
    assert full.pipeline.packets_per_batch == 512
    assert full.registration.max_points == 16384
    assert full.graph.loop_closure_min_gap == 12
    assert not SlamConfig.from_dict(
        drives["small_search"]["slam"]).registration.use_dense_index
