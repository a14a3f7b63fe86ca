"""Parity of the port's user-facing pipeline with the JAX package.

* The slice end to end: SlamPipeline.run_offline_batched (pcap + INS
  log, GPS-grounded times, 1024-packet batches, deferred map) + finalize
  (landmarks, landmark-Schur solve with the residual trim, map rebuild,
  trajectory correction) on the small loop drive of
  tests/fixtures/pipeline_golden_seed3.npz (gen_torch_pipeline_golden.py:
  2 s on a 4 m circle, INS drifting 1 m/s, 8192 points, 8192 map rows, a
  32-keyframe ring, closure min_gap 8), against the JAX package's run of
  the same files.  Times, frame and keyframe counts, closure pairs,
  landmark and observation counts and the trim mask exactly; corrected
  positions and landmarks within 1 cm (measured ~7e-5 m: float32 sums in
  another order); map patches equal and the map's total count within
  0.1%.
* The graph crop buckets against SlamPipeline._crop_graph.
* The CLI (`slam_run --batched --simulate 2 --device cpu`, `--fast`,
  and the default per-frame mode with `--checkpoint-dir`) writes the JAX
  app's files; it names the part of the per-frame mode not ported yet
  (`--bev`); `--fast` writes the JAX app's trajectory; SlamPipeline()
  without a card and without device="cpu" raises.
* run_offline_batched with use_dense_index=False (the binary-search
  lookup) on the small drive against paths_golden_seed3.npz.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_pipeline_drive
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.graph.posegraph import PoseGraph as JPoseGraph
from veloslam_tpu.runtime.pipeline import SlamPipeline as JSlamPipeline
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
from veloslam_tpu_torch.runtime.pipeline import SlamPipeline, crop_graph

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "pipeline_golden_seed3.npz")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["small"]
    paths, seq = write_pipeline_drive(drive, cfg["model"],
                                      str(tmp_path_factory.mktemp("small")))
    pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]), device="cpu")
    pipe.run_offline_batched(paths["pcap"], paths["ins"],
                             batch=drive["batch"], defer_map=True)
    assert pipe.map.n_patches == 0          # deferred to finalize
    res = pipe.finalize()
    return pipe, res, seq, gold


def test_small_pipeline_matches_jax(small):
    pipe, res, seq, gold = small

    def g(k):
        return gold[f"small_{k}"]

    assert res["n_frames"] == int(g("n_frames"))
    np.testing.assert_array_equal(res["times_us"], g("times_us"))
    assert res["n_keyframes"] == int(g("n_keyframes"))
    np.testing.assert_array_equal(res["keyframe_times_us"],
                                  g("keyframe_times_us"))
    assert pipe.closures == [tuple(c) for c in g("closures").tolist()]
    assert res["n_closures"] >= 1
    assert res["n_landmarks"] == int(g("n_landmarks")) >= 2
    assert res["n_landmark_obs"] == int(g("n_landmark_obs"))
    np.testing.assert_array_equal(pipe.graph.o_ok[:pipe.graph.n_obs],
                                  g("obs_kept"))
    assert res["gps_health"]["grounded"]
    assert res["gps_health"]["ground_correction_us"] == int(
        g("ground_correction_us"))
    np.testing.assert_allclose(res["positions"], g("positions"), atol=0.01)
    np.testing.assert_allclose(res["keyframe_positions"],
                               g("keyframe_positions"), atol=0.01)
    np.testing.assert_allclose(
        pipe.graph.l_pos[:pipe.graph.n_landmarks], g("landmarks"),
        atol=0.01)
    assert res["map_patches"] == int(g("map_patches"))
    patches = [pipe.map._materialize(k, create=False)
               for k in sorted(pipe.map._patches)]
    count = sum(float(p.count.sum()) for p in patches)
    assert abs(count - float(g("map_count"))) <= 1e-3 * float(g("map_count"))
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    rmse = ate(res["positions"][:, :2], truth[:, :2], align=False)["rmse"]
    assert rmse <= float(g("ate")) + 0.005
    assert rmse < 0.1 * float(g("ate_raw_ins"))
    assert set(res["timing"]) == {
        "slam_batched", "device_finalize_queue", "device_sweep_readback",
        "landmarks", "graph_solve", "map_downdate", "pipeline_init",
        "read_inputs", "map_rebuild", "trajectory"}


def test_results_have_the_jax_keys_and_ins_health(small):
    """results() after the 2 s drive has the JAX SlamPipeline.results()
    keys, and ins_health equals the JAX package's: offline, only live
    mode's INS datagram handler moves its counters, so both return them as
    initialised (a fresh JAX pipeline)."""
    pipe, res, _, _ = small
    ref = JSlamPipeline().results()
    assert set(res) == set(ref)
    assert res["ins_health"] == ref["ins_health"]
    assert pipe.results()["ins_health"] is not pipe.ins_health


def test_use_dense_index_false_raises(tmp_path):
    """registration.use_dense_index=False, which run_offline_batched
    refused before the binary-search lookup was ported, now takes it
    (FullSlam's use_dense=False, as the JAX pipeline passes it): the
    small drive with it, from pcap through finalize, against the JAX
    package's run of the same files (paths_golden_seed3.npz,
    "search_small") with chip_smoke.py's pipeline gates; here also
    positions within 1 mm and the landmark counts exact."""
    import chip_smoke as cs
    gold = np.load(cs.PATHS_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["batched"]}["search_small"]
    paths, seq = write_pipeline_drive(drive, cfg["model"], str(tmp_path))
    pipe, res, _ = cs.run_pipeline(paths, drive, torch.device("cpu"))
    assert not pipe.cfg.registration.use_dense_index
    cs._check_pipeline(pipe, res, seq, gold, "search_small",
                       cs._launches(), None, torch.device("cpu"))
    np.testing.assert_allclose(res["positions"],
                               gold["search_small_positions"], atol=1e-3)
    for k in ("n_landmarks", "n_landmark_obs"):
        assert res[k] == int(gold[f"search_small_{k}"]), k
    # No dilated index: its window coverage is not tracked.
    assert res["dense_index_min_coverage"] == 1.0


def test_slam_run_fast_matches_the_jax_app(tmp_path):
    """--fast builds the JAX app's engine, StreamingOdometry(batched=True)
    with frame sampling and the exact binary-search lookup (before, the
    port's --fast took the dilated dense index, 1.4 cm away on this
    drive).  Both apps read the same pcap + INS log of a dense world with
    the INS drifting 0.5 m/s (on the default --simulate world no frame
    passes the lateral-observability gate, so every engine returns the
    INS prior): trajectory.txt's times equal, positions within 1 cm
    (measured 1e-6 m, the file's precision)."""
    from veloslam_tpu.apps import slam_run as jax_slam_run
    from veloslam_tpu_torch.apps import slam_run
    from veloslam_tpu_torch.io import packets as pk
    from veloslam_tpu_torch.io import simulate as sim
    seq = sim.generate_sequence(
        duration_s=2.0, model="hdl32", seed=23,
        world=sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24))
    paths = sim.write_sequence(seq, str(tmp_path), name="dense")
    ins = pk.read_ins_txt(paths["ins"])
    ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
    pk.write_ins_txt(paths["ins"], ins["t_us"], ins["pos_xy"] + np.stack(
        [np.zeros_like(ts), 0.5 * ts], -1), np.deg2rad(ins["yaw_deg"]),
        speed=ins["speed"])
    args = ["--fast", "--pcap", paths["pcap"], "--ins", paths["ins"],
            "--batch", "1024"]
    out, ref = tmp_path / "out", tmp_path / "jax"
    assert slam_run.main([*args, "--device", "cpu",
                          "--out-dir", str(out)]) == 0
    assert jax_slam_run.main([*args, "--platform", "cpu",
                              "--out-dir", str(ref)]) == 0
    got = np.loadtxt(out / "trajectory.txt", ndmin=2)
    want = np.loadtxt(ref / "trajectory.txt", ndmin=2)
    assert got.shape == want.shape and len(got) > 10
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.abs(got[:, 1:4] - want[:, 1:4]).max() <= 0.01


def test_golden_config_is_bench_config():
    """The golden's drives and SlamConfigs are what the generator derives
    today from bench.py's full-SLAM config, and the port rebuilds each
    config from them unchanged."""
    import dataclasses

    from fixtures.gen_torch_pipeline_golden import golden_config
    cfg = json.loads(str(np.load(GOLDEN)["config"]))
    assert cfg == golden_config()      # puts the repository on sys.path
    from bench import _slam_cfg
    full = {d["name"]: d for d in cfg["drives"]}["full"]
    want = dataclasses.asdict(_slam_cfg())
    got = dataclasses.asdict(SlamConfig.from_dict(full["slam"]))
    assert got.pop("mesh") == want.pop("mesh")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("counts,caps", [
    ((1, 0, 0, 0), (1024, 4096, 1024, 8192)),
    ((35, 6, 48, 139), (1024, 4096, 1024, 8192)),
    ((300, 100, 700, 900), (1024, 4096, 1024, 8192)),
    ((40, 3, 50, 20), (64, 256, 16, 128)),
])
def test_crop_graph_matches_jax(counts, caps):
    """The port's crop buckets and cropped shapes equal the JAX
    pipeline's on the same graph."""
    K, E, M, O = caps
    jg = JPoseGraph(max_poses=K, max_edges=E, max_landmarks=M, max_obs=O)
    leaves = jg.arrays()
    Kc, cropped, Mc = JSlamPipeline._crop_graph(leaves, *counts)
    Kp, port, Mp = crop_graph(convert.graph_arrays_from_numpy(leaves, "cpu"),
                              *counts)
    assert (Kp, Mp) == (Kc, Mc)
    for f in cropped._fields:
        assert tuple(getattr(port, f).shape) == np.shape(getattr(cropped, f))


@pytest.mark.parametrize("mode,args", [
    ("--batched", ["--simulate", "2"]),
    ("--fast", ["--simulate", "1", "--batch", "2048"])])
def test_slam_run_writes_outputs(tmp_path, mode, args):
    """The CLI in both ported modes writes the JAX app's trajectory.txt
    and metrics.json (ATE against the simulator's truth)."""
    from veloslam_tpu_torch.apps import slam_run
    out = tmp_path / "out"
    assert slam_run.main([mode, *args, "--device", "cpu",
                          "--out-dir", str(out)]) == 0
    traj = np.loadtxt(out / "trajectory.txt", ndmin=2)
    metrics = json.loads((out / "metrics.json").read_text())
    assert traj.shape == (metrics["n_frames"], 8) and len(traj) > 5
    assert set(metrics) == {"registered_fraction", "n_frames",
                            "n_keyframes", "n_closures", "map_patches",
                            "timing", "ate", "rpe"}
    assert metrics["ate"]["rmse"] < 0.1
    assert metrics["timing"]["frames_per_s"] > 0
    assert (metrics["n_keyframes"] > 0) == (mode == "--batched")


def test_slam_run_names_the_per_frame_path_as_not_ported(capsys):
    """The per-frame mode and its BEV artifact are ported: the CLI's help
    names the default mode and offers --bev, which takes an optional
    file name (tests/test_torch_apps.py runs it)."""
    from veloslam_tpu_torch.apps import slam_run
    with pytest.raises(SystemExit):
        slam_run.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "(default) the per-frame pipeline" in text
    assert "`--bev` writes the interactive BEV artifact" in text
    assert "--bev [FILE]" in text and "not ported" not in text
    with pytest.raises(SystemExit):
        slam_run.main(["--simulate", "1", "--device", "cpu", "--bev",
                       "a.html", "--bogus"])
    assert "unrecognized arguments: --bogus" in capsys.readouterr().err


def test_slam_run_default_mode_writes_outputs_and_checkpoint(tmp_path):
    """No mode flag: the per-frame pipeline (run_offline, as the JAX
    app's default) writes trajectory.txt and metrics.json with the ATE,
    and --checkpoint-dir a checkpoint a fresh pipeline loads.  The JAX
    app runs the same simulated drive: the same frames (times exactly)
    and keyframes, and the ATE within 5 mm (its first frame meets an
    empty map; no finalize in this mode)."""
    from veloslam_tpu.apps import slam_run as jax_slam_run
    from veloslam_tpu_torch.apps import slam_run
    out, ck, ref = tmp_path / "out", tmp_path / "ck", tmp_path / "jax"
    assert slam_run.main(["--simulate", "0.6", "--device", "cpu",
                          "--out-dir", str(out),
                          "--checkpoint-dir", str(ck)]) == 0
    assert jax_slam_run.main(["--simulate", "0.6", "--platform", "cpu",
                              "--out-dir", str(ref)]) == 0
    metrics = json.loads((out / "metrics.json").read_text())
    want = json.loads((ref / "metrics.json").read_text())
    traj = np.loadtxt(out / "trajectory.txt", ndmin=2)
    assert metrics["n_frames"] >= 3 and traj.shape == (metrics["n_frames"],
                                                       8)
    assert metrics["n_keyframes"] >= 1 and "ate" in metrics
    for k in ("n_frames", "n_keyframes", "map_patches"):
        assert metrics[k] == want[k], k
    np.testing.assert_array_equal(
        traj[:, 0], np.loadtxt(ref / "trajectory.txt", ndmin=2)[:, 0])
    assert abs(metrics["ate"]["rmse"] - want["ate"]["rmse"]) < 0.005
    assert {"frame", "register", "map_update"} <= set(metrics["timing"])
    back = SlamPipeline(device="cpu")
    back.load_checkpoint(str(ck))
    assert len(back.frames) == metrics["n_frames"]
    assert back.graph.n_poses == metrics["n_keyframes"]
    assert back.map.n_patches == metrics["map_patches"] >= 1
    assert len(back.track) > 0
    times, _ = back.frames.all_frame_meta()
    np.testing.assert_array_equal(times, traj[:, 0].astype(np.int64))
    assert back.frames.get_frame_at(int(times[0]))["xyz"].shape[0] == 32


def test_pipeline_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamPipeline()
    assert SlamPipeline(device="cpu").device.type == "cpu"
