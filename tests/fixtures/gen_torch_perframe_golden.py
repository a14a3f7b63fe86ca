"""Generate perframe_golden_seed3.npz: the JAX package's per-frame SLAM
pipeline (slam_run's default mode) on three loop drives, from pcap to
corrected trajectory, closures, landmarks and tiled map, for the port to
be held to.

Each drive is written as a pcap (position packets every 1 s, so offline
loads take the GPS-grounding path) plus an INS text log whose positions
drift 1.0 m/s in +y, exactly as bench.py::_make_drive writes it
(gen_torch_pipeline_golden.write_drive); then the JAX SlamPipeline runs
on the CPU, in `PipelineConfig.packets_per_batch` (512) packet batches:

    run_offline(pcap, ins); finalize()

  * "full": bench.py's full-SLAM drive (generate_sequence(duration_s=7.0,
    model="hdl32", seed=3, World.demo(3, extent=40, n_posts=40,
    n_walls=16), circle_trajectory(radius=8, speed=8))) with
    bench._slam_cfg() (closure min_gap 12, sc_min_score 0.55): 16384
    registration points, 16 GN iterations in two association blocks, a
    256×256×32 dense index per frame over a ROI of up to 16384 1 m
    voxels, 100 m tiles, a 1024-keyframe graph.  Nothing is cut.
    chip_smoke.py's `per_frame` phase replays it on the card.
  * "small": the 2 s drive of pipeline_golden_seed3.npz's "small" (a 4 m
    circle at 8 m/s, so every frame turns past the 10° keyframe gate and
    is a keyframe), 8192 registration points, a 32-keyframe graph,
    closure min_gap 8.  Chosen so that the sweep at keyframe 10 accepts a
    closure mid-session (keyframes 0 and 8 lie within the 15 m radius), so
    _try_loop_closure → _solve_graph → update_map_incremental runs, and
    finalize()'s sweep accepts another before the landmark solve.
  * "small_search": "small" with registration.use_dense_index=False (the
    binary-search correspondence lookup).

The npz keeps each drive's results under "<name>_<field>" (results only,
no frames or scans): times, trajectory, keyframes, the closures accepted
during the stream and in all, landmarks, the per-tile map counts; and,
as JSON under "config", the drives with their SlamConfig as
dataclasses.asdict, so the port rebuilds the same config from this one
file and needs no jax.

Run from the repository root (JAX on the CPU, ~3 minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_perframe_golden.py
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "perframe_golden_seed3.npz")


def golden_config() -> dict:
    """The drives and their SlamConfigs (bench.py's full-SLAM config, cut
    for the small drives), as plain JSON values."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from gen_torch_pipeline_golden import golden_config as batched
    drives = {d["name"]: d for d in batched()["drives"]}
    full = {k: v for k, v in drives["full"].items() if k != "batch"}
    small = {k: v for k, v in drives["small"].items() if k != "batch"}
    search = json.loads(json.dumps(small))
    search["name"] = "small_search"
    search["slam"]["registration"]["use_dense_index"] = False
    return {"model": "hdl32", "drives": [full, small, search]}


def record(pipe, res, mid, seq, drive: dict) -> dict:
    """A JAX per-frame run's results as the golden keeps them: times,
    trajectory, registered flags, keyframes, the closures accepted during
    the stream and in all, landmarks, per-tile map counts, 2-D ATE."""
    from chip_smoke import map_tiles
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    g = pipe.graph
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    t_rel = (res["times_us"] - seq["ins_t_us"][0]) * 1e-6
    tiles, tile_counts = map_tiles(pipe)
    return {
        "n_frames": res["n_frames"], "times_us": res["times_us"],
        "positions": res["positions"],
        "quaternions": res["quaternions"],
        "registered": np.asarray([f.registered for f in pipe.trajectory]),
        "n_keyframes": res["n_keyframes"],
        "keyframe_times_us": res["keyframe_times_us"],
        "keyframe_positions": res["keyframe_positions"],
        "closures_mid": np.asarray(mid, np.int64).reshape(-1, 2),
        "closures": np.asarray(pipe.closures, np.int64).reshape(-1, 2),
        "n_landmarks": res["n_landmarks"],
        "n_landmark_obs": res["n_landmark_obs"],
        "landmarks": g.l_pos[:g.n_landmarks],
        "obs_kept": g.o_ok[:g.n_obs],
        "map_patches": res["map_patches"],
        "map_tiles": tiles, "map_tile_counts": tile_counts,
        "ground_correction_us": res["gps_health"]["ground_correction_us"],
        # 2-D ATE against the simulator's truth, as bench.py scores full
        # SLAM; raw INS = the drift alone.
        "ate": ate(res["positions"][:, :2], truth[:, :2],
                   align=False)["rmse"],
        "ate_raw_ins": float(np.sqrt(np.mean(
            (drive["drift_rate"] * t_rel) ** 2))),
    }


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from gen_torch_pipeline_golden import jax_slam_config, write_drive
    from veloslam_tpu.io import packets as pkmod
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    for drive in cfg["drives"]:
        name = drive["name"]
        with tempfile.TemporaryDirectory() as d:
            paths, seq = write_drive(sim, pkmod, drive, cfg["model"], d)
            pipe = SlamPipeline(jax_slam_config(drive["slam"]))
            pipe.run_offline(paths["pcap"], paths["ins"])
            mid = list(pipe.closures)
            res = pipe.finalize()
        r = record(pipe, res, mid, seq, drive)
        for k, v in r.items():
            out[f"{name}_{k}"] = v
        print(f"{name}: {r['n_frames']} frames "
              f"({int(r['registered'].sum())} registered), "
              f"{r['n_keyframes']} keyframes, closures mid-session "
              f"{mid}, in all {pipe.closures}, {r['n_landmarks']} "
              f"landmarks / {r['n_landmark_obs']} obs, {r['map_patches']} "
              f"patches; ATE {r['ate']:.4f} m (raw INS "
              f"{r['ate_raw_ins']:.3f} m); timing "
              f"{ {k: round(v['total_s'], 2) for k, v in res['timing'].items()} }",
              flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
