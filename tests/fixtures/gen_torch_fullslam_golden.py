"""Generate fullslam_golden_seed3.npz: the JAX package's device full-SLAM
path on two loop drives, for the port to be held to.

The JAX FullSlam.run_device + finalize_device run on the CPU over:

  * "full": bench.py's full-SLAM drive (bench.py::_make_drive,
    run_full_slam): generate_sequence(duration_s=7.0, model="hdl32",
    seed=3, World.demo(3, extent=40, n_posts=40, n_walls=16),
    circle_trajectory(radius=8, speed=8)) with the INS drifting 1.0 m/s
    in +y, streamed in 4096-packet batches through the engine that
    SlamPipeline.run_offline_batched builds from the production config
    (0.5 m voxels, 65536 map rows, 16384 points, 16 GN iterations,
    re-association every 8, dense index, keyframe ring 1024 x 8192
    points, 2 m / 10 deg), then finalize_device with the parameters
    SlamPipeline._finalize_batched_engine passes under bench._slam_cfg()
    (max_candidates = SlamPipeline._sweep_budget(engine, 8)).  Nothing
    is cut.  chip_smoke.py's `fullslam` phase replays it on the card.
  * "small": the CPU end-to-end test's drive (tests/test_torch_fullslam.py):
    2 s on a 4 m circle, 8192 points, 8192 map rows, a 32-keyframe ring,
    8 candidates, min_gap 8.

The INS PoseTrack is built exactly as the port's io.simulate.truth_track
builds it, so both packages see the same INS.  The npz keeps each drive's
results under "<name>_<field>" and, as JSON under "config", the drives and
the configs, so the port reads both from this one file and needs no jax.

Run from the repository root (JAX on the CPU, a few minutes):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_fullslam_golden.py
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "fullslam_golden_seed3.npz")

WORLD = {"seed": 3, "extent": 40.0, "n_posts": 40, "n_walls": 16}


def golden_config() -> dict:
    """The drives and the engine / finalize parameters, read from the JAX
    package's production config and bench.py's full-SLAM config."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from bench import _slam_cfg
    cfg = _slam_cfg()
    rc, gc, sc = cfg.registration, cfg.graph, cfg.sensor
    engine = {"voxel_size": rc.voxel_size,
              "map_capacity": rc.rolling_map_capacity,
              "reg_points": rc.max_points,
              "reg_iterations": rc.max_iterations,
              "kf_capacity": gc.max_keyframes,
              "kf_dist_m": gc.keyframe_translation_m,
              "kf_rot_deg": gc.keyframe_rotation_deg,
              "reassociate_every": rc.reassociate_every,
              "map_decay": rc.map_decay,
              "frame_rate_hz": sc.rpm / 60.0}
    finalize = {"min_score": gc.sc_min_score,
                "radius": gc.loop_closure_radius_m,
                "min_gap": gc.loop_closure_min_gap,
                "use_scan_context": gc.use_scan_context,
                "gn_iterations": gc.gn_iterations,
                "odom_info": list(gc.odom_edge_info),
                "closure_info": list(gc.closure_edge_info),
                "voxel_size": gc.verify_voxel_m,
                "capacity": rc.scan_voxel_capacity}
    return {
        "model": sc.model,
        "budget_floor": gc.max_closure_candidates_per_sweep,
        "drives": [
            {"name": "full", "duration_s": 7.0, "seed": 3, "world": WORLD,
             "circle": {"radius": 8.0, "speed": 8.0}, "drift_rate": 1.0,
             "batch": 4096, "engine": engine, "finalize": finalize,
             "max_candidates": None},
            {"name": "small", "duration_s": 2.0, "seed": 3, "world": WORLD,
             "circle": {"radius": 4.0, "speed": 8.0}, "drift_rate": 1.0,
             "batch": 1024,
             "engine": dict(engine, map_capacity=8192, reg_points=8192,
                            kf_capacity=32),
             "finalize": dict(finalize, min_gap=8),
             "max_candidates": 8},
        ],
    }


def main():
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from veloslam_tpu.core import se3
    from veloslam_tpu.core.timeline import PoseTrack
    from veloslam_tpu.decode import calibration
    from veloslam_tpu.decode.decode import DeviceCalib
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.fullslam import FullSlam
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    for drive in cfg["drives"]:
        name = drive["name"]
        seq = sim.generate_sequence(
            duration_s=drive["duration_s"], model=cfg["model"],
            seed=drive["seed"], world=sim.World.demo(**drive["world"]),
            trajectory=sim.circle_trajectory(**drive["circle"]))
        track = PoseTrack()
        t0 = seq["ins_t_us"][0]
        for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                                   seq["ins_yaw"], seq["ins_vel"]):
            dp = np.array([0.0, drive["drift_rate"] * (t_us - t0) * 1e-6,
                           0.0])
            track.add(int(t_us), q=se3.euler_deg_to_quat_np(
                0.0, 0.0, np.rad2deg(yaw)), t=np.asarray(p) + dp, v=v)
        eng = FullSlam(DeviceCalib.from_host(calibration.hdl32()),
                       model=cfg["model"], use_dense=True,
                       **drive["engine"])
        eng.run_device(seq["packets"], seq["pkt_times_us"], track,
                       batch=drive["batch"])
        budget = drive["max_candidates"] or SlamPipeline._sweep_budget(
            eng, cfg["budget_floor"])
        dev = eng.finalize_device(max_candidates=budget, **drive["finalize"])
        host = {k: np.asarray(v) for k, v in dev.items()
                if not isinstance(v, tuple)}
        n = int(host["n_frames"])
        times_us = (host["traj_time"][:n].astype(np.float64) * 1e6
                    + eng._stream_t0_us).astype(np.int64)
        truth = interpolate_positions(times_us, seq["ins_t_us"],
                                      seq["ins_pos"])
        t_rel = (times_us - seq["ins_t_us"][0]) * 1e-6
        res = {
            "n_frames": n, "times_us": times_us,
            "kf_n": int(host["kf_n"]), "max_candidates": budget,
            "cand_i": host["cand_i"], "cand_j": host["cand_j"],
            "cand_valid": host["cand_valid"], "accept": host["accept"],
            "meas_q": host["meas_q"], "meas_t": host["meas_t"],
            "solved_t": host["solved_t"][:int(host["kf_n"])],
            "positions": host["traj_t"][:n],
            "quaternions": host["traj_q"][:n],
            "odometry_positions": np.asarray(eng.state.traj_t)[:n],
            # 2-D ATE against the simulator's truth, as bench.py scores
            # the full-SLAM stage; raw INS = the drift alone.
            "ate": ate(host["traj_t"][:n, :2], truth[:, :2],
                       align=False)["rmse"],
            "ate_raw_ins": float(np.sqrt(np.mean(
                (drive["drift_rate"] * t_rel) ** 2))),
        }
        for k, v in res.items():
            out[f"{name}_{k}"] = v
        print(f"{name}: {n} frames, {res['kf_n']} keyframes, "
              f"{int(host['cand_valid'].sum())} candidates of {budget}, "
              f"{int(host['accept'].sum())} accepted; ATE {res['ate']:.4f} m "
              f"(raw INS {res['ate_raw_ins']:.3f} m)", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
