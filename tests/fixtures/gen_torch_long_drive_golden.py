"""Generate long_drive_golden_seed3.npz: the JAX package's user-facing
pipeline on a session of more than 2048 keyframes, for the port to be
held to.

The drive is tests/test_fullslam.py::test_unbounded_session_end_to_end:
44 s of HDL-32 spinning at 3600 rpm on a 12 m circle at 8 m/s,
World.demo(seed=3, extent=30, n_posts=24, n_walls=8), written as a pcap +
INS log by write_sequence (INS at truth), then on the CPU

    SlamPipeline(cfg).run_offline_batched(pcap, ins, batch=4096,
                                          defer_map=True); finalize()

with cfg = SlamConfig(sensor=SensorConfig(rpm=3600),
registration=RegistrationConfig(max_points=2048, max_iterations=4),
graph=GraphConfig(keyframe_translation_m=0.05, loop_closure_min_gap=600)),
landmarks on.  It gives ~2600 keyframes in a 4096-row keyframe ring, so
every graph solve of the session runs the matrix-free PCG solvers
(graph/pcg.py): the device finalize's pose-only solve at K = 4096 and the
two landmark solves at Kc = 4096.  The registration width and GN count
are the test's cut, so that this golden can be made on the CPU; the
graph, ring, landmark, closure and map state are at full scale.
chip_smoke.py's `long_drive` phase replays it on the card.

The npz keeps the results only (no keyframe scans) and, as JSON under
"config", the drive with its SlamConfig as dataclasses.asdict, so the port
rebuilds the same config from this file and needs no jax.

Run from the repository root (JAX on the CPU; ~3.5 min on 8 cores: the
simulation ~75 s, the pipeline ~125 s; ~1.5 GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_long_drive_golden.py
"""

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "long_drive_golden_seed3.npz")


def golden_config() -> dict:
    """The drive and its SlamConfig as plain JSON values."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from veloslam_tpu_torch.config import (GraphConfig, RegistrationConfig,
                                           SensorConfig, SlamConfig)
    cfg = SlamConfig(
        sensor=SensorConfig(rpm=3600.0),
        registration=RegistrationConfig(max_points=2048, max_iterations=4),
        graph=GraphConfig(keyframe_translation_m=0.05,
                          loop_closure_min_gap=600))
    slam = dataclasses.asdict(cfg)
    slam.pop("mesh")          # the goldens keep no multi-device layout
    return {"model": "hdl32", "drive": {
        "name": "long", "duration_s": 44.0, "rpm": 3600.0, "seed": 3,
        "world": {"seed": 3, "extent": 30.0, "n_posts": 24, "n_walls": 8},
        "circle": {"radius": 12.0, "speed": 8.0}, "batch": 4096,
        "slam": json.loads(json.dumps(slam))}}


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from gen_torch_pipeline_golden import jax_slam_config
    from veloslam_tpu.graph import pcg
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    drive = cfg["drive"]
    t0 = time.perf_counter()
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=cfg["model"], rpm=drive["rpm"],
        seed=drive["seed"], world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    sim_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        paths = sim.write_sequence(seq, d, name=drive["name"])
        pipe = SlamPipeline(jax_slam_config(drive["slam"]))
        t1 = time.perf_counter()
        pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                 batch=drive["batch"], defer_map=True)
        res = pipe.finalize()
        run_s = time.perf_counter() - t1
    g = pipe.graph
    assert g.n_poses > pcg.DENSE_MAX_POSES, g.n_poses
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    r = {
        "n_frames": res["n_frames"], "times_us": res["times_us"],
        "positions": res["positions"],
        "n_keyframes": res["n_keyframes"],
        "keyframe_positions": res["keyframe_positions"],
        "closures": np.asarray(pipe.closures, np.int64).reshape(-1, 2),
        "n_landmarks": res["n_landmarks"],
        "n_landmark_obs": res["n_landmark_obs"],
        "ring_full": res["ring_full"],
        "ate": ate(res["positions"][:, :2], truth[:, :2],
                   align=False)["rmse"],
    }
    np.savez_compressed(OUT, config=json.dumps(cfg), **r)
    print(f"long: {r['n_frames']} frames, {r['n_keyframes']} keyframes, "
          f"{len(r['closures'])} closures, {r['n_landmarks']} landmarks / "
          f"{r['n_landmark_obs']} obs, ring_full {r['ring_full']}; 2-D ATE "
          f"{r['ate']:.4f} m; simulation {sim_s:.1f} s, pipeline "
          f"{run_s:.1f} s; timing "
          f"{ {k: round(v['total_s'], 2) for k, v in res['timing'].items()} }",
          flush=True)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
