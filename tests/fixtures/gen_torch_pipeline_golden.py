"""Generate pipeline_golden_seed3.npz: the JAX package's user-facing
full-SLAM pipeline on two loop drives, from pcap to corrected trajectory,
landmarks and tiled map, for the port to be held to.

Each drive is written as a pcap (position packets every 1 s, so offline
loads take the GPS-grounding path) plus an INS text log whose positions
drift 1.0 m/s in +y, exactly as bench.py::_make_drive writes it; then the
JAX SlamPipeline runs on the CPU:

    run_offline_batched(pcap, ins, batch=B, defer_map=True); finalize()

  * "full": bench.py's full-SLAM stage (bench.py::run_full_slam):
    generate_sequence(duration_s=7.0, model="hdl32", seed=3,
    World.demo(3, extent=40, n_posts=40, n_walls=16),
    circle_trajectory(radius=8, speed=8)), bench._slam_cfg(), 4096-packet
    batches.  Nothing is cut.  chip_smoke.py's `pipeline` phase replays it
    on the card.
  * "small": the CPU end-to-end test's drive
    (tests/test_torch_pipeline.py): 2 s on a 4 m circle with 8192
    registration points, 8192 map rows, a 32-keyframe ring, closure
    min_gap 8 and 1024-packet batches; its finalize accepts closures and
    keeps landmarks, so every finalize stage runs.

The npz keeps each drive's results under "<name>_<field>" (results only,
no keyframe scans) and, as JSON under "config", the drives with their
SlamConfig as dataclasses.asdict, so the port rebuilds the same config
from this one file and needs no jax.

Run from the repository root (JAX on the CPU, a few minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_pipeline_golden.py
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "pipeline_golden_seed3.npz")

WORLD = {"seed": 3, "extent": 40.0, "n_posts": 40, "n_walls": 16}


def golden_config() -> dict:
    """The drives and their SlamConfigs (bench.py's full-SLAM config, cut
    for the small drive), as plain JSON values."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from bench import _slam_cfg
    full = _slam_cfg()
    small = full.replace(
        registration=dataclasses.replace(full.registration, max_points=8192,
                                         rolling_map_capacity=8192),
        graph=dataclasses.replace(full.graph, max_keyframes=32,
                                  loop_closure_min_gap=8))

    def as_dict(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("mesh")          # the multi-device layout: not ported yet
        return json.loads(json.dumps(d))

    return {"model": "hdl32", "drives": [
        {"name": "full", "duration_s": 7.0, "seed": 3, "world": WORLD,
         "circle": {"radius": 8.0, "speed": 8.0}, "drift_rate": 1.0,
         "batch": 4096, "slam": as_dict(full)},
        {"name": "small", "duration_s": 2.0, "seed": 3, "world": WORLD,
         "circle": {"radius": 4.0, "speed": 8.0}, "drift_rate": 1.0,
         "batch": 1024, "slam": as_dict(small)},
    ]}


def write_drive(sim, pkmod, drive: dict, model: str, out_dir: str):
    """bench.py::_make_drive for any drive of the config: the sequence,
    its pcap + INS log, and the INS positions drifted in +y."""
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=model, seed=drive["seed"],
        world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    paths = sim.write_sequence(seq, out_dir, name=drive["name"])
    ins = pkmod.read_ins_txt(paths["ins"])
    ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
    pkmod.write_ins_txt(paths["ins"], ins["t_us"],
                        ins["pos_xy"] + np.stack(
                            [np.zeros_like(ts), drive["drift_rate"] * ts],
                            -1),
                        np.deg2rad(ins["yaw_deg"]), speed=ins["speed"])
    return paths, seq


def main():
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from veloslam_tpu.config import (GraphConfig, MapConfig, PipelineConfig,
                                     RegistrationConfig, SensorConfig,
                                     SlamConfig)
    from veloslam_tpu.io import packets as pkmod
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    def config(d):
        tup = {k: tuple(v) if isinstance(v, list) else v
               for k, v in d["graph"].items()}
        sensor = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in d["sensor"].items()}
        return SlamConfig(sensor=SensorConfig(**sensor),
                          pipeline=PipelineConfig(**d["pipeline"]),
                          registration=RegistrationConfig(
                              **d["registration"]),
                          map=MapConfig(**d["map"]),
                          graph=GraphConfig(**tup))

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    for drive in cfg["drives"]:
        name = drive["name"]
        with tempfile.TemporaryDirectory() as d:
            paths, seq = write_drive(sim, pkmod, drive, cfg["model"], d)
            pipe = SlamPipeline(config(drive["slam"]))
            pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                     batch=drive["batch"], defer_map=True)
            res = pipe.finalize()
        g = pipe.graph
        truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                      seq["ins_pos"])
        t_rel = (res["times_us"] - seq["ins_t_us"][0]) * 1e-6
        patches = [pipe.map._materialize(k, create=False)
                   for k in sorted(set(pipe.map._patches)
                                   | set(pipe.map._spilled))]
        r = {
            "n_frames": res["n_frames"], "times_us": res["times_us"],
            "positions": res["positions"],
            "quaternions": res["quaternions"],
            "n_keyframes": res["n_keyframes"],
            "keyframe_times_us": res["keyframe_times_us"],
            "keyframe_positions": res["keyframe_positions"],
            "closures": np.asarray(pipe.closures, np.int64).reshape(-1, 2),
            "n_landmarks": res["n_landmarks"],
            "n_landmark_obs": res["n_landmark_obs"],
            "landmarks": g.l_pos[:g.n_landmarks],
            "obs_kept": g.o_ok[:g.n_obs],
            "map_patches": res["map_patches"],
            "map_voxels": sum(p.n_voxels for p in patches),
            "map_count": sum(float(p.count.sum()) for p in patches),
            "ground_correction_us":
                res["gps_health"]["ground_correction_us"],
            # 2-D ATE against the simulator's truth, as bench.py scores
            # the full-SLAM stage; raw INS = the drift alone.
            "ate": ate(res["positions"][:, :2], truth[:, :2],
                       align=False)["rmse"],
            "ate_raw_ins": float(np.sqrt(np.mean(
                (drive["drift_rate"] * t_rel) ** 2))),
        }
        for k, v in r.items():
            out[f"{name}_{k}"] = v
        print(f"{name}: {r['n_frames']} frames, {r['n_keyframes']} "
              f"keyframes, {len(r['closures'])} closures, "
              f"{r['n_landmarks']} landmarks / {r['n_landmark_obs']} obs "
              f"({int(r['obs_kept'].sum())} kept), {r['map_patches']} "
              f"patches, {r['map_voxels']} voxels; ATE {r['ate']:.4f} m "
              f"(raw INS {r['ate_raw_ins']:.3f} m); timing "
              f"{ {k: round(v['total_s'], 2) for k, v in res['timing'].items()} }",
              flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
