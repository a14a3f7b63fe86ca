"""Generate bench_golden_seed3.npz: the JAX package's full-SLAM stage of
bench.py at its default length, for bench_torch.py's full-SLAM stage to be
held to.

bench.py::run_full_slam(duration_s=20.0) with nothing cut: the drive of
bench._make_drive(20.0) (generate_sequence(duration_s=20, model="hdl32",
seed=3, World.demo(3, extent=40, n_posts=40, n_walls=16),
circle_trajectory(radius=8, speed=8)), the INS log drifting 1.0 m/s in
+y), bench._slam_cfg(), then the JAX SlamPipeline on the CPU:

    run_offline_batched(pcap, ins, batch=4096, defer_map=True); finalize()

The npz keeps the results only (counts, times, positions, keyframes,
closures, landmarks, map sizes, the 2-D ATE as bench.py scores it) under
"full_<field>", as gen_torch_pipeline_golden.py's `record` writes them,
and, as JSON under "config", the drive with its SlamConfig as
dataclasses.asdict, so chip_smoke.py's `bench` phase reads it without jax.

Run from the repository root (JAX on the CPU, several minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_bench_golden.py
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "bench_golden_seed3.npz")

DURATION_S = 20.0
BATCH = 4096


def golden_config() -> dict:
    """bench.py's full-SLAM drive and its SlamConfig, as plain JSON
    values."""
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import _slam_cfg
    from gen_torch_pipeline_golden import WORLD
    slam = dataclasses.asdict(_slam_cfg())
    slam.pop("mesh")           # the multi-device layout: not used here
    return {"model": "hdl32", "drives": [
        {"name": "full", "duration_s": DURATION_S, "seed": 3,
         "world": WORLD, "circle": {"radius": 8.0, "speed": 8.0},
         "drift_rate": 1.0, "batch": BATCH,
         "slam": json.loads(json.dumps(slam))}]}


def main():
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax
    jax.config.update("jax_platforms", "cpu")

    import bench
    from gen_torch_pipeline_golden import record
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    drive = cfg["drives"][0]
    out = {"config": json.dumps(cfg)}
    paths, seq = bench._make_drive(DURATION_S)
    try:
        pipe = SlamPipeline(bench._slam_cfg())
        pipe.run_offline_batched(paths["pcap"], paths["ins"], batch=BATCH,
                                 defer_map=True)
        res = pipe.finalize()
    finally:
        shutil.rmtree(os.path.dirname(paths["pcap"]))
    r = record(pipe, res, seq, drive)
    for k, v in r.items():
        out[f"full_{k}"] = v
    print(f"full: {r['n_frames']} frames, {r['n_keyframes']} keyframes, "
          f"{len(r['closures'])} closures, {r['n_landmarks']} landmarks, "
          f"{r['map_patches']} patches, {r['map_voxels']} voxels; ATE "
          f"{r['ate']:.4f} m (raw INS {r['ate_raw_ins']:.3f} m)", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
