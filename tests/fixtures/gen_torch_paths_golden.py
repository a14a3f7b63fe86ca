"""Generate paths_golden_seed3.npz: the JAX package on the paths the port
took on last (its D2D and NDT registration, StreamingOdometry's fused
path and `slam_run --fast`'s engine, the batched pipeline without the
dense index), for the port to be held to.

  * per-frame D2D and NDT ("d2d_full", "ndt_full", "d2d_small",
    "ndt_small"): the "full" and "small" drives of
    perframe_golden_seed3.npz (gen_torch_perframe_golden.py) with
    registration.method "d2d" / "ndt", through the JAX SlamPipeline's
    run_offline + finalize, results as that golden keeps them.  "full" is
    bench.py's 7 s drive with bench._slam_cfg(): 16384 points, 16 GN
    iterations, a ROI of up to 16384 1 m voxels, an 8192-voxel scan grid
    for D2D.  Nothing is cut.  Each drive runs a second time in
    ALT_BATCH-packet batches (the same frames and times): the largest x, y
    distance between the two trajectories is kept as "<name>_self_spread"
    (with the second run's ATE, "<name>_alt_ate"), how far the reference
    reproduces itself when only float rounding changes.
  * odometry ("fused_<drive>", "fast_<drive>"): the two 1.2 s drives of
    odometry_golden_seed23.npz (its config: world, drift, seed) through
    StreamingOdometry(calib) with the JAX defaults (1 m voxels, 16384
    points, 8 GN iterations, a 32768-row map, fused, the exact
    binary-search lookup) in 512-packet batches, and through slam_run
    --fast's engine, StreamingOdometry(calib, n_beams=32, batched=True),
    in 2048-packet batches: times, positions, quaternions, frame count.
  * batched pipeline without the dense index ("search_full",
    "search_small"): the "full" and "small" drives of
    pipeline_golden_seed3.npz (gen_torch_pipeline_golden.py) with
    registration.use_dense_index=False, through run_offline_batched +
    finalize, results as that golden keeps them.

The configs go in as JSON under "config", so the port needs no jax.

Run from the repository root (JAX on the CPU, ~15 minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_paths_golden.py
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "paths_golden_seed3.npz")
FUSED_BATCH = 512
FAST_BATCH = 2048
ALT_BATCH = 256


def golden_config() -> dict:
    """Each part's drives, as plain JSON values."""
    for p in (HERE, REPO):
        if p not in sys.path:
            sys.path.insert(0, p)
    from gen_torch_perframe_golden import golden_config as perframe
    from gen_torch_pipeline_golden import golden_config as batched
    per_frame = []
    frame_drives = {d["name"]: d for d in perframe()["drives"]}
    for method in ("d2d", "ndt"):
        for size in ("full", "small"):
            d = json.loads(json.dumps(frame_drives[size]))
            d["name"] = f"{method}_{size}"
            d["slam"]["registration"]["method"] = method
            per_frame.append(d)
    search = []
    for d in batched()["drives"]:
        d = json.loads(json.dumps(d))
        d["name"] = f"search_{d['name']}"
        d["slam"]["registration"]["use_dense_index"] = False
        search.append(d)
    odo = json.loads(str(np.load(os.path.join(
        HERE, "odometry_golden_seed23.npz"))["config"]))
    return {"model": "hdl32", "per_frame": per_frame, "batched": search,
            "alt_batch": ALT_BATCH,
            "odometry": {k: odo[k] for k in ("duration_s", "model", "seed",
                                             "drives")},
            "fused_batch": FUSED_BATCH, "fast_batch": FAST_BATCH}


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from gen_torch_perframe_golden import record as frame_record
    from gen_torch_pipeline_golden import jax_slam_config, write_drive
    from gen_torch_pipeline_golden import record as batched_record
    from veloslam_tpu.core import se3
    from veloslam_tpu.core.timeline import PoseTrack
    from veloslam_tpu.decode import calibration
    from veloslam_tpu.decode.decode import DeviceCalib
    from veloslam_tpu.io import packets as pkmod
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.odometry import StreamingOdometry
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}

    def keep(name, r):
        for k, v in r.items():
            out[f"{name}_{k}"] = v

    for drive in cfg["per_frame"] + cfg["batched"]:
        name = drive["name"]
        with tempfile.TemporaryDirectory() as d:
            paths, seq = write_drive(sim, pkmod, drive, cfg["model"], d)
            pipe = SlamPipeline(jax_slam_config(drive["slam"]))
            if drive in cfg["per_frame"]:
                pipe.run_offline(paths["pcap"], paths["ins"])
                mid = list(pipe.closures)
                res = pipe.finalize()
                r = frame_record(pipe, res, mid, seq, drive)
                alt = json.loads(json.dumps(drive["slam"]))
                alt["pipeline"]["packets_per_batch"] = cfg["alt_batch"]
                other = SlamPipeline(jax_slam_config(alt))
                other.run_offline(paths["pcap"], paths["ins"])
                a = frame_record(other, other.finalize(), [], seq, drive)
                if not np.array_equal(a["times_us"], r["times_us"]):
                    raise AssertionError(f"{name}: the {cfg['alt_batch']}-"
                                         "packet run has other frames")
                r["self_spread"] = float(np.linalg.norm(
                    a["positions"][:, :2] - r["positions"][:, :2],
                    axis=1).max())
                r["alt_ate"] = a["ate"]
            else:
                pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                         batch=drive["batch"],
                                         defer_map=True)
                res = pipe.finalize()
                r = batched_record(pipe, res, seq, drive)
        keep(name, r)
        print(f"{name}: {r['n_frames']} frames, {r['n_keyframes']} "
              f"keyframes, closures {pipe.closures}, {r['n_landmarks']} "
              f"landmarks; ATE {r['ate']:.4f} m (raw INS "
              f"{r['ate_raw_ins']:.3f} m); self spread "
              f"{r.get('self_spread', 'n/a')} m", flush=True)

    oc = cfg["odometry"]
    for drive in oc["drives"]:
        seq = sim.generate_sequence(duration_s=oc["duration_s"],
                                    model=oc["model"], seed=oc["seed"],
                                    world=sim.World.demo(**drive["world"]))
        track = PoseTrack()
        t0 = seq["ins_t_us"][0]
        for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                                   seq["ins_yaw"], seq["ins_vel"]):
            dp = np.array([0.0, drive["drift_rate"] * (t_us - t0) * 1e-6,
                           0.0])
            track.add(int(t_us), q=se3.euler_deg_to_quat_np(
                0.0, 0.0, np.rad2deg(yaw)), t=np.asarray(p) + dp, v=v)
        calib = DeviceCalib.from_host(calibration.hdl32())
        for part, eng, batch in (
                ("fused", StreamingOdometry(calib), cfg["fused_batch"]),
                ("fast", StreamingOdometry(calib, model=oc["model"],
                                           n_beams=32, batched=True),
                 cfg["fast_batch"])):
            res = eng.run(seq["packets"], seq["pkt_times_us"], track,
                          batch=batch)
            keep(f"{part}_{drive['name']}",
                 {k: res[k] for k in ("times_us", "positions",
                                      "quaternions", "n_frames")})
            print(f"{part}_{drive['name']}: {res['n_frames']} frames",
                  flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
