"""Generate odometry_golden_seed23.npz: the JAX package's batched
streaming-odometry trajectories for the drives chip_smoke.py replays.

The JAX StreamingOdometry(batched=True) runs on the CPU with the
production registration config (veloslam_tpu.config.RegistrationConfig:
0.5 m voxels, 65536 map rows, 16384 points, 16 GN iterations,
re-association every 8, dilated dense index, sample assembly) over two
1.2 s HDL-32 drives of generate_sequence(seed=23), fed in 256-packet
batches:

  * "demo6": World.demo(6) with the INS at truth (the drive of
    tests/test_odometry.py).  At 0.5 m voxels its sparse map never passes
    the lateral-observability gate in 1.2 s, so every pose is the prior.
  * "dense8_drift": World.demo(8, extent=40, n_posts=60, n_walls=24)
    with the INS drifting 0.3 m/s sideways (the drive of
    test_streaming_odometry_corrects_drifting_ins): registration output
    is accepted and corrects the drift.

The npz keeps each drive's trajectory under "<name>_<field>" and, as JSON
under "config", the drives and the config, so the port's replays
(chip_smoke.py on the card, tests/test_torch_odometry.py on the CPU) read
both from this one file and need no jax.

Run from the repository root:
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_odometry_golden.py
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "odometry_golden_seed23.npz")

DRIVES = [
    {"name": "demo6", "world": {"seed": 6}, "drift_rate": 0.0},
    {"name": "dense8_drift",
     "world": {"seed": 8, "extent": 40.0, "n_posts": 60, "n_walls": 24},
     "drift_rate": 0.3},
]


def golden_config() -> dict:
    from veloslam_tpu.config import RegistrationConfig
    reg = RegistrationConfig()
    return {
        "duration_s": 1.2, "model": "hdl32", "seed": 23, "batch": 256,
        "drives": DRIVES,
        "odometry": {"voxel_size": reg.voxel_size,
                     "reg_points": reg.max_points,
                     "reg_iterations": reg.max_iterations,
                     "map_capacity": reg.rolling_map_capacity,
                     "reassociate_every": reg.reassociate_every,
                     "map_decay": reg.map_decay},
    }


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")

    from veloslam_tpu.core import se3
    from veloslam_tpu.core.timeline import PoseTrack
    from veloslam_tpu.decode import calibration
    from veloslam_tpu.decode.decode import DeviceCalib
    from veloslam_tpu.io import simulate as sim
    from veloslam_tpu.runtime.odometry import StreamingOdometry

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    for drive in cfg["drives"]:
        seq = sim.generate_sequence(duration_s=cfg["duration_s"],
                                    model=cfg["model"], seed=cfg["seed"],
                                    world=sim.World.demo(**drive["world"]))
        track = PoseTrack()
        t0 = seq["ins_t_us"][0]
        for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                                   seq["ins_yaw"], seq["ins_vel"]):
            dp = np.array([0.0, drive["drift_rate"] * (t_us - t0) * 1e-6,
                           0.0])
            track.add(int(t_us), q=se3.euler_deg_to_quat_np(
                0.0, 0.0, np.rad2deg(yaw)), t=np.asarray(p) + dp, v=v)
        odo = StreamingOdometry(DeviceCalib.from_host(calibration.hdl32()),
                                model=cfg["model"], batched=True,
                                use_dense=True, sample_assembly=True,
                                **cfg["odometry"])
        res = odo.run(seq["packets"], seq["pkt_times_us"], track,
                      batch=cfg["batch"])
        for k in ("times_us", "positions", "quaternions", "n_frames"):
            out[f"{drive['name']}_{k}"] = res[k]
        print(f"{drive['name']}: {res['n_frames']} frames")
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
