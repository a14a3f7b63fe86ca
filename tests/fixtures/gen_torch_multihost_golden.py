"""Generate multihost_golden_seed3.npz: the JAX package's distributed SLAM
session (veloslam_tpu.parallel.session.DistributedSlamSession) on two
processes, for the port's session to be held to.

Each drive is written as a pcap + INS text log; then two worker
processes (this script with --worker, JAX on the CPU, one device each,
jax.distributed over a localhost coordinator) each run

    DistributedSlamSession(cfg).run_offline(pcap, ins); finalize()

with the map tiles partitioned between them by dist.tile_owner, and a
single-process SlamPipeline runs the same drive in this process as the
oracle.

  * "small": tests/test_multihost.py's session drive, nothing changed:
    generate_sequence(duration_s=1.0, model="hdl32", seed=21,
    World.demo(9)) on the default 30 m circle at 5 m/s, INS at truth,
    128-packet batches, 16384 registration points, 8 GN iterations.
  * "full": bench.py's full-SLAM drive per frame, as the per_frame golden
    (gen_torch_perframe_golden.py) runs it: 7 s on an 8 m circle at 8
    m/s, INS drifting 1 m/s in +y, bench._slam_cfg(), 512-packet
    batches, 16384 points, 16 GN iterations, finalize() with landmarks
    (the sharded Schur solve).  Nothing is cut.

The npz keeps, under "<drive>_p<rank>_<field>", each rank's stream
(after run_offline) and final (after finalize) trajectory, registered
flags, keyframes, closures, landmark count and owned tiles, and under
"<drive>_oracle_<field>" the single-process run's; as JSON under
"config", the drives with their SlamConfig as dataclasses.asdict (the
mesh layout left out: the session builds its own mesh over the
processes), so the port rebuilds the same config from this one file.

Run from the repository root (JAX on the CPU, two processes, ~10 min):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_multihost_golden.py
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "multihost_golden_seed3.npz")
N_PROCS = 2


def golden_config() -> dict:
    """The two drives and their SlamConfigs as plain JSON values."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import dataclasses

    from gen_torch_perframe_golden import golden_config as perframe
    from veloslam_tpu.config import (PipelineConfig, RegistrationConfig,
                                     SensorConfig, SlamConfig)
    full = next(d for d in perframe()["drives"] if d["name"] == "full")
    small_cfg = dataclasses.asdict(SlamConfig(
        sensor=SensorConfig(model="hdl32"),
        pipeline=PipelineConfig(packets_per_batch=128),
        registration=RegistrationConfig(max_points=16384,
                                        max_iterations=8)))
    small_cfg.pop("mesh")
    small = {"name": "small", "duration_s": 1.0, "seed": 21,
             "world": {"seed": 9}, "circle": {"radius": 30.0, "speed": 5.0},
             "drift_rate": 0.0, "slam": json.loads(json.dumps(small_cfg))}
    return {"model": "hdl32", "n_procs": N_PROCS, "drives": [small, full]}


def write_drive(drive: dict, model: str, out_dir: str):
    """The drive's sequence as pcap + INS log (drifted when asked)."""
    from gen_torch_pipeline_golden import write_drive as drifted
    from veloslam_tpu.io import packets as pkmod
    from veloslam_tpu.io import simulate as sim
    if drive["drift_rate"]:
        return drifted(sim, pkmod, drive, model, out_dir)
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=model, seed=drive["seed"],
        world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    return sim.write_sequence(seq, out_dir, name=drive["name"]), seq


def record(pipe, stream: dict, final: dict) -> dict:
    """One run's results as the golden keeps them."""
    tiles = sorted(set(pipe.map._patches) | set(pipe.map._spilled))
    return {
        "times_us": final["times_us"],
        "stream_positions": stream["positions"],
        "stream_quaternions": stream["quaternions"],
        "positions": final["positions"],
        "quaternions": final["quaternions"],
        "registered": np.asarray([f.registered for f in pipe.trajectory]),
        "registered_fraction": final["registered_fraction"],
        "n_keyframes": final["n_keyframes"],
        "keyframe_times_us": final["keyframe_times_us"],
        "keyframe_positions": final["keyframe_positions"],
        "closures": np.asarray(pipe.closures, np.int64).reshape(-1, 2),
        "n_landmarks": final["n_landmarks"],
        "n_landmark_obs": final["n_landmark_obs"],
        "tiles": np.asarray(tiles, np.int64).reshape(-1, 2),
    }


def worker(pid: int, nprocs: int, port: int, data_dir: str) -> int:
    """One rank: the JAX distributed session on every drive."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    from gen_torch_pipeline_golden import jax_slam_config
    from veloslam_tpu.parallel import dist
    from veloslam_tpu.parallel.session import DistributedSlamSession

    dist.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                          num_processes=nprocs, process_id=pid)
    assert dist.process_count() == nprocs
    with open(os.path.join(data_dir, "run.json")) as f:
        run = json.load(f)
    cfg, paths = run["config"], run["paths"]
    out = {}
    for drive in cfg["drives"]:
        name = drive["name"]
        sess = DistributedSlamSession(jax_slam_config(drive["slam"]))
        stream = sess.run_offline(paths[name]["pcap"], paths[name]["ins"])
        final = sess.finalize()
        for k, v in record(sess, stream, final).items():
            out[f"{name}_p{pid}_{k}"] = v
        print(f"[rank {pid}] {name}: {len(final['times_us'])} frames, "
              f"{final['n_keyframes']} keyframes, closures "
              f"{sess.closures}, {final['n_landmarks']} landmarks, "
              f"registered {final['registered_fraction']:.3f}", flush=True)
    np.savez(os.path.join(data_dir, f"rank{pid}.npz"), **out)
    return 0


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from gen_torch_pipeline_golden import jax_slam_config
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for drive in cfg["drives"]:
            paths[drive["name"]], _ = write_drive(drive, cfg["model"], d)
        with open(os.path.join(d, "run.json"), "w") as f:
            json.dump({"config": cfg, "paths": paths}, f)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.pop("XLA_FLAGS", None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(pid), str(N_PROCS), str(port), d], env=env)
            for pid in range(N_PROCS)]
        for p in procs:
            if p.wait(timeout=3600) != 0:
                raise SystemExit(f"worker exited {p.returncode}")
        for pid in range(N_PROCS):
            out.update(np.load(os.path.join(d, f"rank{pid}.npz")))
        for drive in cfg["drives"]:
            name = drive["name"]
            pipe = SlamPipeline(jax_slam_config(drive["slam"]))
            stream = pipe.run_offline(paths[name]["pcap"],
                                      paths[name]["ins"])
            final = pipe.finalize()
            for k, v in record(pipe, stream, final).items():
                out[f"{name}_oracle_{k}"] = v
            d_max = float(np.max(np.linalg.norm(
                out[f"{name}_p0_stream_positions"]
                - stream["positions"], axis=1)))
            print(f"oracle {name}: {len(final['times_us'])} frames, "
                  f"{final['n_keyframes']} keyframes, closures "
                  f"{pipe.closures}; rank 0's stream {d_max:.4f} m from "
                  f"it", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]),
                        int(sys.argv[4]), sys.argv[5]))
    main()
