"""CLI: run the SLAM pipeline over a pcap + INS log (or a simulated drive)
on a CUDA card.

Port of veloslam_tpu/apps/slam_run.py: decodes a sequence, runs
odometry, keyframes, loop closure, landmarks, the graph solve and the
tiled map, writes `trajectory.txt` and `metrics.json`, and evaluates ATE /
RPE against ground truth when it has one.  Three modes:

  (default)  the per-frame pipeline (SlamPipeline.run_offline): each
             frame localized against the map ROI, integrated, keyframes
             and periodic loop-closure sweeps with a graph solve and an
             incremental map downdate;
  --batched  full SLAM at bulk-replay rate (SlamPipeline.
             run_offline_batched + finalize);
  --fast     bulk odometry only (StreamingOdometry on the device).

`--checkpoint-dir` saves a resumable checkpoint (frame meta, INS track,
map, graph) after the run.  `--trace-dir` records the run (and the
finalize of `--batched`) with torch.profiler into DIR/trace.json, a
Chrome trace in which the pipeline's stages (`veloslam.<stage>`) and the
card's kernels share one timeline.  The printed timing table gives each
stage's seconds (`total`) and its own seconds less its nested stages'
(`self`).  `--bev` writes the interactive BEV artifact
(utils.viewer: trajectory, keyframes, closures, landmark posts, map
occupancy, and the ground truth when there is one; one self-contained
HTML file).  Everything runs on `--device` (default cuda); `--device
cpu` runs the kernels' plain versions.

Usage:
  python -m veloslam_tpu_torch.apps.slam_run --pcap drive.pcap \\
      --ins drive_ins.txt
  python -m veloslam_tpu_torch.apps.slam_run --simulate 7 --out-dir out
  python -m veloslam_tpu_torch.apps.slam_run --batched --simulate 7 \\
      --out-dir out
  python -m veloslam_tpu_torch.apps.slam_run --simulate 7 --trace-dir tr
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _laser_mask(spec: str):
    ids = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            ids.extend(range(int(a), int(b) + 1))
        else:
            ids.append(int(part))
    return tuple(sorted(set(ids)))


def _run(args, pipe, pcap_path: str, ins_path) -> dict:
    """The run of the mode that `args` selects; its results."""
    if args.fast:
        from veloslam_tpu_torch.io.pcap import read_lidar_packets
        from veloslam_tpu_torch.runtime.odometry import (StreamingOdometry,
                                                         slots_for_batch)
        if ins_path:
            pipe.feed_ins_txt(ins_path)
        pkts, times, _ = read_lidar_packets(pcap_path, args.max_packets)
        slots = slots_for_batch(args.model, args.batch)
        # The JAX app's engine: the batched step with frame sampling and
        # the exact binary-search lookup (use_dense left off).
        odo = StreamingOdometry(pipe.dcalib, model=args.model,
                                n_beams=pipe.calib.n_lasers, batched=True)
        t0 = time.perf_counter()
        res = odo.run(pkts, times, pipe.track, batch=args.batch)
        wall = time.perf_counter() - t0
        res.update(registered_fraction=1.0, n_keyframes=0, n_closures=0,
                   map_patches=0,
                   timing={"wall_s": round(wall, 3),
                           "frames_per_s": round(res["n_frames"] / wall, 1)
                           if wall > 0 else None})
        print(f"fast path: {res['n_frames']} frames in {wall:.2f}s "
              f"({res['n_frames']/max(wall,1e-9):,.0f} frames/s, "
              f"batch={args.batch}, slots={slots})")
    elif args.batched:
        t0 = time.perf_counter()
        pipe.run_offline_batched(pcap_path, ins_path,
                                 max_packets=args.max_packets,
                                 batch=args.batch)
        res = pipe.finalize()
        wall = time.perf_counter() - t0
        res["timing"] = dict(res["timing"], wall_s=round(wall, 3),
                             frames_per_s=round(
                                 res["n_frames"] / max(wall, 1e-9), 1))
        print(f"batched full SLAM: {res['n_frames']} frames, "
              f"{res['n_keyframes']} keyframes, {res['n_closures']} "
              f"closures, {res['n_landmarks']} landmarks in {wall:.2f}s "
              f"({res['n_frames']/max(wall,1e-9):,.0f} frames/s)")
    else:
        res = pipe.run_offline(pcap_path, ins_path,
                               max_packets=args.max_packets)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--pcap", help="input pcap file")
    ap.add_argument("--ins", help="INS text log (reference format)")
    ap.add_argument("--model", default="hdl32",
                    choices=["hdl32", "vlp16", "hdl64"])
    ap.add_argument("--calibration", help="Velodyne XML calibration file")
    ap.add_argument("--lasers", metavar="SPEC",
                    help="laser selection: comma list of wire laser ids "
                         "and ranges, e.g. '0,2,4-15' (default: all)")
    ap.add_argument("--out-dir", default="slam_out")
    ap.add_argument("--max-packets", type=int)
    ap.add_argument("--simulate", type=float, metavar="SECONDS",
                    help="generate a synthetic drive instead of reading "
                         "files; also enables ATE evaluation")
    ap.add_argument("--ins-drift", type=float, default=0.0,
                    help="with --simulate: inject linear INS drift (m/s)")
    ap.add_argument("--checkpoint-dir", help="save a resumable checkpoint")
    ap.add_argument("--trace-dir", metavar="DIR",
                    help="record the run with torch.profiler into "
                         "DIR/trace.json (Chrome trace: the stages as "
                         "veloslam.<stage> beside the card's kernels)")
    ap.add_argument("--gt", help="ground-truth trajectory txt "
                                 "(t_us x y z per row) for ATE")
    ap.add_argument("--bev", nargs="?", const="bev.html", metavar="FILE",
                    help="write an interactive BEV trajectory artifact "
                         "(self-contained HTML; default bev.html in "
                         "--out-dir)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the pipeline runs (cpu: the kernels' "
                         "plain versions)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fast", action="store_true",
                      help="bulk odometry only: every frame of a packet "
                           "batch registers in one device step (no "
                           "keyframes, loop closure or map)")
    mode.add_argument("--batched", action="store_true",
                      help="full SLAM at bulk-replay rate: device keyframe "
                           "ring and scan-context descriptors in the "
                           "odometry step, then loop closure, landmarks, "
                           "graph solve and map rebuild at finalize")
    ap.add_argument("--batch", type=int, default=8192,
                    help="packets per device step (--fast / --batched)")
    args = ap.parse_args(argv)

    from veloslam_tpu_torch.config import SensorConfig, SlamConfig
    from veloslam_tpu_torch.runtime.evaluate import (ate,
                                                     interpolate_positions,
                                                     rpe)
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    from veloslam_tpu_torch.utils.profiling import device_trace

    os.makedirs(args.out_dir, exist_ok=True)
    cfg = SlamConfig(sensor=SensorConfig(
        model=args.model, calibration_path=args.calibration,
        laser_mask=_laser_mask(args.lasers) if args.lasers else None))
    pipe = SlamPipeline(cfg, spill_dir=os.path.join(args.out_dir, "spill"),
                        device=args.device)

    gt = None
    if args.simulate:
        from veloslam_tpu_torch.io import packets as pkmod
        from veloslam_tpu_torch.io import simulate as sim
        print(f"simulating {args.simulate}s {args.model} drive ...")
        seq = sim.generate_sequence(duration_s=args.simulate,
                                    model=args.model)
        paths = sim.write_sequence(seq, args.out_dir, name="sim")
        gt = {"t_us": seq["ins_t_us"], "pos": seq["ins_pos"]}
        if args.ins_drift > 0:
            # corrupt the INS log with a linear drift for SLAM to correct
            ins = pkmod.read_ins_txt(paths["ins"])
            ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
            drift = np.stack([args.ins_drift * ts,
                              0.5 * args.ins_drift * ts], -1)
            pkmod.write_ins_txt(paths["ins"], ins["t_us"],
                                ins["pos_xy"] + drift,
                                np.deg2rad(ins["yaw_deg"]),
                                speed=ins["speed"])
        pcap_path, ins_path = paths["pcap"], paths["ins"]
    else:
        if not args.pcap:
            ap.error("--pcap required (or use --simulate)")
        pcap_path, ins_path = args.pcap, args.ins

    with device_trace(args.trace_dir):
        res = _run(args, pipe, pcap_path, ins_path)

    traj_path = os.path.join(args.out_dir, "trajectory.txt")
    with open(traj_path, "w") as f:
        for t, p, q in zip(res["times_us"], res["positions"],
                           res["quaternions"]):
            f.write(f"{t} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    metrics = {k: v for k, v in res.items()
               if k in ("registered_fraction", "n_frames", "n_keyframes",
                        "n_closures", "map_patches", "timing")}

    if args.gt:
        raw = np.loadtxt(args.gt, ndmin=2)
        gt = {"t_us": raw[:, 0].astype(np.int64), "pos": raw[:, 1:4]}
    if gt is not None and res["n_frames"] > 2:
        ref = interpolate_positions(res["times_us"], gt["t_us"], gt["pos"])
        # planar metrics: the INS text format carries no z, so the
        # estimate's z datum is arbitrary
        metrics["ate"] = ate(res["positions"][:, :2], ref[:, :2],
                             align=False)
        metrics["rpe"] = rpe(res["positions"][:, :2], ref[:, :2])

    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2, default=str)

    if args.checkpoint_dir:
        pipe.save_checkpoint(args.checkpoint_dir)

    if args.bev:
        from veloslam_tpu_torch.utils.viewer import write_bev_html
        occ_xy, posts_xy = pipe.map.bev_layers()
        ins_xy = (np.asarray(gt["pos"])[:, :2] if gt is not None else None)
        bev_path = (args.bev if os.path.isabs(args.bev)
                    else os.path.join(args.out_dir, args.bev))
        write_bev_html(bev_path, res, ins_xy=ins_xy,
                       landmarks_xy=posts_xy, occupancy_xy=occ_xy,
                       closures=pipe.closures,
                       title=f"veloslam_tpu — {os.path.basename(pcap_path)}")
        print(f"BEV artifact: {bev_path}")

    print(f"frames: {res['n_frames']}  keyframes: {res['n_keyframes']}  "
          f"closures: {res['n_closures']}  "
          f"registered: {res['registered_fraction']:.0%}")
    if "ate" in metrics:
        print(f"ATE rmse: {metrics['ate']['rmse']:.3f} m  "
              f"median: {metrics['ate']['median']:.3f} m")
    print(pipe.timers.report())
    print(f"outputs in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
