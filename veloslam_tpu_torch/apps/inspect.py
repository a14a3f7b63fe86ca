"""CLI: inspect a recorded session — frames, beams, timing, debug dumps.

Port of veloslam_tpu/apps/inspect.py, a headless tool over a pipeline
checkpoint directory or a pcap: fetch every frame of a checkpoint's
FrameStore and time it, counting failures; per-beam point counts; and for
one frame a BEV image, a PCD cloud or an xyz text dump (utils.dumps).
With `--pcap` the frames are decoded, motion-compensated and assembled
by SlamPipeline.process_packets on `--device` (default cuda; cpu runs the
plain versions), whole packet batches only.

Usage:
  python -m veloslam_tpu_torch.apps.inspect --checkpoint /path/to/ckpt
  python -m veloslam_tpu_torch.apps.inspect --pcap drive.pcap --frame 3 \\
      --bev out
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def checkpoint_frames(dirname: str) -> list:
    """Every frame of a checkpoint's FrameStore as (start µs, frame
    dict), fetched and timed one by one; prints the span and the fetch
    times with the failures (frames that could not be fetched)."""
    from veloslam_tpu_torch.runtime.framestore import FrameStore

    fs = FrameStore(capacity=16)
    fs.load_meta(os.path.join(dirname, "frames_meta.npz"),
                 spill_dir=os.path.join(dirname, "frames"))
    times, _ = fs.all_frame_meta()
    print(f"{len(times)} frames indexed; "
          f"span {(times[-1] - times[0]) / 1e6:.2f} s"
          if len(times) else "empty store")
    frames, fetch_ms, n_fail = [], [], 0
    for t in times:
        t0 = time.perf_counter()
        f = fs.get_frame_at(int(t))
        dt = (time.perf_counter() - t0) * 1e3
        if f is None:
            n_fail += 1
            continue
        fetch_ms.append(dt)
        frames.append((int(t), f))
    if fetch_ms:
        print(f"fetch: mean {np.mean(fetch_ms):.2f} ms  "
              f"max {np.max(fetch_ms):.2f} ms  failures {n_fail}")
    return frames


def pcap_frames(pcap: str, ins, model: str, device) -> list:
    """The frames SlamPipeline.process_packets assembles from a pcap's
    whole packet batches, as (start µs, frame dict), without
    registering them."""
    from veloslam_tpu_torch.config import SensorConfig, SlamConfig
    from veloslam_tpu_torch.io.pcap import read_lidar_packets
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    pipe = SlamPipeline(SlamConfig(sensor=SensorConfig(model=model)),
                        device=device)
    if ins:
        pipe.feed_ins_txt(ins)
    pkts, times_us, _ = read_lidar_packets(pcap)
    B = pipe.cfg.pipeline.packets_per_batch
    collected = []

    def capture(frame, start_us, source=None):
        collected.append((start_us, frame))
    pipe._handle_frame = capture
    for s in range(0, (len(pkts) // B) * B, B):
        pipe.process_packets(pkts[s:s + B], times_us[s:s + B])
    print(f"decoded {len(collected)} frames from {len(pkts)} packets")
    return collected


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint", help="pipeline checkpoint directory")
    ap.add_argument("--pcap", help="or: decode this pcap directly")
    ap.add_argument("--ins", help="INS log for motion compensation")
    ap.add_argument("--model", default="hdl32")
    ap.add_argument("--frame", type=int, help="inspect one frame index")
    ap.add_argument("--beams", action="store_true",
                    help="print per-beam point counts")
    ap.add_argument("--bev", metavar="PATH", help="dump BEV image")
    ap.add_argument("--pcd", metavar="PATH", help="dump PCD cloud")
    ap.add_argument("--txt", metavar="PATH", help="dump xyz text")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where --pcap decodes (cpu: the plain versions)")
    args = ap.parse_args(argv)

    from veloslam_tpu_torch.utils import dumps

    if args.checkpoint:
        frames = checkpoint_frames(args.checkpoint)
    elif args.pcap:
        frames = pcap_frames(args.pcap, args.ins, args.model, args.device)
    else:
        ap.error("need --checkpoint or --pcap")

    if not frames:
        return 0
    sel = frames if args.frame is None else [frames[args.frame]]
    for idx, (t, f) in enumerate(sel):
        n = int(f["mask"].sum())
        which = idx if args.frame is None else args.frame
        print(f"frame {which} @ {t} us: {n} points")
        if args.beams:
            for b, c in enumerate(f["mask"].sum(axis=1)):
                print(f"  beam {b:2d}: {int(c):5d} points")
    if args.frame is not None:
        t, f = frames[args.frame]
        if args.bev:
            print("bev ->", dumps.dump_bev(f, args.bev))
        if args.pcd:
            print(f"pcd -> {args.pcd} ({dumps.dump_pcd(f, args.pcd)} pts)")
        if args.txt:
            print(f"txt -> {args.txt} ({dumps.dump_txt(f, args.txt)} pts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
