"""CLI: replay recorded or simulated sensor data over UDP, and measure
live mode over loopback.

Port of veloslam_tpu/apps/replay.py: stream a pcap's LiDAR packets to the
data port at a fixed average pace, and/or an INS text log as InsPVA
structs at 100 Hz (ENU re-encoded as LLH against an origin), both on one
absolute clock (io.udp.paced).
`measure_live_loopback` replays a drive to SlamPipeline.run_online on
this machine and reports sustained pkt/s, the senders' achieved rates,
receiver drops, frames and the per-batch feed time; the pipeline runs on
`device` (cuda unless the caller asks for cpu).

Usage:
  python -m veloslam_tpu_torch.apps.replay --pcap drive.pcap [--loop]
  python -m veloslam_tpu_torch.apps.replay --ins drive_ins.txt \\
      --origin 31 121.5 0
"""

from __future__ import annotations

import argparse
import socket
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.io import udp


# measure_live_loopback's senders start this long after run_online is
# ready.
SENDER_LEAD_S = 0.5
# measure_live_loopback's session ends this long after its last packet.
IDLE_TIMEOUT_S = 1.5


def replay_ins_txt(path: str, dest_ip: str, port: int,
                   origin_llh_deg, rate_hz: float = 100.0, t0=None,
                   stats=None) -> int:
    """Re-encode an INS text log as InsPVA UDP packets, 1 / rate_hz s
    apart on average (udp.paced's absolute clock from `t0`, which a
    caller shares with a LiDAR replay to keep the two streams in step):
    ENU → LLH against the origin, GPS week and milliseconds from the
    log's Unix times.  `stats` as udp.paced's.  Returns the count sent."""
    from veloslam_tpu_torch.core import geodesy, timesync
    from veloslam_tpu_torch.io import packets as pk

    ins = pk.read_ins_txt(path)
    origin = np.array([np.deg2rad(origin_llh_deg[0]),
                       np.deg2rad(origin_llh_deg[1]), origin_llh_deg[2]])
    org_xyz = geodesy.llh2xyz_np(origin)
    payloads = []
    for i in range(len(ins["t_us"])):
        enu = np.array([ins["pos_xy"][i, 0], ins["pos_xy"][i, 1], 0.0])
        llh = geodesy.enu2llh_np(enu, org_xyz)
        t_us = int(ins["t_us"][i])
        gps_us = t_us - timesync.GPS_EPOCH_UNIX_US
        week = gps_us // timesync.WEEK_US
        ms = (gps_us % timesync.WEEK_US) // 1000
        payloads.append(pk.pack_inspva(
            int(week), int(ms), int(week),
            (gps_us % timesync.WEEK_US) / 1e6,
            (np.rad2deg(llh[0]), np.rad2deg(llh[1]), llh[2]),
            tuple(ins["speed"][i] * np.array(
                [np.cos(np.deg2rad(ins["yaw_deg"][i])),
                 np.sin(np.deg2rad(ins["yaw_deg"][i])), 0.0])),
            (ins["roll_deg"][i], ins["pitch_deg"][i], ins["yaw_deg"][i])))

    def send(i, j):
        for payload in payloads[i:j]:
            udp.send_struct(payload, dest_ip, port)
    udp.paced(len(payloads), 1.0 / rate_hz, send, t0, stats)
    return len(payloads)


def free_udp_port() -> int:
    """A UDP port the kernel reports free on 127.0.0.1 (bound to 0 and
    released)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def warm_live(cfg, device, fast: bool) -> None:
    """Run one packet batch of the live size through a throwaway pipeline
    (the FullSlam stream with `fast`, else process_packets) on a short
    simulated drive, so the kernel builds, the card's context and the
    allocator's first growth stay out of a measured stream."""
    import torch

    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    seq = sim.generate_sequence(duration_s=0.5, model=cfg.sensor.model,
                                seed=11, world=sim.World.demo(2))
    scratch = SlamPipeline(cfg, device=device)
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        scratch.feed_ins_pose(
            int(t_us), se3.euler_deg_to_quat_np(0.0, 0.0,
                                                float(np.rad2deg(yaw))),
            np.asarray(p, float), v)
    B = cfg.pipeline.packets_per_batch
    pkts, times = seq["packets"][:B], seq["pkt_times_us"][:B]
    if fast:
        eng = scratch._live_engine(None)
        eng.feed(pkts, times, scratch.track.window(
            int(times[0]), int(times[-1]), anchor_us=int(times[0])))
    else:
        scratch.process_packets(pkts, times)
    if scratch.device.type == "cuda":
        torch.cuda.synchronize(scratch.device)


def measure_live_loopback(duration_s: float = 5.0, rate: float = 1.0,
                          fast: bool = True, warm: bool = True,
                          origin=(31.0, 121.5, 0.0), device="cuda",
                          pcap: Optional[str] = None,
                          ins: Optional[str] = None, config=None) -> dict:
    """Measure live ingest on this machine: loopback-replay a drive at
    `rate`× the sensor's packet rate (the HDL-32 sends ≈1808 pkt/s), its
    INS log interleaved as InsPVA at 100 Hz × rate, through run_online.
    Both senders pace from one clock origin (udp.paced), so an INS
    datagram leaves with the LiDAR packets of its time; each sender's
    worst lateness behind that common schedule bounds how far it fell
    behind the other.  Reports packets sent, received, lost and dropped,
    sustained pkt/s (the gaps between the packets received over the LiDAR
    sender's measured window, from its clock origin to its last send),
    the INS sender's achieved Hz, both senders' worst lateness, frames,
    the per-batch feed time, the lag from the last packet sent to the
    session's end (idle timeout excluded; with `fast`, the stream's
    device finalize included) and the trajectory (times_us, positions).
    The drive is `pcap` + `ins` when given, else a simulated `duration_s`
    s HDL-32 drive (seed 17, World.demo(6)); the config is `config`, else
    SlamConfig without landmarks.  `fast` uses the device-resident
    FullSlam stream."""
    from veloslam_tpu_torch.config import GraphConfig, SlamConfig
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.io.pcap import read_lidar_packets
    from veloslam_tpu_torch.runtime.odometry import packets_per_second
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    cfg = config or SlamConfig(graph=GraphConfig(use_landmarks=False))
    if warm:
        warm_live(cfg, device, fast)
    with tempfile.TemporaryDirectory() as tmp:
        if pcap is None:
            seq = sim.generate_sequence(duration_s=duration_s, model="hdl32",
                                        seed=17, world=sim.World.demo(6))
            paths = sim.write_sequence(seq, tmp, name="live")
            pcap, ins = paths["pcap"], paths["ins"]
        pkts, _, _ = read_lidar_packets(pcap)
        lidar_port, ins_port, pos_port = (free_udp_port() for _ in range(3))
        pace_us = 1e6 / packets_per_second(cfg.sensor.model) / rate
        sent = {"lidar": {}, "ins": {}}
        threads = []

        def start_senders():
            # A lead for both threads to start and the INS payloads to be
            # encoded before the first item is due.
            t0 = time.monotonic() + SENDER_LEAD_S

            def send_lidar():
                sent["lidar"]["n"] = udp.replay_packets(
                    pkts, "127.0.0.1", lidar_port, pace_us, t0=t0,
                    stats=sent["lidar"])
                sent["lidar"]["done"] = time.monotonic()

            def send_ins():
                sent["ins"]["n"] = replay_ins_txt(
                    ins, "127.0.0.1", ins_port, origin,
                    rate_hz=100.0 * rate, t0=t0, stats=sent["ins"])
            for fn in (send_lidar, send_ins):
                t = threading.Thread(target=fn, daemon=True)
                t.start()
                threads.append(t)

        pipe = SlamPipeline(cfg, device=device)
        t0 = time.time()
        res = pipe.run_online(lidar_port=lidar_port, ins_port=ins_port,
                              position_port=pos_port, origin_llh_deg=origin,
                              duration_s=len(pkts) * pace_us * 1e-6 + 30.0,
                              idle_timeout_s=IDLE_TIMEOUT_S,
                              on_ready=start_senders, fast=fast)
        end = time.monotonic()
        wall = time.time() - t0
        for t in threads:
            t.join(timeout=5.0)
    st = res["live_stats"]
    rx = st["lidar_packets"]
    lidar, ins_sent = sent["lidar"], sent["ins"]
    n_lidar, n_ins = lidar.get("n", 0), ins_sent.get("n", 0)
    nan = float("nan")
    return {
        "rate_x_sensor": rate,
        "pace_us_per_packet": round(pace_us, 3),
        "sent_lidar": n_lidar,
        "received_lidar": rx,
        "receiver_dropped": int(st.get("lidar_dropped", 0)),
        "lost": n_lidar - rx,
        "lidar_send_s": round(lidar.get("send_s", nan), 3),
        "sustained_pkt_per_s": round((rx - 1) / lidar.get("send_s", nan),
                                     1),
        "lidar_max_late_ms": round(lidar.get("max_late_ms", nan), 3),
        "sent_ins": n_ins,
        "received_ins": st["ins_datagrams"],
        "ins_hz": round((n_ins - 1) / ins_sent.get("send_s", nan), 2),
        "ins_max_late_ms": round(ins_sent.get("max_late_ms", nan), 3),
        "n_frames": res["n_frames"],
        "n_keyframes": res["n_keyframes"],
        "batch_feed_ms_mean": st["batch_feed_ms_mean"],
        "batch_feed_ms_max": round(st["batch_feed_ms_max"], 3),
        "batch_period_ms": round(
            cfg.pipeline.packets_per_batch * pace_us * 1e-3, 1),
        # From the last LiDAR packet sent to the session's end, the idle
        # timeout left out: how far the pipeline trailed the sensor (fast:
        # the end-of-stream device finalize included).
        "lag_s": round(end - lidar.get("done", nan) - IDLE_TIMEOUT_S, 3),
        "wall_s": round(wall, 2),
        "mode": "fast" if fast else "per-frame",
        "times_us": res["times_us"],
        "positions": res["positions"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--pcap", help="pcap to replay to the LiDAR port")
    ap.add_argument("--ins", help="INS text log to replay as InsPVA")
    ap.add_argument("--dest", default="127.0.0.1")
    ap.add_argument("--lidar-port", type=int, default=C.LIDAR_DATA_PORT)
    ap.add_argument("--ins-port", type=int, default=C.INS_PORT)
    ap.add_argument("--pace-us", type=float, default=200,
                    help="µs between LiDAR packets, on average")
    ap.add_argument("--ins-rate", type=float, default=100.0)
    ap.add_argument("--origin", type=float, nargs=3,
                    default=(31.0, 121.5, 0.0),
                    metavar=("LAT", "LON", "H"),
                    help="ENU origin for INS LLH re-encode (deg, deg, m)")
    ap.add_argument("--loop", action="store_true",
                    help="repeat the pcap forever")
    args = ap.parse_args(argv)
    if not args.pcap and not args.ins:
        ap.error("need --pcap and/or --ins")

    pkts = None
    if args.pcap:
        from veloslam_tpu_torch.io.pcap import read_lidar_packets
        pkts, _, _ = read_lidar_packets(args.pcap)
    threads = []
    t0 = time.monotonic()               # both streams from one clock origin
    if args.ins:
        t = threading.Thread(target=replay_ins_txt, args=(
            args.ins, args.dest, args.ins_port, tuple(args.origin),
            args.ins_rate, t0), daemon=True)
        t.start()
        threads.append(t)
    if pkts is not None:
        print(f"replaying {len(pkts)} packets to "
              f"{args.dest}:{args.lidar_port} at {args.pace_us} µs/pkt")
        while True:
            sent = udp.replay_packets(pkts, args.dest, args.lidar_port,
                                      args.pace_us, t0=t0)
            print(f"sent {sent}")
            if not args.loop:
                break
            t0 = None
    for t in threads:
        t.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
