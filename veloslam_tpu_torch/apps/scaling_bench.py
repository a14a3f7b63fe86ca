"""Scaling harness: the map-sharded SLAM kernels and the distributed
session on N ranks.

Port of veloslam_tpu/apps/scaling_bench.py on torch.distributed.  It
spawns `--nprocs N` rank processes (the "spawn" start method, one
process group over localhost) and

  * by default partitions a registration target by tile hash
    (dist.partition_plane_grid_rows), each rank's rows its map shard, and
    times sharded.register_sharded of a replicated scan against it, then
    halo.register_halo_sharded with the scan routed by key range;
  * with `--session`, drives the whole DistributedSlamSession over a
    short simulated drive and times ms per frame.

Rank 0's numbers are printed as one JSON line.  Times come from CUDA
events on a card (host clock on the CPU, where they are CPU numbers).
NCCL (the default) runs one rank per card; `--backend gloo` lets N ranks
share one card (or run on the CPU with `--device cpu`), and then the
numbers are not scaling numbers: the line says so.  The JAX harness's
`--virtual N` (N virtual XLA devices in one process) has no
counterpart: a rank here is a process.

Usage:
  python -m veloslam_tpu_torch.apps.scaling_bench --nprocs 1
  python -m veloslam_tpu_torch.apps.scaling_bench --nprocs 2 \\
      --backend gloo
  python -m veloslam_tpu_torch.apps.scaling_bench --nprocs 2 \\
      --backend gloo --device cpu --session
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _timed_ms(fn, device, iters: int = 10) -> float:
    """ms per call of fn() after one warm call: CUDA events on a card,
    the host clock on the CPU."""
    import torch
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _bench_rank(device, opts: dict) -> dict:
    """One rank of the registration bench: this rank's tile-hashed rows
    of a shared target, the replicated scan, the timed registrations."""
    import torch

    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.parallel import dist, halo, sharded
    from veloslam_tpu_torch.parallel.mesh import block
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import voxel as vx

    rng = np.random.default_rng(0)
    P = opts["points"]
    pts = rng.uniform(-60, 60, (P, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 0.1
    mask = np.ones(P, bool)
    one = gicp.build_plane_grid(
        torch.as_tensor(pts, device=device)[None],
        torch.as_tensor(mask, device=device)[None],
        torch.zeros(3, device=device), 1.0, capacity=opts["capacity"])
    full = gicp.PlaneGrid(grid=vx.VoxelGrid(*(x[0] for x in one.grid)),
                          normal=one.normal[0], usable=one.usable[0],
                          rows=one.rows[0])
    n = dist.process_count()
    rows, origin, vs = dist.partition_plane_grid_rows(
        full, dist.process_index(), n)
    mesh = dist.global_mesh(device, data_axis=1)
    target = dist.assemble_global_plane_grid(mesh, rows, origin, vs)
    p_dev = torch.as_tensor(pts, device=device)
    m_dev = torch.as_tensor(mask, device=device)
    ident = se3.Pose.identity(device=device)

    def run():
        return sharded.register_sharded(mesh, p_dev, m_dev, target, ident,
                                        iterations=opts["iters"])
    before = dict(dist.COLLECTIVES)
    res = run()
    per_call = {k: dist.COLLECTIVES[k] - before[k] for k in before}
    ms = _timed_ms(run, device)

    # The halo variant: the scan routed by key range, the full table's
    # contiguous row blocks extended by their neighbours' bands.
    keys = full.grid.keys.cpu().numpy()
    h = 2 * halo.required_halo(keys, n) + 16 if n > 1 else 1
    p_r, m_r = halo.partition_points_by_key_ranges(
        keys, pts, mask, np.zeros(3), 1.0, n)
    hp = block(torch.as_tensor(p_r, device=device), mesh, "map")
    hm = block(torch.as_tensor(m_r, device=device), mesh, "map")
    shard = sharded.shard_plane_grid(mesh, full)

    def run_halo():
        return halo.register_halo_sharded(mesh, hp, hm, shard, ident,
                                          iterations=opts["iters"], halo=h)
    halo_ms = _timed_ms(run_halo, device)
    return {"ms": ms, "halo_ms": halo_ms, "n_matched": int(res.n_matched),
            "collectives_per_registration": per_call}


def _session_rank(device, opts: dict) -> dict:
    """One rank of --session: the DistributedSlamSession over a simulated
    drive (the first third warms up, the rest is timed)."""
    import torch

    from veloslam_tpu_torch.config import (GraphConfig, PipelineConfig,
                                           RegistrationConfig, SlamConfig)
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.parallel import dist
    from veloslam_tpu_torch.parallel.session import DistributedSlamSession

    cfg = SlamConfig(
        pipeline=PipelineConfig(packets_per_batch=128),
        registration=RegistrationConfig(max_points=opts["points"],
                                        max_iterations=opts["iters"]),
        graph=GraphConfig(use_landmarks=False))
    seq = sim.generate_sequence(duration_s=opts["session_s"], model="hdl32",
                                seed=21, world=sim.World.demo(9))
    sess = DistributedSlamSession(cfg, device=device)
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        sess.feed_ins_pose(
            int(t_us),
            se3.euler_deg_to_quat_np(0.0, 0.0, float(np.rad2deg(yaw))),
            np.asarray(p, float), v)
    pkts, times_us = seq["packets"], seq["pkt_times_us"]
    B = cfg.pipeline.packets_per_batch
    n_b = (len(pkts) // B) * B
    split = (n_b // B // 3) * B
    for s in range(0, split, B):
        sess.process_packets(pkts[s:s + B], times_us[s:s + B])
    warm_frames = len(sess.trajectory)
    before = dict(dist.COLLECTIVES)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for s in range(split, n_b, B):
        sess.process_packets(pkts[s:s + B], times_us[s:s + B])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    res = sess.results()
    frames = res["n_frames"] - warm_frames
    reg = res["timing"].get("register", {})
    return {"frames_measured": frames,
            "ms_per_frame": wall / max(frames, 1) * 1e3,
            "register_stage_ms_mean": reg.get("mean_ms", 0.0),
            "registered_fraction": res["registered_fraction"],
            "roi_refresh_frames": sess.roi_refresh_frames,
            "collectives_per_frame": {
                k: (dist.COLLECTIVES[k] - before[k]) / max(frames, 1)
                for k in before}}


def run(nprocs: int, *, backend: str, device: str, session: bool = False,
        points: int = 32768, capacity: int = 16384, iters: int = 8,
        session_s: float = 1.5, timeout_s: float = 900.0) -> dict:
    """Spawn the ranks, run the bench (or the session), return rank 0's
    record with the run's layout."""
    import torch

    from veloslam_tpu_torch.parallel import dist
    opts = {"points": points, "capacity": capacity, "iters": iters,
            "session_s": session_s}
    fn = _session_rank if session else _bench_rank
    out = dist.spawn_ranks(fn, nprocs, backend=backend, device=device,
                           args=(opts,), timeout_s=timeout_s)[0]
    on_card = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    rec = {"metric": ("session_ms_per_frame" if session
                      else "multiprocess_register_ms"),
           "processes": nprocs, "backend": backend,
           "device": (torch.cuda.get_device_name(0) if on_card
                      else "cpu"),
           "cards": cards, **out}
    if not on_card:
        rec["note"] = "ranks on the CPU: host numbers, not scaling numbers"
    elif nprocs > cards:
        rec["note"] = (f"{nprocs} ranks share {cards} card(s): these are "
                       "not scaling numbers")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--nprocs", type=int, default=1,
                    help="rank processes to spawn (one process group)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (card r for rank r under NCCL, shared "
                         "under gloo) or cpu (gloo only)")
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--capacity", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--session", action="store_true",
                    help="time the distributed SLAM session (ms/frame) "
                         "instead of the registration")
    ap.add_argument("--session-s", type=float, default=1.5,
                    help="simulated drive length for --session")
    args = ap.parse_args(argv)
    rec = run(args.nprocs, backend=args.backend, device=args.device,
              session=args.session, points=args.points,
              capacity=args.capacity, iters=args.iters,
              session_s=args.session_s)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
