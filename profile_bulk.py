"""Launches and times of the PyTorch port's Gauss-Newton loop on one CUDA
card: the fused step (`normal_equations.gn_iteration`, one kernel call of
two launches) against the loop it replaced (the normal-equations kernel,
then the damped solve, clamp and retraction as torch ops, `_gn_step`).

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_bulk.py

For each loop, in the order plain, fused, fused, plain, it prints the
kernel launches of one GN iteration at the bulk path's shape (96 slots ×
16384 points), the launches and ms of one full-width bulk odometry step
from a warm map (chip_smoke.py phase 5's inputs; median of 5, CUDA
events), and the launches and ms of closure verification on chip_smoke.py
phase 6's drive (`devfinalize.verify_closures_device`: 46 GN iterations
of 128 candidates; median of 3, synchronized).  Launches are the
runtime's kernel-launch calls that torch.profiler records.  Then it
times the int32 gather kernel on the paths' own index streams
(`time_path_gathers`).  It checks nothing else: chip_smoke.py holds both
loops' paths to their goldens.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def _launch_calls(fn) -> int:
    """Kernel-launch calls (cudaLaunchKernel and kin) in one `fn()`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "LaunchKernel" in e.key)


def _wall_ms(fn, runs: int = 3) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def plain_loop(pts, pose, mu, n, hit, *, damping, huber_delta, max_dist):
    """The GN iteration before the fused step: the normal-equations
    kernel, then `_gn_step` as torch ops."""
    from veloslam_tpu_torch.registration import normal_equations as ne
    H, b, err_sum, w_sum, n_hit = ne.fused_normal_equations(
        pts, pose.q, pose.t, mu, n, hit, huber_delta=huber_delta,
        max_dist=max_dist)
    return ne.GnIteration(ne._gn_step(pose, H, b, n_hit, damping), H, b,
                          err_sum / torch.clamp(w_sum, min=1.0), n_hit, None)


def bulk_step(device):
    """A full-width bulk odometry step from a warm map, as a closure."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.runtime import odometry as odo
    reg = json.loads(str(np.load(cs.GOLDEN)["config"]))["odometry"]
    pkts, rel_s, track_rel, track_q, track_t, track_v = cs._bulk_inputs(
        device)
    calib = DeviceCalib.from_host(calibration.hdl32(), device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    kw = dict(model="hdl32", reg_points=reg["reg_points"],
              reg_iterations=reg["reg_iterations"], max_frames_batch=96,
              reassociate_every=reg["reassociate_every"],
              map_decay=reg["map_decay"])

    def step(state):
        return odo.odometry_step_batched(
            state, pkts, calib, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, **kw)

    warm, _ = step(odo.init_state(device=device,
                                  map_capacity=reg["map_capacity"],
                                  voxel_size=reg["voxel_size"]))
    return lambda: step(warm)


def verification(device):
    """Closure verification on the full-SLAM drive's keyframe ring, as a
    closure (the stream runs once to fill the ring)."""
    from veloslam_tpu_torch.runtime import devfinalize as dv
    from veloslam_tpu_torch.runtime.pipeline import sweep_budget
    gold = np.load(cs.FULLSLAM_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["full"]
    seq, track, engine = cs._fullslam_drive(device, drive, cfg["model"])
    eng = engine()
    eng.run_device(seq["packets"], seq["pkt_times_us"], track,
                   batch=drive["batch"])
    fin = drive["finalize"]
    r = eng.ring
    K = r.capacity
    cand = dv.propose_closures(
        r.desc[:K], r.q[:K], r.t[:K], r.n, min_score=fin["min_score"],
        radius=fin["radius"], min_gap=fin["min_gap"],
        max_candidates=sweep_budget(eng, cfg["budget_floor"]),
        use_scan_context=fin["use_scan_context"])
    return lambda: dv.verify_closures_device(
        r.pts[:K], r.msk[:K], cand, voxel_size=fin["voxel_size"],
        capacity=fin["capacity"],
        reassociate_every=dv.VERIFY_REASSOCIATE_EVERY)


def time_path_gathers(step, verify) -> None:
    """gather_i32 on the paths' own index streams: lookup_dilated's in
    the first association block of a bulk step, and the key checks of
    verification's first coarse and first fine blocks (3 coarse blocks
    come first).  Each is checked bitwise against the plain version and
    timed beside index_select and its bound (chip_smoke._time_gather)."""
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import voxel as vx
    seen, gather_i32 = [], vx.gather_i32

    def recording(table, idx):
        seen.append((table, idx))
        return gather_i32(table, idx)

    vx.gather_i32 = recording
    try:
        step()
        n_bulk = len(seen)
        verify()
    finally:
        vx.gather_i32 = gather_i32
    streams = {"the bulk step": seen[0],
               "verification (coarse)": seen[n_bulk],
               "verification (fine)": seen[n_bulk + 3]}
    for name, (table, idx) in streams.items():
        if not torch.equal(ga.gather_i32(table, idx),
                           ga.gather_i32_plain(table, idx)):
            raise AssertionError(f"gather_i32 on {name}: not bitwise equal")
        print(f"[profile_bulk] gather_i32 on {name}'s indices (table "
              f"{table.numel()}, M {idx.numel()}, "
              f"{torch.unique(idx).numel()} distinct): bitwise equal; "
              f"{cs._time_gather('gather_i32', table, idx)['line']}",
              flush=True)


def main() -> int:
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import normal_equations as ne

    smi = cs.phase_device()
    cs.phase_build()
    device = torch.device("cuda", 0)

    # One GN iteration's inputs at the bulk shape.
    pts, q, t, mu, n, hit = cs._ne_inputs(96, 16384, seed=1, device=device,
                                          hit_rate=0.56)
    pose = se3.Pose(q, t)
    kw = dict(damping=1e-6, huber_delta=0.5, max_dist=2.0)
    step = bulk_step(device)
    verify = verification(device)

    loops = {"plain": plain_loop, "fused": ne.gn_iteration}
    for name in ("plain", "fused", "fused", "plain"):
        loop = loops[name]
        gicp.gn_iteration = loop
        per_iter = _launch_calls(lambda: loop(pts, pose, mu, n, hit, **kw))
        per_batch = _launch_calls(step)
        batch_ms = cs._events_ms(step, 5)
        v_launches = _launch_calls(verify)
        v_ms = _wall_ms(verify)
        print(f"[profile_bulk] {name}: {per_iter} launches per GN iteration "
              f"(96 x 16384); bulk step {per_batch} launches, "
              f"{batch_ms:.3f} ms per batch (median of 5, CUDA events); "
              f"verification {v_launches} launches, {v_ms:.1f} ms (median "
              f"of 3, synchronized); {smi}", flush=True)
    gicp.gn_iteration = ne.gn_iteration
    time_path_gathers(step, verify)
    return 0


if __name__ == "__main__":
    sys.exit(main())
