"""Device-resident streaming odometry: one step per packet batch.

Port of veloslam_tpu/runtime/odometry.py, all three paths of
`StreamingOdometry`:

  * batched (`odometry_step_batched`, the bulk path): decode → motion
    compensation → frame sampling (`sample_assembly`) or assembly and a
    per-slot subsample → scan-to-map GICP of every completed frame
    against the batch-start rolling map, through the dilated dense index
    (`use_dense`) or the exact binary-search lookup → health gates →
    trajectory scatter + correction update → one map merge with decay →
    rebase;
  * fused (`odometry_step`): decode → compensation → assembly, then per
    completed frame in order: subsample, GICP against the running map
    with the running correction (exact binary-search lookup), health
    gates, trajectory write, map merge with decay;
  * chained (`assemble_step`, then `frame_step` per frame slot): the
    fused path in two stages, as the JAX package runs it.

The state (assembly carry, rolling voxel map, correction transform,
trajectory buffers) stays on the device; the host feeds packet batches
and INS windows and reads the trajectory back once at the end.

Estimation model: the INS provides compensation and priors; registration
maintains a correction C = T_est ∘ T_ins⁻¹, so each frame's prior is
C ∘ T_ins(start) (on the batched path with the correction translation
extrapolated at its measured rate, see `_batched_core`).

Host reads: the batched step reads nothing back.  Its map rebase, behind
`lax.cond` in the JAX original, is evaluated on every step and selected
with `torch.where` (one extra map-key sort per batch instead of a host
sync).  The fused and chained steps read the batch's completed-frame
count once per batch and run `_handle_frame` for those slots only, where
the JAX original evaluates `lax.cond(k < n_done, ...)` per slot on the
device: one host sync a batch instead of registering every empty slot.
Frame assembly (`assemble_frames`, not the sampling of the batched
path) reads its scatter's winner mask once a batch too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.segment import take
from veloslam_tpu_torch.core.timeline import interpolate_poses
from veloslam_tpu_torch.decode.decode import (DeviceCalib, compensate,
                                              decode_packets)
from veloslam_tpu_torch.decode.frames import (AssemblyCarry, SampleCarry,
                                              assemble_frames, hash16,
                                              sample_frames)
from veloslam_tpu_torch.io import packets as pkmod
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx

# Lateral-observability gate on the rolling-map target: registration
# output is trusted only when the map holds at least this many usable
# voxels with a NON-HORIZONTAL normal (|n_z| < 0.7).  A young map is
# mostly ground plane, against which GN slides laterally.
MIN_WALLISH_VOXELS = 30


class OdometryState(NamedTuple):
    carry: Union[AssemblyCarry, SampleCarry]
    map_grid: vx.VoxelGrid          # rolling local map
    corr_q: torch.Tensor            # (4,) correction C = T_est ∘ T_ins⁻¹
    corr_t: torch.Tensor            # (3,)
    traj_q: torch.Tensor            # (T, 4) per-frame pose estimates
    traj_t: torch.Tensor            # (T, 3)
    traj_time: torch.Tensor         # (T,) f32 seconds rel. to stream start
    n_frames: torch.Tensor          # () int32
    have_map: torch.Tensor          # () bool — first frame bootstraps
    min_dense_cov: torch.Tensor     # () running min of window coverage
    corr_t_prev: torch.Tensor       # (3,) correction at the previous update
    corr_time: torch.Tensor         # () stream-relative f32 seconds
    corr_time_prev: torch.Tensor    # ()


def init_state(n_beams: int = 32, *, device, map_capacity: int = 32768,
               max_frames: int = 4096,
               max_firings: int = C.MAX_FIRINGS_PER_FRAME,
               voxel_size: float = 1.0,
               sample_assembly: bool = False) -> OdometryState:
    """An empty stream's state; its carry is the sampling carry of the
    batched `sample_assembly` path, else the assembly carry of n_beams
    beams."""
    f32 = dict(dtype=torch.float32, device=device)
    grid = vx.VoxelGrid(
        keys=torch.full((map_capacity,), vx.INVALID_KEY, dtype=torch.int32,
                        device=device),
        count=torch.zeros(map_capacity, **f32),
        mean=torch.zeros((map_capacity, 3), **f32),
        cov=torch.zeros((map_capacity, 3, 3), **f32),
        origin=torch.zeros(3, **f32),
        voxel_size=torch.tensor(voxel_size, **f32))
    return OdometryState(
        carry=(SampleCarry.init(max_firings, device=device)
               if sample_assembly else
               AssemblyCarry.init(n_beams, max_firings, device=device)),
        map_grid=grid,
        corr_q=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32),
        corr_t=torch.zeros(3, **f32),
        traj_q=torch.zeros((max_frames, 4), **f32),
        traj_t=torch.zeros((max_frames, 3), **f32),
        traj_time=torch.zeros(max_frames, **f32),
        n_frames=torch.zeros((), dtype=torch.int32, device=device),
        have_map=torch.zeros((), dtype=torch.bool, device=device),
        min_dense_cov=torch.ones((), **f32),
        corr_t_prev=torch.zeros(3, **f32),
        corr_time=torch.zeros((), **f32),
        corr_time_prev=torch.zeros((), **f32))


def _subsample(frame_xyz, frame_mask, n_out: int):
    """Pick n_out valid points of each frame, spread over the whole frame:
    frames (S, L, MAX_F, 3) + masks (S, L, MAX_F) → (S, n_out, 3) points
    and (S, n_out) masks.

    The n_out valid points with the smallest 16-bit multiplicative hash
    of their flat index are found without a sort: a 65536-bin histogram
    of the hashes, its cumulative sum, the first bin that reaches n_out,
    then a rank inside that bin.  They are compacted in array (azimuth)
    order, and the output slot is bit-reversed when n_out is a power of
    two, so any power-of-two prefix is again a uniform subsample.
    Integer work throughout: the choice is exactly the JAX package's."""
    S = frame_mask.shape[0]
    xyz = frame_xyz.reshape(S, -1, 3)
    m = frame_mask.reshape(S, -1)
    n = m.shape[1]
    dev = m.device
    i32 = torch.int32
    h = hash16(torch.arange(n, device=dev)).expand(S, n)
    hist = torch.zeros((S, 65536), dtype=i32, device=dev)
    hist.scatter_add_(1, torch.where(m, h, 0).long(), m.to(i32))
    cum = torch.cumsum(hist, 1, dtype=i32)                   # (S, 65536)
    # Smallest bin b with count(h < b + 1) >= n_out; all valid if fewer.
    b = torch.searchsorted(cum, torch.full((S, 1), n_out, dtype=i32,
                                           device=dev)).to(i32)
    below = torch.where(b > 0, torch.gather(
        cum, 1, torch.clamp(b - 1, min=0).long()), 0)        # (S, 1)
    in_b = m & (h == b)
    rank_b = torch.cumsum(in_b.to(i32), 1, dtype=i32) - 1
    pre = m & ((h < b) | (in_b & (rank_b < n_out - below)))
    dest = torch.cumsum(pre.to(i32), 1, dtype=i32) - 1
    dest = torch.where(pre & (dest < n_out), dest, n_out)
    if n_out & (n_out - 1) == 0:
        bits = n_out.bit_length() - 1
        rev = torch.zeros_like(dest)
        for i in range(bits):
            rev = rev | (((dest >> i) & 1) << (bits - 1 - i))
        dest = torch.where(dest < n_out, rev, n_out)
    # Writes JAX drops (mode="drop") land in a trash row that is cut off;
    # every kept destination is written once.
    dest = dest.long()
    out = torch.zeros((S, n_out + 1, 3), dtype=xyz.dtype, device=dev)
    out.scatter_(1, dest[..., None].expand(-1, -1, 3), xyz)
    msk = torch.zeros((S, n_out + 1), dtype=torch.bool, device=dev)
    msk.scatter_(1, dest, pre)
    return out[:, :n_out], msk[:, :n_out]


def _handle_frame(st: OdometryState, k: int, fb_xyz, fb_mask, starts,
                  n_done: int, batch_start_rel_stream_s, track_rel_s,
                  track_q, track_t, track_v, *, reg_points: int,
                  reg_iterations: int, min_points: int,
                  min_planarity: float, reassociate_every: int = 1,
                  map_decay: float = 0.98) -> OdometryState:
    """Register frame slot `k` against the running map with the running
    correction and fold it into the state; slots at or past `n_done` (the
    batch's completed frames, read once by the caller) leave it as is.
    Shared body of the fused `odometry_step` and the chained
    `frame_step`."""
    if k >= n_done:
        return st
    start_rel = starts[k:k + 1]
    # INS pose at the frame start (batch time base).
    ins = interpolate_poses(track_rel_s, track_q, track_t, track_v,
                            start_rel)
    ins = se3.Pose(ins.q[0], ins.t[0])
    # Frame points (world/INS frame) → local (frame-start) frame.
    pts, msk = _subsample(fb_xyz[k:k + 1], fb_mask[k:k + 1], reg_points)
    pts_local = se3.apply(se3.inverse(ins), pts[0])
    msk = msk[0]
    prior = se3.compose(se3.Pose(st.corr_q, st.corr_t), ins)

    target = gicp.plane_grid_from(st.map_grid, min_points=min_points,
                                  min_planarity=min_planarity)
    res = gicp.register(pts_local, msk, target, prior, None,
                        iterations=reg_iterations,
                        reassociate_every=reassociate_every)
    # Lateral-observability gate (a young map is mostly ground plane).
    wallish = torch.sum(target.usable
                        & (torch.abs(target.normal[:, 2]) < 0.7))
    healthy = ((res.n_matched > 500) & torch.all(torch.isfinite(res.pose.t))
               & st.have_map & (wallish >= MIN_WALLISH_VOXELS))
    est = se3.Pose(torch.where(healthy, res.pose.q, prior.q),
                   torch.where(healthy, res.pose.t, prior.t))

    # Update the correction and the trajectory (a write past the buffer
    # is dropped).
    corr = se3.compose(est, se3.inverse(ins))
    n = st.n_frames
    traj_q = _scatter_rows(st.traj_q, n[None], est.q[None])
    traj_t = _scatter_rows(st.traj_t, n[None], est.t[None])
    traj_time = _scatter_rows(st.traj_time, n[None],
                              batch_start_rel_stream_s + start_rel)

    # Merge the registered scan into the rolling map with decay; one
    # frame occupies at most reg_points voxels.
    grid = st.map_grid
    scan_grid = vx.build_grid(se3.apply(est, pts_local), msk, grid.origin,
                              grid.voxel_size, capacity=reg_points)
    merged = vx.merge_stats(grid._replace(count=grid.count * map_decay),
                            scan_grid, capacity=grid.capacity)
    return st._replace(
        map_grid=merged, corr_q=corr.q, corr_t=corr.t, traj_q=traj_q,
        traj_t=traj_t, traj_time=traj_time, n_frames=n + 1,
        have_map=torch.ones_like(st.have_map))


def assemble_step(carry: AssemblyCarry, pkts, calib: DeviceCalib,
                  pkt_rel_s, carry_start_rel_s, track_rel_s, track_q,
                  track_t, track_v, *, model: str, n_beams: int,
                  max_frames_batch: int = 4):
    """Chained path, stage 1: decode + compensation + lean frame assembly
    → (frame xyz, frame masks, n_done, starts, new carry, open start)."""
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    fb, n_done, starts, carry2, open_start = assemble_frames(
        dec, xyz_w, pkt_rel_s, carry, carry_start_rel_s, model=model,
        n_beams=n_beams, max_frames=max_frames_batch, lean=True)
    return fb.xyz, fb.mask, n_done, starts, carry2, open_start


def frame_step(state: OdometryState, k: int, fb_xyz, fb_mask, starts,
               n_done: int, batch_start_rel_stream_s, track_rel_s, track_q,
               track_t, track_v, *, reg_points: int = 16384,
               reg_iterations: int = 8, min_points: int = 4,
               min_planarity: float = 0.35,
               reassociate_every: int = 1) -> OdometryState:
    """Chained path, stage 2: register and integrate frame slot `k` (a
    no-op at or past `n_done`, the completed-frame count as a host int).

    As in the JAX package, `reassociate_every` is accepted and not passed
    on, and the map decays at the default 0.98: the chained path
    associates every iteration whatever the caller asks, so it equals the
    fused path only at its defaults."""
    return _handle_frame(state, k, fb_xyz, fb_mask, starts, n_done,
                         batch_start_rel_stream_s, track_rel_s, track_q,
                         track_t, track_v, reg_points=reg_points,
                         reg_iterations=reg_iterations,
                         min_points=min_points, min_planarity=min_planarity)


def odometry_step(state: OdometryState, pkts, calib: DeviceCalib,
                  pkt_rel_s, carry_start_rel_s, batch_start_rel_stream_s,
                  track_rel_s, track_q, track_t, track_v, *, model: str,
                  n_beams: int, reg_points: int = 16384,
                  reg_iterations: int = 8, max_frames_batch: int = 4,
                  min_points: int = 4, min_planarity: float = 0.35,
                  reassociate_every: int = 1, map_decay: float = 0.98
                  ) -> Tuple[OdometryState, torch.Tensor]:
    """Fused step: consume one packet batch, register and integrate its
    completed frames one after another; returns (new state,
    open_start_rel_s).  Times as `odometry_step_batched`'s.  Reads the
    completed-frame count once."""
    fb_xyz, fb_mask, n_done, starts, carry, open_start = assemble_step(
        state.carry, pkts, calib, pkt_rel_s, carry_start_rel_s,
        track_rel_s, track_q, track_t, track_v, model=model,
        n_beams=n_beams, max_frames_batch=max_frames_batch)
    state = state._replace(carry=carry)
    n_done = int(n_done)
    for k in range(max_frames_batch):
        state = _handle_frame(
            state, k, fb_xyz, fb_mask, starts, n_done,
            batch_start_rel_stream_s, track_rel_s, track_q, track_t,
            track_v, reg_points=reg_points, reg_iterations=reg_iterations,
            min_points=min_points, min_planarity=min_planarity,
            reassociate_every=reassociate_every, map_decay=map_decay)
    return state, open_start


class SlotResults(NamedTuple):
    """Per-frame-slot outputs of one batched odometry step (leading F)."""

    done: torch.Tensor        # (F,) bool — slot holds a completed frame
    est_q: torch.Tensor       # (F, 4) estimated world pose
    est_t: torch.Tensor       # (F, 3)
    start_rel_s: torch.Tensor  # (F,) frame start, batch time base
    pts_local: torch.Tensor   # (F, P, 3) subsampled scan, frame-local
    msk: torch.Tensor         # (F, P)
    n_matched: torch.Tensor   # (F,) int32


def _scatter_rows(buf: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """buf.at[idx].set(rows, mode="drop"): indices ≥ len(buf) are dropped
    (they land in a trash row that is cut off)."""
    T = buf.shape[0]
    out = torch.cat([buf, buf.new_zeros((1, *buf.shape[1:]))])
    out.index_copy_(0, torch.clamp(idx, max=T).long(), rows)
    return out[:T]


def _select_grid(pred: torch.Tensor, a: vx.VoxelGrid,
                 b: vx.VoxelGrid) -> vx.VoxelGrid:
    """Leafwise torch.where(pred, a, b) over two grids of one capacity."""
    return vx.VoxelGrid(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def _batched_core(state: OdometryState, pkts, calib: DeviceCalib,
                  pkt_rel_s, carry_start_rel_s, batch_start_rel_stream_s,
                  track_rel_s, track_q, track_t, track_v, *, model: str,
                  reg_points: int, reg_iterations: int,
                  max_frames_batch: int, min_points: int,
                  min_planarity: float, n_beams: int = 32,
                  use_dense: bool = False, reassociate_every: int = 1,
                  sample_assembly: bool = False, map_decay: float = 0.98
                  ) -> Tuple[OdometryState, torch.Tensor, SlotResults]:
    """Body of the batched odometry step; also returns per-slot results.

    `sample_assembly` takes each slot's points from `sample_frames` (the
    state's carry must be a SampleCarry); otherwise frames are assembled
    (lean) and every slot subsampled.  `use_dense` registers through the
    map's dilated dense index and tracks its window coverage; otherwise
    through the exact binary-search lookup."""
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    F = max_frames_batch
    dev = xyz_w.device
    if sample_assembly:
        sf, n_done, starts, carry, open_start = sample_frames(
            dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
            model=model, max_frames=F, points_per_frame=reg_points)
        pts, msk = sf.xyz, sf.mask
    else:
        fb, n_done, starts, carry, open_start = assemble_frames(
            dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
            model=model, n_beams=n_beams, max_frames=F, lean=True)
        pts, msk = _subsample(fb.xyz, fb.mask, reg_points)
    state = state._replace(carry=carry)
    slot_done = torch.arange(F, device=dev) < n_done           # (F,)
    msk = msk & slot_done[:, None]

    # Per-frame INS poses at frame starts (one batched interpolation).
    ins = interpolate_poses(track_rel_s, track_q, track_t, track_v, starts)
    ins_inv = se3.inverse(ins)
    pts_local = se3.apply(se3.Pose(ins_inv.q[:, None], ins_inv.t[:, None]),
                          pts)

    priors = se3.compose(se3.Pose(state.corr_q, state.corr_t), ins)
    # Constant-velocity extrapolation of the correction translation: each
    # slot's prior advances the batch-start correction by its own time
    # offset × the measured correction rate (active at batch periods
    # ≥ 0.4 s; the rate is clamped to ±3 m/s).
    abs_starts = batch_start_rel_stream_s + starts             # (F,)
    dt_cc = state.corr_time - state.corr_time_prev
    corr_rate = torch.where(dt_cc > 0.4,
                            (state.corr_t - state.corr_t_prev)
                            / torch.clamp(dt_cc, min=1e-3), 0.0)
    corr_rate = torch.clamp(corr_rate, -3.0, 3.0)
    extrap = (abs_starts - state.corr_time)[:, None] * corr_rate[None, :]
    priors = se3.Pose(priors.q, priors.t + extrap)

    target = gicp.plane_grid_from(state.map_grid, min_points=min_points,
                                  min_planarity=min_planarity)
    dense = None
    if use_dense:
        dense = vx.build_dilated_index(state.map_grid, target.usable)
        cov = vx.window_coverage(state.map_grid, target.usable, dense.lo,
                                 dense.table.shape)
        state = state._replace(
            min_dense_cov=torch.minimum(state.min_dense_cov, cov))
    res = gicp.register_batch(pts_local, msk, target, priors, dense,
                              iterations=reg_iterations,
                              reassociate_every=reassociate_every)
    # Lateral-observability gate (MIN_WALLISH_VOXELS) and match count.
    mature = torch.sum(target.usable
                       & (torch.abs(target.normal[:, 2]) < 0.7)
                       ) >= MIN_WALLISH_VOXELS
    healthy = ((res.n_matched > 500)
               & torch.all(torch.isfinite(res.pose.t), dim=-1)
               & state.have_map & mature)                      # (F,)
    est_q = torch.where(healthy[:, None], res.pose.q, priors.q)
    est_t = torch.where(healthy[:, None], res.pose.t, priors.t)

    # Trajectory scatter: done slots land at n_frames + k, others drop.
    n = state.n_frames
    T = state.traj_q.shape[0]
    idx = torch.where(slot_done,
                      n + torch.arange(F, dtype=torch.int32, device=dev), T)
    traj_q = _scatter_rows(state.traj_q, idx, est_q)
    traj_t = _scatter_rows(state.traj_t, idx, est_t)
    traj_time = _scatter_rows(state.traj_time, idx, abs_starts)

    # Correction from the LAST completed frame of the batch.
    corr_all = se3.compose(se3.Pose(est_q, est_t), ins_inv)
    last = torch.clamp(n_done - 1, min=0)
    upd = n_done > 0
    corr_q = torch.where(upd, take(corr_all.q, last), state.corr_q)
    corr_t = torch.where(upd, take(corr_all.t, last), state.corr_t)
    corr_t_prev = torch.where(upd, state.corr_t, state.corr_t_prev)
    corr_time_prev = torch.where(upd, state.corr_time, state.corr_time_prev)
    corr_time = torch.where(upd, take(abs_starts, last), state.corr_time)

    # Merge all completed frames into the rolling map in one grid build
    # (capacity = the map's row budget).
    pts_world = se3.apply(se3.Pose(est_q[:, None], est_t[:, None]),
                          pts_local)
    grid = state.map_grid
    scan_grid = vx.build_grid(pts_world.reshape(-1, 3), msk.reshape(-1),
                              grid.origin, grid.voxel_size,
                              capacity=grid.capacity)
    decay = torch.pow(map_decay, n_done.to(torch.float32))
    merged = vx.merge_stats(grid._replace(count=grid.count * decay),
                            scan_grid, capacity=grid.capacity)
    # Packed keys cover ±2^9 voxels around the origin; when the vehicle
    # nears the window edge, re-key the map around the current position.
    pos = take(est_t, last)
    half_range_m = 512.0 * merged.voxel_size
    need_rebase = upd & (torch.linalg.vector_norm(pos - merged.origin)
                         > 0.4 * half_range_m)
    merged = _select_grid(need_rebase, vx.rebase_grid(merged, pos), merged)
    state = state._replace(
        map_grid=merged, corr_q=corr_q, corr_t=corr_t, traj_q=traj_q,
        traj_t=traj_t, traj_time=traj_time, n_frames=n + n_done,
        have_map=state.have_map | upd,
        corr_t_prev=corr_t_prev, corr_time=corr_time,
        corr_time_prev=corr_time_prev)
    slots = SlotResults(done=slot_done, est_q=est_q, est_t=est_t,
                        start_rel_s=starts, pts_local=pts_local, msk=msk,
                        n_matched=res.n_matched)
    return state, open_start, slots


def odometry_step_batched(state: OdometryState, pkts, calib: DeviceCalib,
                          pkt_rel_s, carry_start_rel_s,
                          batch_start_rel_stream_s, track_rel_s, track_q,
                          track_t, track_v, *, model: str,
                          n_beams: int = 32, reg_points: int = 16384,
                          reg_iterations: int = 8,
                          max_frames_batch: int = 4, min_points: int = 4,
                          min_planarity: float = 0.35,
                          use_pallas: bool = False, use_dense: bool = False,
                          reassociate_every: int = 1,
                          sample_assembly: bool = False,
                          map_decay: float = 0.98
                          ) -> Tuple[OdometryState, torch.Tensor]:
    """Consume one packet batch; returns (new state, open_start_rel_s).

    All frame slots register against the batch-START map with the
    batch-start correction, then merge.  Times: `pkt_rel_s` and
    `carry_start_rel_s` are relative to this batch's anchor;
    `batch_start_rel_stream_s` is the anchor relative to the stream start.
    `use_pallas` is accepted and changes nothing: on the card the normal
    equations always run in the CUDA kernel (the JAX package's switch
    chose its Pallas kernel)."""
    state, open_start, _ = _batched_core(
        state, pkts, calib, pkt_rel_s, carry_start_rel_s,
        batch_start_rel_stream_s, track_rel_s, track_q, track_t, track_v,
        model=model, n_beams=n_beams, reg_points=reg_points,
        reg_iterations=reg_iterations, max_frames_batch=max_frames_batch,
        min_points=min_points, min_planarity=min_planarity,
        use_dense=use_dense, reassociate_every=reassociate_every,
        sample_assembly=sample_assembly, map_decay=map_decay)
    return state, open_start


def packets_per_second(model: str) -> float:
    """Sensor packet rate from the timing model (HDL-64 packets carry two
    32-laser blocks per firing, so its packet rate doubles)."""
    block_us = (C.VLP16_FIRING_BLOCK_US if model == "vlp16"
                else C.HDL32_FIRING_BLOCK_US)
    rate = 1e6 / block_us / C.HDL_FIRINGS_PER_PACKET
    return rate * 2.0 if model == "hdl64" else rate


def slots_for_batch(model: str, batch: int, frame_rate_hz: float = 10.0
                    ) -> int:
    """Frame slots a packet batch may complete (+margin)."""
    return max(4, int(np.ceil(batch / packets_per_second(model)
                              * frame_rate_hz)) + 4)


class StreamingOdometry:
    """Host driver: feeds batches, keeps the int64 µs time anchors, reads
    the trajectory back once at the end.

    The path follows the JAX package's flags and defaults: `batched`
    (`odometry_step_batched`, with `sample_assembly` following `batched`
    unless given, and `use_dense` for the dilated index), else `fused`
    (`odometry_step`), else the chained `assemble_step` + `frame_step`.
    `use_pallas` is accepted and changes nothing: on the card the normal
    equations always run in the CUDA kernel."""

    MAX_FRAMES_BATCH = 4
    WINDOW_LEN = 64      # fixed INS-window length (pose samples)

    def __init__(self, calib: DeviceCalib, *, model: str = "hdl32",
                 n_beams: int = 32, voxel_size: float = 1.0,
                 reg_points: int = 16384, reg_iterations: int = 8,
                 map_capacity: int = 32768, max_frames: int = 4096,
                 fused: bool = True, batched: bool = False,
                 use_pallas: bool = False, use_dense: bool = False,
                 reassociate_every: int = 1,
                 sample_assembly: Optional[bool] = None,
                 frame_rate_hz: float = 10.0, map_decay: float = 0.98):
        self.calib = calib
        self.device = calib.rot_correction_deg.device
        self.model = model
        self.frame_rate_hz = float(frame_rate_hz)
        self.n_beams = n_beams
        self.reg_points = reg_points
        self.reg_iterations = reg_iterations
        self.fused = fused
        self.batched = batched
        self.use_pallas = use_pallas
        self.use_dense = use_dense
        self.reassociate_every = reassociate_every
        self.map_decay = float(map_decay)
        # Frame sampling exists only for the batched path, and is its
        # default there (None follows `batched`).
        self.sample_assembly = (bool(batched) if sample_assembly is None
                                else sample_assembly)
        self.state = init_state(n_beams, device=self.device,
                                map_capacity=map_capacity,
                                max_frames=max_frames, voxel_size=voxel_size,
                                sample_assembly=self.sample_assembly)
        self.batches_fed = 0
        self._est_frames: Optional[int] = None
        self._stream_t0_us: Optional[int] = None
        self._open_anchor: Optional[int] = None
        self._open_start_dev: Optional[torch.Tensor] = None
        # Slot count for the current feed (bootstrap-ramp batches use
        # fewer slots than the steady batch; None = steady).
        self._feed_slots: Optional[int] = None

    def ensure_capacity(self, n_frames: int) -> None:
        """Grow the trajectory buffers to hold at least `n_frames` (the
        trajectory scatter drops out-of-range writes otherwise)."""
        st = self.state
        cur = st.traj_q.shape[0]
        if n_frames <= cur:
            return
        pad = n_frames - cur
        self.state = st._replace(
            traj_q=torch.cat([st.traj_q, st.traj_q.new_zeros((pad, 4))]),
            traj_t=torch.cat([st.traj_t, st.traj_t.new_zeros((pad, 3))]),
            traj_time=torch.cat([st.traj_time,
                                 st.traj_time.new_zeros(pad)]))

    def run(self, pkts: np.ndarray, times_us: np.ndarray, track,
            batch: int = 512) -> dict:
        """Stream a whole recording; returns the trajectory (one readback
        at the end)."""
        if len(pkts) == 0:
            return {"times_us": np.zeros(0, np.int64),
                    "quaternions": np.zeros((0, 4), np.float32),
                    "positions": np.zeros((0, 3), np.float32),
                    "n_frames": 0}
        self.run_device(pkts, times_us, track, batch=batch)
        st = self.state
        n_frames = int(st.n_frames)          # the single readback point
        return {
            "dense_index_min_coverage": float(st.min_dense_cov),
            # float64 before the epoch shift (f32 + 1.7e15 µs would round)
            "times_us": (st.traj_time[:n_frames].cpu().numpy()
                         .astype(np.float64) * 1e6
                         + self._stream_t0_us).astype(np.int64),
            "quaternions": st.traj_q[:n_frames].cpu().numpy(),
            "positions": st.traj_t[:n_frames].cpu().numpy(),
            "n_frames": n_frames,
        }

    def run_device(self, pkts: np.ndarray, times_us: np.ndarray, track,
                   batch: int = 512) -> None:
        """Stream a whole recording without reading the trajectory back.

        Bootstrap ramp (batched path): the first batches of a fresh stream
        double from 256 packets up to `batch`, so the frames registered
        against a young map stay few.  A trailing partial batch is padded
        with idle
        packets (no returns, frozen azimuth: decode to nothing, close no
        frame) up to the batch size."""
        if len(pkts) == 0:
            return
        need = slots_for_batch(self.model, batch,
                               frame_rate_hz=self.frame_rate_hz)
        if need > self.MAX_FRAMES_BATCH:
            self.MAX_FRAMES_BATCH = need
        # Trajectory capacity from the recording length, in 1024 buckets.
        need_cap = (int(len(pkts) / packets_per_second(self.model)
                        * self.frame_rate_hz * 1.2)
                    + 2 * self.MAX_FRAMES_BATCH + 16)
        # Host-known frame estimate of this recording: sizes the
        # end-of-stream closure budget (runtime.pipeline.sweep_budget).
        self._est_frames = need_cap
        self.ensure_capacity(-(-need_cap // 1024) * 1024)
        segments = []
        off = 0
        if self.batched and self._stream_t0_us is None:
            b = 256
            while b < batch and off + b <= len(pkts):
                segments.append((off, b))
                off += b
                b *= 2
        tail = (len(pkts) - off) % batch
        if tail:
            pad = batch - tail
            pkts = np.concatenate(
                [pkts, pkmod.idle_lidar_packets(pkts[-1], pad)])
            times_us = np.concatenate(
                [times_us, np.full(pad, times_us[-1], np.int64)])
        segments += [(s, batch) for s in range(off, len(pkts), batch)]
        for s, n in segments:
            t0, t1 = int(times_us[s]), int(times_us[s + n - 1])
            w = track.window(t0, t1, anchor_us=t0)
            self._feed_slots = (slots_for_batch(
                self.model, n, frame_rate_hz=self.frame_rate_hz)
                if n < batch else None)
            try:
                self.feed(pkts[s:s + n], times_us[s:s + n], w)
            finally:
                self._feed_slots = None

    def _pad_window(self, w: dict) -> dict:
        """Fix the window length: subsample evenly or edge-pad
        (interpolation clamps at the edges, so repeated boundary samples
        are harmless)."""
        L = self.WINDOW_LEN
        n = len(w["rel_s"])
        out = {}
        if n > L:
            idx = np.linspace(0, n - 1, L).round().astype(np.int64)
            for k, v in w.items():
                out[k] = v[idx]
        else:
            for k, v in w.items():
                pad = [(0, L - n)] + [(0, 0)] * (v.ndim - 1)
                out[k] = np.pad(v, pad, mode="edge")
        return out

    def feed(self, pkts, times_us: np.ndarray, track_window: dict) -> None:
        """Consume one packet batch.  The open-frame start stays a device
        scalar, carried into the next call after a host-known anchor
        shift, so streaming reads nothing back."""
        dev = self.device
        track_window = self._pad_window(track_window)
        anchor = int(times_us[0])
        if self._stream_t0_us is None:
            self._stream_t0_us = anchor
            prev_anchor = anchor
            open_dev = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            prev_anchor = self._open_anchor
            open_dev = self._open_start_dev

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        carry_start = open_dev + f32((prev_anchor - anchor) * 1e-6)
        rel = torch.as_tensor(
            ((np.asarray(times_us) - anchor) * 1e-6).astype(np.float32),
            device=dev)
        batch_rel = f32((anchor - self._stream_t0_us) * 1e-6)
        trk = [torch.as_tensor(track_window[k], device=dev)
               for k in ("rel_s", "q", "t", "v")]
        open_start = self._step(
            torch.as_tensor(pkts, device=dev), rel, carry_start, batch_rel,
            trk, max_frames_batch=self._feed_slots or self.MAX_FRAMES_BATCH)
        self.batches_fed += 1
        self._open_start_dev = open_start
        self._open_anchor = anchor

    def _step(self, pkts, rel, carry_start, batch_rel, trk, *,
              max_frames_batch: int) -> torch.Tensor:
        """One step of the chosen path on the prepared batch; updates the
        state and returns the open-frame start."""
        kw = dict(reg_points=self.reg_points,
                  reg_iterations=self.reg_iterations,
                  reassociate_every=self.reassociate_every)
        if self.batched:
            self.state, open_start = odometry_step_batched(
                self.state, pkts, self.calib, rel, carry_start, batch_rel,
                *trk, model=self.model, n_beams=self.n_beams,
                max_frames_batch=max_frames_batch,
                use_pallas=self.use_pallas, use_dense=self.use_dense,
                sample_assembly=self.sample_assembly,
                map_decay=self.map_decay, **kw)
        elif self.fused:
            self.state, open_start = odometry_step(
                self.state, pkts, self.calib, rel, carry_start, batch_rel,
                *trk, model=self.model, n_beams=self.n_beams,
                max_frames_batch=max_frames_batch,
                map_decay=self.map_decay, **kw)
        else:
            fb_xyz, fb_mask, n_done, starts, carry, open_start = (
                assemble_step(self.state.carry, pkts, self.calib, rel,
                              carry_start, *trk, model=self.model,
                              n_beams=self.n_beams,
                              max_frames_batch=max_frames_batch))
            self.state = self.state._replace(carry=carry)
            n_done = int(n_done)       # the completed-frame count, once
            for k in range(max_frames_batch):
                self.state = frame_step(
                    self.state, k, fb_xyz, fb_mask, starts, n_done,
                    batch_rel, *trk, **kw)
        return open_start
