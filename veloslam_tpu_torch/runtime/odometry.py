"""Device-resident bulk odometry: one step per packet batch.

Port of the batched, sample-assembly, dilated-index path of
veloslam_tpu/runtime/odometry.py.  One `odometry_step_batched` call runs
decode → motion compensation → frame sampling → scan-to-map GICP of every
completed frame against the batch-start rolling map → health gates →
trajectory scatter + correction update → map merge with decay → rebase.
The state (sampling carry, rolling voxel map, correction transform,
trajectory buffers) stays on the device; the host feeds packet batches
and INS windows and reads the trajectory back once at the end.

Estimation model: the INS provides compensation and priors; registration
maintains a correction C = T_est ∘ T_ins⁻¹, so each frame's prior is
C ∘ T_ins(start), with the correction translation extrapolated at its
measured rate (see `_batched_core`).

No step reads a device value back to the host.  The map rebase that the
JAX original runs behind `lax.cond` is evaluated on every step and
selected with `torch.where` (one extra 65536-key sort per batch instead
of a host sync).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.segment import take
from veloslam_tpu_torch.core.timeline import interpolate_poses
from veloslam_tpu_torch.decode.decode import (DeviceCalib, compensate,
                                              decode_packets)
from veloslam_tpu_torch.decode.frames import SampleCarry, sample_frames
from veloslam_tpu_torch.io import packets as pkmod
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx

# Lateral-observability gate on the rolling-map target: registration
# output is trusted only when the map holds at least this many usable
# voxels with a NON-HORIZONTAL normal (|n_z| < 0.7).  A young map is
# mostly ground plane, against which GN slides laterally.
MIN_WALLISH_VOXELS = 30


class OdometryState(NamedTuple):
    carry: SampleCarry
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


def init_state(*, device, map_capacity: int = 32768, max_frames: int = 4096,
               max_firings: int = C.MAX_FIRINGS_PER_FRAME,
               voxel_size: float = 1.0) -> OdometryState:
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
        carry=SampleCarry.init(max_firings, device=device),
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
                  min_planarity: float, reassociate_every: int = 1,
                  map_decay: float = 0.98
                  ) -> Tuple[OdometryState, torch.Tensor, SlotResults]:
    """Body of the batched odometry step; also returns per-slot results."""
    dec = decode_packets(pkts, calib, model=model)
    xyz_w, _ = compensate(dec, pkt_rel_s, track_rel_s, track_q, track_t,
                          track_v)
    F = max_frames_batch
    dev = xyz_w.device
    sf, n_done, starts, carry, open_start = sample_frames(
        dec, xyz_w, pkt_rel_s, state.carry, carry_start_rel_s,
        model=model, max_frames=F, points_per_frame=reg_points)
    state = state._replace(carry=carry)
    slot_done = torch.arange(F, device=dev) < n_done           # (F,)
    msk = sf.mask & slot_done[:, None]

    # Per-frame INS poses at frame starts (one batched interpolation).
    ins = interpolate_poses(track_rel_s, track_q, track_t, track_v, starts)
    ins_inv = se3.inverse(ins)
    pts_local = se3.apply(se3.Pose(ins_inv.q[:, None], ins_inv.t[:, None]),
                          sf.xyz)

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
                          reg_points: int = 16384, reg_iterations: int = 8,
                          max_frames_batch: int = 4, min_points: int = 4,
                          min_planarity: float = 0.35,
                          reassociate_every: int = 1,
                          map_decay: float = 0.98
                          ) -> Tuple[OdometryState, torch.Tensor]:
    """Consume one packet batch; returns (new state, open_start_rel_s).

    All frame slots register against the batch-START map with the
    batch-start correction, then merge.  Times: `pkt_rel_s` and
    `carry_start_rel_s` are relative to this batch's anchor;
    `batch_start_rel_stream_s` is the anchor relative to the stream start.
    """
    state, open_start, _ = _batched_core(
        state, pkts, calib, pkt_rel_s, carry_start_rel_s,
        batch_start_rel_stream_s, track_rel_s, track_q, track_t, track_v,
        model=model, reg_points=reg_points, reg_iterations=reg_iterations,
        max_frames_batch=max_frames_batch, min_points=min_points,
        min_planarity=min_planarity, reassociate_every=reassociate_every,
        map_decay=map_decay)
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
    """Host driver of the batched step: feeds batches, keeps the int64 µs
    time anchors, reads the trajectory back once at the end."""

    MAX_FRAMES_BATCH = 4
    WINDOW_LEN = 64      # fixed INS-window length (pose samples)

    def __init__(self, calib: DeviceCalib, *, model: str = "hdl32",
                 voxel_size: float = 1.0, reg_points: int = 16384,
                 reg_iterations: int = 8, map_capacity: int = 32768,
                 max_frames: int = 4096, reassociate_every: int = 1,
                 frame_rate_hz: float = 10.0, map_decay: float = 0.98):
        self.calib = calib
        self.device = calib.rot_correction_deg.device
        self.model = model
        self.frame_rate_hz = float(frame_rate_hz)
        self.reg_points = reg_points
        self.reg_iterations = reg_iterations
        self.reassociate_every = reassociate_every
        self.map_decay = float(map_decay)
        self.state = init_state(device=self.device,
                                map_capacity=map_capacity,
                                max_frames=max_frames, voxel_size=voxel_size)
        self.batches_fed = 0
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
        """Stream a whole recording without reading anything back.

        Bootstrap ramp: the first batches of a fresh stream double from
        256 packets up to `batch`, so the frames registered against a
        young map stay few.  A trailing partial batch is padded with idle
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
        self.ensure_capacity(-(-need_cap // 1024) * 1024)
        segments = []
        off = 0
        if self._stream_t0_us is None:
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
        self.state, open_start = odometry_step_batched(
            self.state, torch.as_tensor(pkts, device=dev), self.calib, rel,
            carry_start, batch_rel, *trk, model=self.model,
            reg_points=self.reg_points, reg_iterations=self.reg_iterations,
            max_frames_batch=self._feed_slots or self.MAX_FRAMES_BATCH,
            reassociate_every=self.reassociate_every,
            map_decay=self.map_decay)
        self.batches_fed += 1
        self._open_start_dev = open_start
        self._open_anchor = anchor
