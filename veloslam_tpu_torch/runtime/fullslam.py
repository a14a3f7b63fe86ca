"""Device-resident full SLAM: bulk odometry + keyframe ring + descriptors.

Port of veloslam_tpu/runtime/fullslam.py.  The keyframe layer (selection,
scan storage, scan-context descriptors) runs on the device in the same
step as the batched odometry, so the stream reads nothing back; after
the stream, `finalize_device` queues loop-closure proposal, batched GICP
verification, the pose-graph solve and the trajectory correction
(runtime.devfinalize) before any read.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.graph import scancontext as sc
from veloslam_tpu_torch.runtime import devfinalize as dv
from veloslam_tpu_torch.runtime import odometry as odo


class KeyframeRing(NamedTuple):
    """Fixed-capacity device store of keyframe scans + descriptors.

    Every per-keyframe leaf holds capacity + 1 rows: row `capacity` is
    the trash row that admissions to a full ring write to (the JAX
    package drops them with mode="drop").  Admission writes the ring in
    place: it is ~100 MB at 1024 × 8192 points, and a functional copy per
    batch would move all of it."""

    q: torch.Tensor           # (K+1, 4) world pose at admission
    t: torch.Tensor           # (K+1, 3)
    time_rel_s: torch.Tensor  # (K+1,) seconds since stream start
    desc: torch.Tensor        # (K+1, R, S) scan-context descriptors
    pts: torch.Tensor         # (K+1, Pk, 3) frame-local subsampled scan
    msk: torch.Tensor         # (K+1, Pk)
    n: torch.Tensor           # () int32 — admitted keyframes (≤ K)
    last_q: torch.Tensor      # (4,) pose of the most recent keyframe
    last_t: torch.Tensor      # (3,)
    have: torch.Tensor        # () bool

    @staticmethod
    def init(capacity: int, scan_points: int, *, device,
             n_rings: int = sc.N_RINGS,
             n_sectors: int = sc.N_SECTORS) -> "KeyframeRing":
        f32 = dict(dtype=torch.float32, device=device)
        rows = capacity + 1
        q = torch.zeros((rows, 4), **f32)
        q[:, 0] = 1.0
        return KeyframeRing(
            q=q, t=torch.zeros((rows, 3), **f32),
            time_rel_s=torch.zeros(rows, **f32),
            desc=torch.zeros((rows, n_rings, n_sectors), **f32),
            pts=torch.zeros((rows, scan_points, 3), **f32),
            msk=torch.zeros((rows, scan_points), dtype=torch.bool,
                            device=device),
            n=torch.zeros((), dtype=torch.int32, device=device),
            last_q=se3.Pose.identity(device=device).q,
            last_t=torch.zeros(3, **f32),
            have=torch.zeros((), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.q.shape[0] - 1


class SlamState(NamedTuple):
    odom: odo.OdometryState
    kf: KeyframeRing


def _quat_angle(qa, qb):
    return 2.0 * torch.arccos(torch.clamp(torch.abs(torch.sum(qa * qb, -1)),
                                          0.0, 1.0))


def _admit_keyframes(kf: KeyframeRing, slots: odo.SlotResults,
                     batch_start_rel_stream_s, *, scan_points: int,
                     kf_dist_m: float, kf_rot_rad: float) -> KeyframeRing:
    """Sequential keyframe admission over the batch's frame slots.

    The rule (distance / rotation from the LAST admitted keyframe) is
    sequential, so a loop over the F slots carries (n, last pose, have)
    as device scalars and picks each slot's ring row, or the trash row;
    then one batched write per leaf fills the rows.  No host read."""
    desc = sc.scan_context_batch(slots.pts_local, slots.msk)    # (F, R, S)
    K = kf.capacity
    n, last_q, last_t, have = kf.n, kf.last_q, kf.last_t, kf.have
    rows = []
    for f in range(slots.done.shape[0]):
        q, t = slots.est_q[f], slots.est_t[f]
        dist = torch.linalg.vector_norm(t - last_t)
        is_kf = slots.done[f] & (~have | (dist > kf_dist_m)
                                 | (_quat_angle(q, last_q) > kf_rot_rad))
        rows.append(torch.where(is_kf & (n < K), n, K))
        n = torch.clamp(n + is_kf.to(torch.int32), max=K)
        last_q = torch.where(is_kf, q, last_q)
        last_t = torch.where(is_kf, t, last_t)
        have = have | is_kf
    rows = torch.stack(rows).long()
    kf.q.index_copy_(0, rows, slots.est_q)
    kf.t.index_copy_(0, rows, slots.est_t)
    kf.time_rel_s.index_copy_(0, rows,
                              batch_start_rel_stream_s + slots.start_rel_s)
    kf.desc.index_copy_(0, rows, desc)
    # Frame sampling emits bit-reversed slots: a power-of-two prefix is a
    # uniform strided subsample of the revolution.
    kf.pts.index_copy_(0, rows, slots.pts_local[:, :scan_points])
    kf.msk.index_copy_(0, rows, slots.msk[:, :scan_points])
    return kf._replace(n=n, last_q=last_q, last_t=last_t, have=have)


def slam_step_batched(state: SlamState, pkts, calib, pkt_rel_s,
                      carry_start_rel_s, batch_start_rel_stream_s,
                      track_rel_s, track_q, track_t, track_v, *,
                      model: str, n_beams: int = 32,
                      reg_points: int = 16384, reg_iterations: int = 8,
                      max_frames_batch: int = 4, min_points: int = 4,
                      min_planarity: float = 0.35, scan_points: int = 8192,
                      kf_dist_m: float = 2.0, kf_rot_rad: float = 0.1745,
                      use_pallas: bool = False, use_dense: bool = False,
                      reassociate_every: int = 1,
                      sample_assembly: bool = False, map_decay: float = 0.98
                      ) -> Tuple[SlamState, torch.Tensor]:
    """One device step: batched odometry (`odometry._batched_core`, its
    flags as there; `use_pallas` changes nothing) + keyframe admission
    (the ring is written in place)."""
    odom, open_start, slots = odo._batched_core(
        state.odom, pkts, calib, pkt_rel_s, carry_start_rel_s,
        batch_start_rel_stream_s, track_rel_s, track_q, track_t, track_v,
        model=model, n_beams=n_beams, reg_points=reg_points,
        reg_iterations=reg_iterations, max_frames_batch=max_frames_batch,
        min_points=min_points, min_planarity=min_planarity,
        use_dense=use_dense, reassociate_every=reassociate_every,
        sample_assembly=sample_assembly, map_decay=map_decay)
    kf = _admit_keyframes(state.kf, slots, batch_start_rel_stream_s,
                          scan_points=scan_points, kf_dist_m=kf_dist_m,
                          kf_rot_rad=kf_rot_rad)
    return SlamState(odom=odom, kf=kf), open_start


class FullSlam(odo.StreamingOdometry):
    """Host driver of the full device-resident SLAM loop: the batched
    odometry driver (always `batched`, with frame sampling; `use_dense`
    picks the dilated index, off by default as in the JAX package) plus a
    device keyframe ring; `finalize_device` runs loop closure + graph
    solve on it, `keyframes()` reads it back."""

    # Above graph.pcg.DENSE_MAX_POSES the finalize solves by matrix-free
    # PCG, so the ring is bounded by device memory: 16384 keyframes,
    # ~32 km at 2 m spacing.
    MAX_KF_CAPACITY = 16384

    def __init__(self, calib, *, model: str = "hdl32", n_beams: int = 32,
                 voxel_size: float = 1.0, reg_points: int = 16384,
                 reg_iterations: int = 8, map_capacity: int = 32768,
                 max_frames: int = 4096, kf_capacity: int = 512,
                 kf_scan_points: int = 8192, kf_dist_m: float = 2.0,
                 kf_rot_deg: float = 10.0, use_pallas: bool = False,
                 use_dense: bool = False, reassociate_every: int = 1,
                 frame_rate_hz: float = 10.0, map_decay: float = 0.98):
        super().__init__(calib, model=model, n_beams=n_beams,
                         voxel_size=voxel_size, reg_points=reg_points,
                         reg_iterations=reg_iterations,
                         map_capacity=map_capacity, max_frames=max_frames,
                         batched=True, use_pallas=use_pallas,
                         use_dense=use_dense,
                         reassociate_every=reassociate_every,
                         frame_rate_hz=frame_rate_hz, map_decay=map_decay)
        # Keyframe scans are a prefix of the registration point set.
        self.kf_scan_points = min(kf_scan_points, reg_points)
        self.kf_dist_m = float(kf_dist_m)
        self.kf_rot_rad = float(np.deg2rad(kf_rot_deg))
        self.ring = KeyframeRing.init(kf_capacity, self.kf_scan_points,
                                      device=self.device)

    def _step(self, pkts, rel, carry_start, batch_rel, trk, *,
              max_frames_batch: int) -> torch.Tensor:
        st, open_start = slam_step_batched(
            SlamState(odom=self.state, kf=self.ring), pkts, self.calib, rel,
            carry_start, batch_rel, *trk, model=self.model,
            n_beams=self.n_beams, reg_points=self.reg_points,
            reg_iterations=self.reg_iterations,
            max_frames_batch=max_frames_batch,
            scan_points=self.kf_scan_points, kf_dist_m=self.kf_dist_m,
            kf_rot_rad=self.kf_rot_rad, use_pallas=self.use_pallas,
            use_dense=self.use_dense,
            reassociate_every=self.reassociate_every,
            sample_assembly=self.sample_assembly, map_decay=self.map_decay)
        self.state, self.ring = st.odom, st.kf
        return open_start

    def ensure_kf_capacity(self, n: int) -> None:
        """Grow the ring to hold ≥ n keyframes (a power-of-two bucket,
        capped at MAX_KF_CAPACITY; beyond it the ring saturates and
        `keyframes()` reports ring_full)."""
        cur = self.ring.capacity
        if n <= cur:
            return
        K = min(1 << int(math.ceil(math.log2(max(n, 1)))),
                self.MAX_KF_CAPACITY)
        if K <= cur:
            return
        r = self.ring
        fresh = KeyframeRing.init(K - cur, r.pts.shape[1],
                                  device=self.device)

        def grow(old, new):       # real rows, new rows, then the trash row
            return torch.cat([old[:cur], new[:-1], old[cur:]])

        self.ring = r._replace(**{f: grow(getattr(r, f), getattr(fresh, f))
                                  for f in ("q", "t", "time_rel_s", "desc",
                                            "pts", "msk")})

    def run_device(self, pkts, times_us, track, batch: int = 512) -> None:
        # Size the ring for the recording (worst case: every frame is a
        # keyframe) before streaming.
        est = int(len(pkts) / odo.packets_per_second(self.model)
                  * self.frame_rate_hz * 1.2) + 8
        self.ensure_kf_capacity(est)
        super().run_device(pkts, times_us, track, batch=batch)

    def descriptor_scores(self):
        """(scores (K, K), shifts (K, K)) over the ring's K keyframe rows
        (the trash row left out), on the engine's device: all-pairs place
        recognition in one scancontext.descriptor_scores call."""
        return sc.descriptor_scores(self.ring.desc[:self.ring.capacity])

    def finalize_device(self, *, min_score: float, radius: float,
                        min_gap: int, max_candidates: int,
                        use_scan_context: bool, gn_iterations: int,
                        odom_info, closure_info, voxel_size: float,
                        capacity: int, max_per_keyframe: int = 2) -> dict:
        """Queue the end-of-stream sweep (propose → verify → solve →
        trajectory correction) on the live state; the returned tensors
        stay on the device until the caller reads them."""
        r = self.ring
        K = r.capacity
        st = self.state
        cand = dv.propose_closures(
            r.desc[:K], r.q[:K], r.t[:K], r.n, min_score=float(min_score),
            radius=float(radius), min_gap=int(min_gap),
            max_candidates=int(max_candidates),
            max_per_keyframe=int(max_per_keyframe),
            use_scan_context=bool(use_scan_context))
        meas_q, meas_t, accept = dv.verify_closures_device(
            r.pts[:K], r.msk[:K], cand, voxel_size=float(voxel_size),
            capacity=int(capacity),
            reassociate_every=dv.VERIFY_REASSOCIATE_EVERY)
        (solved_q, solved_t, traj_q, traj_t, n_acc, stats, rel_q,
         rel_t) = dv.solve_and_correct(
            r.q[:K], r.t[:K], r.time_rel_s[:K], r.n, cand, meas_q, meas_t,
            accept, dv.device_vector(odom_info, self.device),
            dv.device_vector(closure_info, self.device),
            st.traj_q, st.traj_t, st.traj_time, st.n_frames,
            gn_iterations=int(gn_iterations))
        return {
            "cand_i": cand.i, "cand_j": cand.j, "cand_valid": cand.valid,
            "meas_q": meas_q, "meas_t": meas_t, "accept": accept,
            "solved_q": solved_q, "solved_t": solved_t,
            "traj_q": traj_q, "traj_t": traj_t,
            "n_accepted": n_acc, "rel_q": rel_q, "rel_t": rel_t,
            "kf_n": r.n, "kf_time_rel_s": r.time_rel_s[:K],
            "traj_time": st.traj_time, "n_frames": st.n_frames,
        }

    def keyframes(self) -> dict:
        """Read the ring's occupied rows back."""
        r = self.ring
        n = int(r.n)
        return {
            "n": n,
            "ring_full": n >= r.capacity,
            "q": r.q[:n].cpu().numpy(),
            "t": r.t[:n].cpu().numpy(),
            "times_us": (r.time_rel_s[:n].cpu().numpy().astype(np.float64)
                         * 1e6 + (self._stream_t0_us or 0)).astype(np.int64),
            "pts": r.pts[:n].cpu().numpy(),
            "msk": r.msk[:n].cpu().numpy(),
        }
