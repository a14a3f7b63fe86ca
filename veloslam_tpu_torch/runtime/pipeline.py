"""The user-facing SLAM pipeline, batched offline path: pcap + INS log →
device full SLAM → landmarks, graph solve, tiled map, corrected
trajectory.

Port of veloslam_tpu/runtime/pipeline.py::SlamPipeline's batched path:

    run_offline_batched(pcap, ins)   read the pcap, ground the packet
                                     times to GPS from its position
                                     packets, stream every batch through
                                     runtime.fullslam.FullSlam on the
                                     device, queue the end-of-stream sweep
                                     (closures, pose graph, trajectory
                                     correction), read it back once and
                                     mirror it into the host graph;
    finalize()                       post landmarks from every keyframe
                                     scan, the landmark-Schur graph solve
                                     with an outlier trim and one re-solve,
                                     the tiled map rebuilt at the solved
                                     poses, the per-frame trajectory
                                     corrected by each keyframe's motion.

The graph solves and the map's voxelization run on the pipeline's device
(`device`, "cuda" unless the caller asks for "cpu"); the landmark
association and the map's tile merge are host numpy, as in the JAX
package.  Stage names are the JAX package's: the card's work is queued
asynchronously, so "device_finalize_queue" is the sweep's enqueue time
and "device_sweep_readback" its execution and transfer.

Not ported yet (ROADMAP.md slice 3): the per-frame path (`run_offline`,
`process_packets`, FrameStore), `run_online`, the host closure sweep,
`update_map_incremental` and the checkpoints.  The JAX package's
`warmup_batched` and host-solve placement are TPU workarounds the port
does not need.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.core import se3, timesync
from veloslam_tpu_torch.core.timeline import PoseTrack, interpolate_poses_np
from veloslam_tpu_torch.decode import calibration as calib_mod
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.graph import landmark_assoc as la
from veloslam_tpu_torch.graph import pcg
from veloslam_tpu_torch.graph.posegraph import GraphArrays, PoseGraph
from veloslam_tpu_torch.io import packets as pk
from veloslam_tpu_torch.io.pcap import read_lidar_packets, read_position_packets
from veloslam_tpu_torch.map.voxelmap import VoxelMap
from veloslam_tpu_torch.runtime.fullslam import FullSlam
from veloslam_tpu_torch.utils.profiling import StageTimers


def sweep_budget(eng, floor: int) -> int:
    """End-of-stream closure-verification budget (SlamPipeline.
    _sweep_budget): ~half the engine's frame estimate for the recording
    (≈ 2 candidates per keyframe at 2 m spacing), power-of-two bucketed,
    at least `floor`, capped at 256; the ring capacity stands in when the
    engine has no estimate."""
    est = getattr(eng, "_est_frames", None) or eng.ring.capacity
    b = 1 << max(int(math.ceil(math.log2(max(est // 2, 1)))), 0)
    return int(min(max(floor, b), 256))


def crop_graph(arrays: GraphArrays, n_poses: int, n_landmarks: int = 0,
               n_edges: int = 0, n_obs: int = 0
               ) -> Tuple[int, GraphArrays, int]:
    """Crop GraphArrays to power-of-two buckets covering the occupied
    prefix (SlamPipeline._crop_graph): the dense solve scales with
    capacity, not count.  The bucket floors (128 poses, 64 landmarks, 512
    edges, 512 observations) are the JAX package's, so both solve the
    same padded system.  Returns (Kc, cropped, Mc)."""
    def b(n, lo=32):
        n = max(int(n), 1)
        return max(lo, 1 << int(np.ceil(np.log2(n))))
    Kc = min(b(n_poses, 128), arrays.q.shape[0])
    Mc = min(b(max(n_landmarks, 1), 64), arrays.l_pos.shape[0])
    Ec = min(b(max(n_edges, 1), 512), arrays.e_i.shape[0])
    Oc = min(b(max(n_obs, 1), 512), arrays.o_i.shape[0])
    return Kc, arrays._replace(
        q=arrays.q[:Kc], t=arrays.t[:Kc],
        e_i=arrays.e_i[:Ec], e_j=arrays.e_j[:Ec],
        e_q=arrays.e_q[:Ec], e_t=arrays.e_t[:Ec],
        e_info=arrays.e_info[:Ec], e_valid=arrays.e_valid[:Ec],
        l_pos=arrays.l_pos[:Mc],
        o_i=arrays.o_i[:Oc], o_l=arrays.o_l[:Oc],
        o_z=arrays.o_z[:Oc], o_info=arrays.o_info[:Oc],
        o_valid=arrays.o_valid[:Oc]), Mc


@dataclasses.dataclass
class FrameResult:
    start_us: int
    pose_q: np.ndarray
    pose_t: np.ndarray
    n_points: int
    n_matched: int
    mean_error: float
    registered: bool


class SlamPipeline:
    def __init__(self, config: Optional[SlamConfig] = None,
                 spill_dir: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlamPipeline runs on a CUDA card by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU (the kernels' plain versions)")
        self.cfg = config or SlamConfig()
        sc = self.cfg.sensor
        self.calib = (calib_mod.from_xml(sc.calibration_path)
                      if sc.calibration_path
                      else calib_mod.default_for(sc.model))
        self.dcalib = DeviceCalib.from_host(self.calib, device=self.device,
                                            enabled=sc.enabled_lasers())
        self.track = PoseTrack()                 # INS prior track
        self.map = VoxelMap(self.cfg.map, spill_dir=spill_dir,
                            device=self.device)
        self.graph = PoseGraph(max_poses=self.cfg.graph.max_keyframes)
        self.keyframe_scans: List[Tuple[np.ndarray, np.ndarray]] = []
        self.keyframe_times: List[int] = []
        # Keyframe pose at creation (immutable): the per-frame trajectory
        # was recorded against these; finalize() corrects it by the total
        # keyframe motion since creation.
        self._kf_pose_at_creation: List[Tuple[np.ndarray, np.ndarray]] = []
        self.trajectory: List[FrameResult] = []
        self.timers = StageTimers()
        self.closures: List[Tuple[int, int]] = []
        self._map_deferred = False
        self._landmarks_added = False
        self._ring_full = False
        self._dense_cov: Optional[float] = None
        # Sensor position-packet (port 8308) side channel: GPS grounding
        # of the HDL hour clock + PPS health.
        self.gps_health = {
            "position_count": 0, "grounded": False, "pps_status": None,
            "last_fix_lat_deg": None, "last_fix_lon_deg": None,
            "ground_correction_us": None,
        }

    # --- inputs -------------------------------------------------------------

    def feed_ins_txt(self, path: str) -> None:
        """Load the INS text log format as the prior track."""
        ins = pk.read_ins_txt(path)
        for i in range(len(ins["t_us"])):
            q = se3.euler_deg_to_quat_np(
                ins["roll_deg"][i], ins["pitch_deg"][i], ins["yaw_deg"][i])
            t3 = np.array([ins["pos_xy"][i, 0], ins["pos_xy"][i, 1], 0.0])
            yaw = np.deg2rad(ins["yaw_deg"][i])
            v = ins["speed"][i] * np.array([np.cos(yaw), np.sin(yaw), 0.0])
            self.track.add(int(ins["t_us"][i]), q=q, t=t3, v=v)

    def feed_ins_pose(self, t_us: int, q, t, v=None) -> None:
        self.track.add(int(t_us), q=np.asarray(q), t=np.asarray(t), v=v)

    def _ground_offline_times(self, pcap_path: str, pkts: np.ndarray,
                              rec_times: np.ndarray) -> np.ndarray:
        """Offline GPS grounding: when the pcap carries position packets
        with a valid $GPRMC fix, resolve the LiDAR packets' µs-into-hour
        stamps against GPS UTC instead of trusting capture timestamps.
        Falls back to the pcap record times when no fix exists."""
        if len(pkts) == 0:
            return rec_times
        pos_pkts, _ = read_position_packets(pcap_path)
        base = None
        h = self.gps_health
        for raw in pos_pkts:
            info = pk.unpack_position_packet(raw.tobytes())
            h["position_count"] += 1
            h["pps_status"] = info["pps_status_str"]
            rmc = info["rmc"]
            if rmc is not None and rmc["valid"]:
                h["last_fix_lat_deg"] = rmc["lat_deg"]
                h["last_fix_lon_deg"] = rmc["lon_deg"]
                if base is None:
                    base = rmc["utc_us"] - info["us_into_hour"]
                    h["grounded"] = True
        if base is None:
            return rec_times
        gps = pk.decode_lidar_packets_np(pkts)["gps_us"]
        resolved = timesync.resolve_hour_stamps(gps, base,
                                                ref_us=int(rec_times[0]))
        h["ground_correction_us"] = int(resolved[0] - rec_times[0])
        return resolved

    # --- the batched offline run --------------------------------------------

    def run_offline_batched(self, pcap_path: str,
                            ins_path: Optional[str] = None,
                            max_packets: Optional[int] = None,
                            batch: int = 8192,
                            defer_map: bool = False) -> Dict:
        """Full SLAM at bulk-replay rate: odometry, keyframe selection and
        scan-context descriptors run on the device (runtime.fullslam)
        with no mid-stream readback, and the end-of-stream sweep (closure
        proposal, batched verification, pose-graph solve, per-frame
        correction) is queued before the one readback.  The host then
        mirrors the solved graph and builds the tiled map (left to
        `finalize()` with `defer_map`).  Frame payloads are not kept."""
        if ins_path:
            self.feed_ins_txt(ins_path)
        pkts, times, _ = read_lidar_packets(pcap_path, max_packets)
        times = self._ground_offline_times(pcap_path, pkts, times)
        if len(pkts) == 0:
            return self.results()
        sc = self.cfg.sensor
        rc = self.cfg.registration
        gc = self.cfg.graph
        with self.timers.stage("slam_batched"):
            eng = FullSlam(self.dcalib, model=sc.model,
                           voxel_size=rc.voxel_size,
                           map_capacity=rc.rolling_map_capacity,
                           reg_points=rc.max_points,
                           reg_iterations=rc.max_iterations,
                           kf_capacity=gc.max_keyframes,
                           kf_dist_m=gc.keyframe_translation_m,
                           kf_rot_deg=gc.keyframe_rotation_deg,
                           reassociate_every=rc.reassociate_every,
                           map_decay=rc.map_decay,
                           frame_rate_hz=sc.rpm / 60.0)
            eng.run_device(pkts, times, self.track, batch=batch)
        return self._finalize_batched_engine(eng, defer_map=defer_map)

    def _finalize_batched_engine(self, eng: FullSlam,
                                 defer_map: bool = False) -> Dict:
        """Queue the device sweep, read everything back once, mirror the
        solved graph into the pipeline bookkeeping."""
        rc = self.cfg.registration
        gc = self.cfg.graph
        with self.timers.stage("device_finalize_queue"):
            dev = eng.finalize_device(
                min_score=gc.sc_min_score,
                radius=gc.loop_closure_radius_m,
                min_gap=gc.loop_closure_min_gap,
                max_candidates=sweep_budget(
                    eng, gc.max_closure_candidates_per_sweep),
                use_scan_context=gc.use_scan_context,
                gn_iterations=gc.gn_iterations,
                odom_info=gc.odom_edge_info,
                closure_info=gc.closure_edge_info,
                voxel_size=gc.verify_voxel_m,
                capacity=rc.scan_voxel_capacity)
        with self.timers.stage("device_sweep_readback"):
            host = {k: v.cpu().numpy() for k, v in dev.items()}
            # The ring is capacity-sized (1024 × 8192 points, ~100 MB at
            # the defaults): read only the occupied rows.
            n_kf = int(host["kf_n"])
            host["kf_pts"] = eng.ring.pts[:n_kf].cpu().numpy()
            host["kf_msk"] = eng.ring.msk[:n_kf].cpu().numpy()
            host["min_dense_cov"] = float(eng.state.min_dense_cov)
        return self._mirror_device_results(eng, host, defer_map=defer_map)

    def _mirror_device_results(self, eng: FullSlam, host: Dict,
                               defer_map: bool = False) -> Dict:
        """Mirror the transferred device-finalize results into the host
        graph, keyframe lists and per-frame trajectory."""
        gc = self.cfg.graph
        t0 = eng._stream_t0_us or 0
        n_frames = int(host["n_frames"])
        n_kf = int(host["kf_n"])
        self._dense_cov = host["min_dense_cov"]
        if self._dense_cov < 0.999:
            warnings.warn(
                f"dense correspondence window covered only "
                f"{self._dense_cov:.1%} of usable map voxels at some "
                f"point — scan may have outrun the index box; "
                f"registration fell back to priors there", RuntimeWarning)
        self._ring_full = bool(n_kf >= eng.ring.capacity)
        if self._ring_full:
            warnings.warn(
                f"keyframe ring saturated at {eng.ring.capacity}: "
                f"keyframes beyond capacity were dropped (drive longer "
                f"than ~{eng.ring.capacity * eng.kf_dist_m:.0f} m)",
                RuntimeWarning)
        # float64 before the epoch shift (f32 + 1.7e15 µs would round).
        ft = (host["traj_time"][:n_frames].astype(np.float64) * 1e6
              + t0).astype(np.int64)
        for i in range(n_frames):
            self.trajectory.append(FrameResult(
                start_us=int(ft[i]), pose_q=host["traj_q"][i],
                pose_t=host["traj_t"][i], n_points=-1, n_matched=-1,
                mean_error=float("nan"), registered=True))
        kf_times = (host["kf_time_rel_s"][:n_kf].astype(np.float64) * 1e6
                    + t0).astype(np.int64)
        for k in range(n_kf):
            sq = host["solved_q"][k].copy()
            st3 = host["solved_t"][k].copy()
            self.graph.add_pose(sq, st3)
            self.keyframe_scans.append((host["kf_pts"][k],
                                        host["kf_msk"][k]))
            self.keyframe_times.append(int(kf_times[k]))
            self._kf_pose_at_creation.append((sq.copy(), st3.copy()))
            if k > 0:
                self.graph.add_edge(k - 1, k, host["rel_q"][k - 1],
                                    host["rel_t"][k - 1],
                                    info=gc.odom_edge_info)
        for c in range(len(host["accept"])):
            if host["accept"][c]:
                i, j = int(host["cand_i"][c]), int(host["cand_j"][c])
                self.graph.add_edge(i, j, host["meas_q"][c],
                                    host["meas_t"][c],
                                    info=gc.closure_edge_info)
                self.closures.append((i, j))
        # The tiled map is built from the keyframe scans at the solved
        # poses (the rolling device grid was odometry's working set).
        # With `defer_map` the build is left to finalize(), which rebuilds
        # after its solves anyway.
        self._map_deferred = defer_map
        if not defer_map:
            with self.timers.stage("map_build"):
                self.rebuild_map()
        return self.results()

    # --- graph solves and the map ------------------------------------------

    def _solve_graph(self) -> None:
        """Pose-only solve of the host graph on the pipeline's device (a
        multi-device session overrides the solve primitives)."""
        g = self.graph
        Kc, cropped, _ = crop_graph(g.arrays(self.device), g.n_poses, 0,
                                    g.n_edges, 0)
        out, _ = pcg.solve_auto(cropped, max_poses=Kc,
                                iterations=self.cfg.graph.gn_iterations)
        g.update_from(out.q[:g.n_poses].cpu().numpy(),
                      out.t[:g.n_poses].cpu().numpy())

    def _solve_graph_landmarks(self) -> None:
        """Landmark-aided solve (Schur-eliminated landmarks) of the host
        graph on the pipeline's device."""
        g = self.graph
        Kc, cropped, Mc = crop_graph(g.arrays(self.device), g.n_poses,
                                     g.n_landmarks, g.n_edges, g.n_obs)
        out, _ = pcg.solve_auto_landmarks(
            cropped, max_poses=Kc, max_landmarks=Mc,
            iterations=self.cfg.graph.gn_iterations)
        g.update_from(out.q[:g.n_poses].cpu().numpy(),
                      out.t[:g.n_poses].cpu().numpy(),
                      out.l_pos[:g.n_landmarks].cpu().numpy())

    def _integrate_scan(self, pts_world: np.ndarray, mask: np.ndarray,
                        center: np.ndarray, map_obj=None,
                        sign: float = 1.0) -> None:
        """Scan → map integration (a multi-device session overrides it to
        keep only its own tiles)."""
        (map_obj or self.map).integrate_points(pts_world, mask,
                                               center=center, sign=sign)

    def _tile_filter(self):
        """Tile-ownership predicate for batched map integration (None =
        keep everything; a multi-device session returns its own)."""
        return None

    def rebuild_map(self) -> None:
        """Re-integrate all keyframe scans at their optimized graph poses
        into a fresh map."""
        q, t = self.graph.poses()
        fresh = VoxelMap(self.cfg.map, spill_dir=self.map.spill_dir,
                         device=self.device)
        K = len(self.keyframe_scans)
        if K:
            fresh.integrate_scans_batch(
                np.stack([p for p, _ in self.keyframe_scans]),
                np.stack([m for _, m in self.keyframe_scans]),
                q[:K], t[:K], tile_filter=self._tile_filter())
        self.map = fresh

    def _correct_trajectory(self, old_q: np.ndarray, old_t: np.ndarray
                            ) -> None:
        """Propagate a graph solve to the per-frame trajectory: the world-
        frame correction C_k = T_new_k ∘ T_old_k⁻¹ of each keyframe is
        interpolated (slerp/lerp over keyframe times) at every frame time
        and left-composed onto the frame's pose (host numpy)."""
        if not self.trajectory or self.graph.n_poses < 1:
            return
        new_q, new_t = self.graph.poses()
        K = len(new_q)
        inv_q, inv_t = se3.inverse_np(old_q[:K], old_t[:K])
        corr_q, corr_t = se3.compose_np(new_q, new_t, inv_q, inv_t)
        kt = np.asarray(self.keyframe_times[:K], np.float64)
        ft = np.asarray([r.start_us for r in self.trajectory], np.float64)
        anchor = kt[0]
        cq, ct = interpolate_poses_np(
            (kt - anchor) * 1e-6, corr_q, corr_t,
            np.zeros((K, 3), np.float32), (ft - anchor) * 1e-6)
        fq = np.stack([r.pose_q for r in self.trajectory])
        ftl = np.stack([r.pose_t for r in self.trajectory])
        q_np, t_np = se3.compose_np(cq, ct, fq, ftl)
        q_np = (q_np / np.linalg.norm(q_np, axis=-1, keepdims=True)
                ).astype(np.float32)
        t_np = t_np.astype(np.float32)
        for i, r in enumerate(self.trajectory):
            r.pose_q, r.pose_t = q_np[i], t_np[i]

    def add_landmark_observations(self) -> Tuple[int, int]:
        """Extract post landmarks from every keyframe scan and add them as
        pose-landmark observations (graph.landmark_assoc).  Runs once;
        returns (n_landmarks, n_observations) added."""
        if self._landmarks_added or not self.keyframe_scans:
            return 0, 0
        self._landmarks_added = True
        gc = self.cfg.graph
        with self.timers.stage("landmarks"):
            det = la.extract_scan_posts_batch(
                np.stack([p for p, _ in self.keyframe_scans]),
                np.stack([m for _, m in self.keyframe_scans]))
            return la.associate_and_add(
                self.graph, det, radius=gc.landmark_cluster_radius_m,
                min_observations=gc.landmark_min_observations,
                obs_info=gc.landmark_obs_info)

    def finalize(self) -> Dict:
        """End-of-session pass after run_offline_batched (whose closure
        sweep already ran on the device): landmark extraction and
        association, the graph solve (Schur-eliminated landmarks when
        present, an outlier trim and one re-solve), the map rebuild, the
        per-frame trajectory correction."""
        g = self.graph
        if self.cfg.graph.use_landmarks and self.keyframe_scans:
            self.add_landmark_observations()
        has_closures = g.n_edges > max(g.n_poses - 1, 0)
        if has_closures or g.n_obs > 0:
            with self.timers.stage("graph_solve"):
                if g.n_obs > 0:
                    self._solve_graph_landmarks()
                    # Huber bounds the influence of cross-associations
                    # but keeps them; at the solved state they separate
                    # by residual: trim them and solve once more.
                    trim = self.cfg.graph.landmark_trim_residual_m
                    if trim > 0 and g.trim_observations(trim):
                        self._solve_graph_landmarks()
                else:
                    self._solve_graph()
            with self.timers.stage("map_downdate"):
                self.rebuild_map()
            self._map_deferred = False
        if self._map_deferred:
            # Deferred batched-run map build with no solve this pass.
            with self.timers.stage("map_build"):
                self.rebuild_map()
            self._map_deferred = False
        # Correct the per-frame trajectory by each keyframe's total motion
        # since creation.
        if self._kf_pose_at_creation:
            old_q = np.stack([q for q, _ in self._kf_pose_at_creation])
            old_t = np.stack([t for _, t in self._kf_pose_at_creation])
            self._correct_trajectory(old_q, old_t)
            new_q, new_t = g.poses()
            self._kf_pose_at_creation = [
                (new_q[k].copy(), new_t[k].copy())
                for k in range(g.n_poses)]
        return self.results()

    # --- outputs ------------------------------------------------------------

    def results(self) -> Dict:
        traj_t = np.asarray([r.pose_t for r in self.trajectory])
        traj_q = np.asarray([r.pose_q for r in self.trajectory])
        times = np.asarray([r.start_us for r in self.trajectory], np.int64)
        return {
            "times_us": times,
            "positions": traj_t,
            "quaternions": traj_q,
            "registered_fraction": float(np.mean(
                [r.registered for r in self.trajectory]))
            if self.trajectory else 0.0,
            "n_frames": len(self.trajectory),
            "n_keyframes": self.graph.n_poses,
            "n_closures": len(self.closures),
            "n_landmarks": self.graph.n_landmarks,
            "n_landmark_obs": self.graph.n_obs,
            "keyframe_positions": self.graph.poses()[1].copy(),
            "keyframe_times_us": np.asarray(self.keyframe_times, np.int64),
            "map_patches": self.map.n_patches,
            "ring_full": self._ring_full,
            "dense_index_min_coverage": self._dense_cov,
            "timing": self.timers.summary(),
            "gps_health": dict(self.gps_health),
        }
