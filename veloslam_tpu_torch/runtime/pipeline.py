"""The user-facing SLAM pipeline: pcap + INS log → trajectory, keyframe
pose graph with loop closures and landmarks, tiled map.

Port of veloslam_tpu/runtime/pipeline.py::SlamPipeline: two offline
paths and live mode:

    run_offline(pcap, ins)           the per-frame loop (slam_run's
                                     default mode): each packet batch is
                                     decoded, motion-compensated and
                                     assembled into frames on the device;
                                     per completed frame the host
                                     localizes it against the map ROI
                                     (GICP on the device), integrates it
                                     into the tiled map, adds keyframes,
                                     and every `keyframes_per_closure_
                                     sweep` keyframes verifies closure
                                     candidates, solves the graph and
                                     downdates the moved keyframes' map
                                     contributions; frames go to the
                                     FrameStore with their pcap offsets;
    run_offline_batched(pcap, ins)   full SLAM at bulk-replay rate: every
                                     batch through runtime.fullslam.
                                     FullSlam on the device, the end-of-
                                     stream sweep (closures, pose graph,
                                     trajectory correction) queued before
                                     one readback, mirrored into the host
                                     graph;
    run_online(ports)                live UDP ingest (LiDAR, INS and
                                     position packets) until a duration
                                     passes or the stream goes idle, in
                                     fixed packets_per_batch batches:
                                     process_packets per batch, or with
                                     fast=True the FullSlam stream and
                                     its device finalize;
    finalize()                       a last host closure sweep (per-frame
                                     runs only), post landmarks from every
                                     keyframe scan, the landmark-Schur
                                     graph solve with an outlier trim and
                                     one re-solve, the tiled map rebuilt
                                     at the solved poses, the per-frame
                                     trajectory corrected by each
                                     keyframe's motion.

The device work runs on the pipeline's device (`device`, "cuda" unless
the caller asks for "cpu"); the per-frame pose bookkeeping, the ROI
assembly, the closure proposal and accept decision, the landmark
association and the map's tile merge are host work, as in the JAX
package (the small pose math in float32 torch on the CPU).  Stage names
are the JAX package's, with more stages nested in and beside them so that
the per-frame path spends its time inside named stages, and each of its
host-card synchronizations is a `sync.<stage>` span
(utils/profiling.py); the card's work is queued asynchronously, so a
stage's time is its enqueue time unless the timers synchronize.

Registration follows `RegistrationConfig.method`: point-to-plane GICP,
D2D or NDT on the per-frame path, GICP on the batched one.  The JAX
package's `warmup*` and host-solve placement are TPU workarounds the port
does not need.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.core import se3, timesync
from veloslam_tpu_torch.core.timeline import (PoseTrack, interpolate_poses,
                                              interpolate_poses_np)
from veloslam_tpu_torch.decode import calibration as calib_mod
from veloslam_tpu_torch.decode.decode import (DeviceCalib,
                                              apply_dual_return_filter,
                                              compensate, decode_packets)
from veloslam_tpu_torch.decode.frames import AssemblyCarry, assemble_frames
from veloslam_tpu_torch.graph import landmark_assoc as la
from veloslam_tpu_torch.graph import loopclosure, pcg
from veloslam_tpu_torch.graph import scancontext as sc_mod
from veloslam_tpu_torch.graph.posegraph import GraphArrays, PoseGraph
from veloslam_tpu_torch.io import packets as pk
from veloslam_tpu_torch.io import udp
from veloslam_tpu_torch.io.ins import InsConverter
from veloslam_tpu_torch.io.pcap import (PcapReader, read_lidar_packets,
                                        read_position_packets)
from veloslam_tpu_torch.map.voxelmap import VoxelMap
from veloslam_tpu_torch.registration import d2d, gicp, ndt
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.cudagraphs import GicpGraphs
from veloslam_tpu_torch.runtime.framestore import FrameStore
from veloslam_tpu_torch.runtime.fullslam import FullSlam
from veloslam_tpu_torch.runtime.odometry import (packets_per_second,
                                                 slots_for_batch)
from veloslam_tpu_torch.utils import profiling
from veloslam_tpu_torch.utils.profiling import StageTimers, sync_span


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


class FrameRegistration(NamedTuple):
    """One frame's scan-to-map registration, read back to the host."""

    pose: se3.Pose          # CPU float32 tensors (4,), (3,)
    n_matched: int
    mean_error: float


def _host_pose(q, t) -> se3.Pose:
    """A pose as CPU float32 tensors (the per-frame pose bookkeeping is
    float32 host math, as the JAX package's jnp on its host arrays)."""
    return se3.Pose(torch.as_tensor(np.asarray(q, np.float32)),
                    torch.as_tensor(np.asarray(t, np.float32)))


def _np(x: torch.Tensor) -> np.ndarray:
    with sync_span(x):
        return x.detach().cpu().numpy().copy()


def _recorded(method):
    """An entry point of SlamPipeline, run with the pipeline's timers
    bound as the recorder (utils.profiling.recording) of the stages and
    sync spans of code that has no pipeline at hand."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with profiling.recording(self.timers):
            return method(self, *args, **kwargs)
    return run


class SlamPipeline:
    def __init__(self, config: Optional[SlamConfig] = None,
                 spill_dir: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlamPipeline runs on a CUDA card by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU (the kernels' plain versions)")
        self.timers = StageTimers()
        with profiling.recording(self.timers), \
                self.timers.stage("pipeline_init"):
            self._init(config, spill_dir)

    def _init(self, config: Optional[SlamConfig],
              spill_dir: Optional[str]) -> None:
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
        self.frames = FrameStore(self.cfg.pipeline.frame_cache_capacity,
                                 spill_dir=spill_dir)
        self.graph = PoseGraph(max_poses=self.cfg.graph.max_keyframes)
        self.keyframe_scans: List[Tuple[np.ndarray, np.ndarray]] = []
        self.keyframe_descs: List[np.ndarray] = []   # scan-context (R, S)
        self.keyframe_times: List[int] = []
        # Pose each keyframe's scan was integrated into the map with, and
        # how ("stream": per-frame integrate_points; "batch":
        # integrate_scans_batch): a downdate replays the same path at
        # that pose, so the subtraction is the exact inverse.
        self._kf_map_pose: List[Tuple[np.ndarray, np.ndarray]] = []
        self._kf_integrated_via: List[str] = []
        # Keyframe pose at creation (immutable): the per-frame trajectory
        # was recorded against these; finalize() corrects it by the total
        # keyframe motion since creation.
        self._kf_pose_at_creation: List[Tuple[np.ndarray, np.ndarray]] = []
        self.trajectory: List[FrameResult] = []
        self.closures: List[Tuple[int, int]] = []
        self._carry = AssemblyCarry.init(sc.n_lasers,
                                         sc.max_firings_per_frame,
                                         device=self.device)
        self._open_start_abs: Optional[float] = None
        # pcap offset of the packet at or before the open frame's start
        self._open_frame_offset: Optional[int] = None
        self._gps_base: Optional[int] = None   # grounded HDL hour base
        self.frames.redecoder = self._redecode_frame
        self._last_ins: Optional[se3.Pose] = None
        self._last_est: Optional[se3.Pose] = None
        # The per-frame GICP chain's CUDA graphs, captured at the first
        # frame registered with them (_gicp_graphs).
        self._reg_graphs: Optional[GicpGraphs] = None
        self._kf_count_at_last_close = 0
        self._device_closed = False
        self._map_deferred = False
        self._landmarks_added = False
        self._ring_full = False
        self._dense_cov: Optional[float] = None
        # INS-port auxiliary messages (live mode's handle_ins_datagram):
        # RawINS samples (t_us, imu_status, accel_raw) and the counters;
        # an offline run returns them as initialised.
        self.imu_log: List[Tuple[int, int, Tuple[int, int, int]]] = []
        self.ins_health = {
            "inspva_count": 0, "rawins_count": 0, "bestgps_count": 0,
            "unknown_count": 0, "last_imu_status": None,
            "last_gps_solution": None, "last_gps_status": None,
            "last_diff_age": None,
        }
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
        # The hour base including the ref_us hour shift, so re-decodes
        # reproduce the same stamps.
        self._gps_base = int(resolved[0]) - int(gps[0])
        h["ground_correction_us"] = int(resolved[0] - rec_times[0])
        return resolved

    # --- the per-frame offline run: ingest -----------------------------------

    def _decode_batch(self, pkts: np.ndarray, times_us: np.ndarray):
        """Decode + dual-return filter + INS compensation of one batch on
        the device.  Returns (dec, xyz_world, rel_s, anchor_us)."""
        sc = self.cfg.sensor
        pc = self.cfg.pipeline
        dev = self.device
        anchor = int(times_us[0])
        with self.timers.stage("batch_prep"), sync_span(dev):
            rel = torch.as_tensor(
                ((times_us - anchor) * 1e-6).astype(np.float32), device=dev)
        with self.timers.stage("decode"):
            with sync_span(dev):
                pkts_dev = torch.as_tensor(pkts, device=dev)
            dec = decode_packets(pkts_dev, self.dcalib, model=sc.model,
                                 crop_region=sc.crop_region,
                                 crop_inside=sc.crop_inside,
                                 points_skip=pc.points_skip)
            if sc.dual_return_filter is not None:
                dec = apply_dual_return_filter(dec, sc.dual_return_filter)
        if len(self.track) > 0:
            with self.timers.stage("compensate"):
                w = self.track.window(int(times_us[0]), int(times_us[-1]),
                                      anchor_us=anchor)
                track = []
                for k in ("rel_s", "q", "t", "v"):
                    with sync_span(dev):
                        track.append(torch.as_tensor(w[k], device=dev))
                xyz_w, _ = compensate(
                    dec, rel, *track,
                    per_packet=(pc.compensation == "per_packet"))
        else:
            xyz_w = dec.xyz
        return dec, xyz_w, rel, anchor

    def _assemble(self, pkts, times_us, carry, open_abs):
        """Decode a batch and assemble its frames from `carry` (the open
        frame started at `open_abs` µs, None before the stream's first
        frame).  Returns (frames as numpy dicts, their start times in the
        batch's base (float32), the new carry, the open frame's start in
        the batch's base, the batch anchor µs): two host reads."""
        sc = self.cfg.sensor
        dec, xyz_w, rel, anchor = self._decode_batch(pkts, times_us)
        # A fill, not a copy from host memory (which would synchronize).
        carry_start = torch.full(
            (), 0.0 if open_abs is None else (open_abs - anchor) * 1e-6,
            dtype=torch.float32, device=self.device)
        with self.timers.stage("assemble"):
            fb, n_done, starts, carry, open_start = assemble_frames(
                dec, xyz_w, rel, carry, carry_start, model=sc.model,
                n_beams=sc.n_lasers, max_firings=sc.max_firings_per_frame)
            head = torch.cat([n_done.to(torch.float32)[None], starts,
                              open_start[None]])
            with sync_span(head):
                head = head.cpu().numpy()
        n = int(head[0])
        with self.timers.stage("frames_to_host"):
            frames = self._frame_dicts(fb, n)
        return frames, head[1:1 + n], carry, head[-1], anchor

    @staticmethod
    def _frame_dicts(fb, n: int) -> List[Dict]:
        """The first n frame slots as numpy frame dicts (xyz, mask,
        intensity, rel_s, azimuth), read back in one transfer."""
        if n == 0:
            return []
        S, L, F = fb.mask.shape
        parts = (fb.xyz[:n].reshape(n, -1), fb.mask[:n].reshape(n, -1),
                 fb.intensity[:n].reshape(n, -1), fb.rel_s[:n].reshape(n, -1),
                 fb.azimuth[:n].reshape(n, -1))
        host = torch.cat([x.to(torch.float32) for x in parts], 1)
        with sync_span(host):
            host = host.cpu().numpy()
        LF = L * F
        out = []
        for k in range(n):
            row = host[k]
            out.append({
                "xyz": row[:3 * LF].reshape(L, F, 3),
                "mask": row[3 * LF:4 * LF].reshape(L, F) > 0.5,
                "intensity": row[4 * LF:5 * LF].reshape(L, F),
                "rel_s": row[5 * LF:6 * LF].reshape(L, F),
                "azimuth": row[6 * LF:7 * LF].reshape(L, F),
            })
        return out

    @_recorded
    def process_packets(self, pkts: np.ndarray, times_us: np.ndarray,
                        offsets: Optional[np.ndarray] = None,
                        pcap_path: Optional[str] = None) -> int:
        """Feed a batch of packets; returns frames completed.

        `offsets`/`pcap_path`: per-packet pcap byte offsets; when given,
        each completed frame's FrameStore entry records the offset of the
        packet at or before its start, so its payload can be re-decoded."""
        frames, starts, self._carry, open_start, anchor = self._assemble(
            pkts, times_us, self._carry, self._open_start_abs)
        rel_np = (times_us - anchor).astype(np.float64) * 1e-6
        for k, frame in enumerate(frames):
            start_us = int(anchor + float(starts[k]) * 1e6)
            source = None
            if offsets is not None and pcap_path is not None:
                if k == 0 and self._open_frame_offset is not None:
                    off = self._open_frame_offset
                else:
                    i = max(int(np.searchsorted(rel_np, starts[k],
                                                side="right")) - 1, 0)
                    off = int(offsets[i])
                source = (pcap_path, off)
            with self.timers.stage("frame"):
                self._handle_frame(frame, start_us, source=source)
        if offsets is not None and (frames
                                    or self._open_frame_offset is None):
            # The open frame began within this batch (a wrap completed the
            # previous frame here) or this is the stream start; otherwise
            # its first packet lives in an earlier batch and the recorded
            # offset stands.
            i = max(int(np.searchsorted(rel_np, float(open_start),
                                        side="right")) - 1, 0)
            self._open_frame_offset = int(offsets[i])
        self._open_start_abs = anchor + float(open_start) * 1e6
        return len(frames)

    def _redecode_frame(self, source, start_us: int) -> Optional[Dict]:
        """Re-decode ONE frame's payload from its pcap byte offset: seek,
        decode forward until the frame whose start matches, return it.
        Uses the live INS track for motion compensation, so a resumed
        session reproduces the original frame; never touches the live
        assembly carry."""
        pcap_path, offset = source
        sc = self.cfg.sensor
        B = self.cfg.pipeline.packets_per_batch
        per_rev = packets_per_second(sc.model) / (sc.rpm / 60.0)
        need = int(per_rev * 2.5) + 64
        pkts_l, times_l = [], []
        with PcapReader(pcap_path) as r:
            r.seek(int(offset))
            for payload, t_us, _ in r:
                if len(payload) != C.HDL_PACKET_BYTES:
                    continue
                pkts_l.append(payload)
                times_l.append(t_us)
                if len(pkts_l) >= need:
                    break
        if not pkts_l:
            return None
        arr = np.frombuffer(b"".join(pkts_l), np.uint8).reshape(
            len(pkts_l), C.HDL_PACKET_BYTES)
        times = np.asarray(times_l, np.int64)
        if self._gps_base is not None:
            gps = pk.decode_lidar_packets_np(arr)["gps_us"]
            times = timesync.resolve_hour_stamps(gps, self._gps_base,
                                                 ref_us=int(times[0]))
        tail = len(arr) % B
        if tail:
            arr = np.concatenate(
                [arr, pk.idle_lidar_packets(arr[-1], B - tail)])
            times = np.concatenate(
                [times, np.full(B - tail, times[-1], np.int64)])
        # Candidates within 500 µs of the recorded start; the fresh
        # carry's slot 0 may be a leading fragment of the previous
        # revolution with a nearby start, so the fullest candidate wins.
        carry = AssemblyCarry.init(sc.n_lasers, sc.max_firings_per_frame,
                                   device=self.device)
        open_abs: Optional[float] = None
        candidates = []
        for s in range(0, len(arr), B):
            frames, starts, carry, open_start, anchor = self._assemble(
                arr[s:s + B], times[s:s + B], carry, open_abs)
            passed = False
            for k, frame in enumerate(frames):
                f_start = anchor + float(starts[k]) * 1e6
                if abs(f_start - start_us) < 500.0:
                    candidates.append(frame)
                elif f_start > start_us:
                    passed = True
            if passed:
                break
            open_abs = anchor + float(open_start) * 1e6
        if not candidates:
            return None
        return max(candidates, key=lambda f: int(f["mask"].sum()))

    @_recorded
    def run_offline(self, pcap_path: str, ins_path: Optional[str] = None,
                    max_packets: Optional[int] = None) -> Dict:
        """Drive the whole pcap through the per-frame pipeline, in
        `packets_per_batch` batches (the last padded with idle packets).
        HDL timestamps are GPS-grounded from the pcap's position packets
        when present."""
        B = self.cfg.pipeline.packets_per_batch
        with self.timers.stage("read_inputs"):
            if ins_path:
                self.feed_ins_txt(ins_path)
            pkts, times, offs = read_lidar_packets(pcap_path, max_packets)
            times = self._ground_offline_times(pcap_path, pkts, times)
            tail = len(pkts) % B
            if tail:
                # Idle packets (no returns, frozen azimuth) so the frames
                # at the end of the recording are not dropped.
                pkts = np.concatenate(
                    [pkts, pk.idle_lidar_packets(pkts[-1], B - tail)])
                times = np.concatenate(
                    [times, np.full(B - tail, times[-1], np.int64)])
                offs = np.concatenate(
                    [offs, np.full(B - tail, offs[-1], np.int64)])
        for s in range(0, len(pkts), B):
            self.process_packets(pkts[s:s + B], times[s:s + B],
                                 offsets=offs[s:s + B], pcap_path=pcap_path)
        return self.results()

    # --- the batched offline run --------------------------------------------

    @_recorded
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
        `finalize()` with `defer_map`).  Correspondences come from the
        map's dilated dense index, or with use_dense_index=False from the
        exact binary-search lookup.  Frame payloads are not kept."""
        with self.timers.stage("read_inputs"):
            if ins_path:
                self.feed_ins_txt(ins_path)
            pkts, times, _ = read_lidar_packets(pcap_path, max_packets)
            times = self._ground_offline_times(pcap_path, pkts, times)
        if len(pkts) == 0:
            return self.results()
        with self.timers.stage("slam_batched"):
            eng = self._full_slam()
            eng.run_device(pkts, times, self.track, batch=batch)
        return self._finalize_batched_engine(eng, defer_map=defer_map)

    def _full_slam(self) -> FullSlam:
        """The device full-SLAM engine of this pipeline's config."""
        sc = self.cfg.sensor
        rc = self.cfg.registration
        gc = self.cfg.graph
        return FullSlam(self.dcalib, model=sc.model, n_beams=sc.n_lasers,
                        voxel_size=rc.voxel_size,
                        map_capacity=rc.rolling_map_capacity,
                        reg_points=rc.max_points,
                        reg_iterations=rc.max_iterations,
                        kf_capacity=gc.max_keyframes,
                        kf_dist_m=gc.keyframe_translation_m,
                        kf_rot_deg=gc.keyframe_rotation_deg,
                        use_pallas=rc.use_pallas,
                        use_dense=rc.use_dense_index,
                        reassociate_every=rc.reassociate_every,
                        map_decay=rc.map_decay, frame_rate_hz=sc.rpm / 60.0)

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
            self._kf_map_pose.append((sq, st3))
            self._kf_integrated_via.append("batch")
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
        self._kf_count_at_last_close = n_kf
        self._device_closed = True
        # The tiled map is built from the keyframe scans at the solved
        # poses (the rolling device grid was odometry's working set).
        # With `defer_map` the build is left to finalize(), which rebuilds
        # after its solves anyway.
        self._map_deferred = defer_map
        if not defer_map:
            with self.timers.stage("map_build"):
                self.rebuild_map()
        return self.results()

    # --- live mode -----------------------------------------------------------

    def handle_position_packet(self, raw: bytes,
                               clock: timesync.HdlClock) -> None:
        """One 512-byte position packet: PPS health and GPS grounding of
        the HDL hour clock (unpack_position_packet →
        HdlClock.maybe_ground)."""
        info = pk.unpack_position_packet(raw)
        h = self.gps_health
        h["position_count"] += 1
        h["pps_status"] = info["pps_status_str"]
        rmc = info["rmc"]
        if rmc is None or not rmc["valid"]:
            return
        h["last_fix_lat_deg"] = rmc["lat_deg"]
        h["last_fix_lon_deg"] = rmc["lon_deg"]
        if clock.maybe_ground(info["us_into_hour"], rmc["utc_us"]):
            h["grounded"] = True

    def handle_ins_datagram(self, raw: bytes,
                            conv: InsConverter) -> Optional[int]:
        """Dispatch one INS-port datagram on its message id: InsPVA →
        pose track (returns its timestamp µs); RawINS → IMU sample log and
        status; BestGPSPos → GPS solution health; anything else counts as
        unknown."""
        mid = pk.peek_message_id(raw)
        h = self.ins_health
        if mid == C.INS_MSG_INSPVA and len(raw) >= pk.INSPVA_BYTES:
            t_us, q, t3, v = conv.convert(pk.unpack_inspva(raw))
            self.feed_ins_pose(t_us, q, t3, v)
            h["inspva_count"] += 1
            return t_us
        if mid == C.INS_MSG_RAWINS and len(raw) >= pk.RAWINS_BYTES:
            msg = pk.unpack_rawins(raw)
            t_us = timesync.ins_timestamp_us(
                msg["week_number"], msg["milliseconds"],
                msg["week_number"], msg["milliseconds"] / 1e3)
            self.imu_log.append((t_us, msg["imu_status"],
                                 tuple(msg["accel_raw"])))
            h["rawins_count"] += 1
            h["last_imu_status"] = msg["imu_status"]
            return None
        if mid == C.INS_MSG_BESTGPSPOS and len(raw) >= pk.BESTGPSPOS_BYTES:
            msg = pk.unpack_bestgpspos(raw)
            h["bestgps_count"] += 1
            h["last_gps_solution"] = msg["solution"]
            h["last_gps_status"] = msg["gps_status"]
            h["last_diff_age"] = msg["diff_age"]
            return None
        h["unknown_count"] += 1
        return None

    def _live_engine(self, duration_s: Optional[float]) -> FullSlam:
        """The fast live mode's FullSlam, sized for the live batch (and,
        when the session's duration is known, presized so nothing regrows
        mid-stream)."""
        sc = self.cfg.sensor
        eng = self._full_slam()
        need = slots_for_batch(sc.model, self.cfg.pipeline.packets_per_batch,
                               frame_rate_hz=sc.rpm / 60.0)
        if need > eng.MAX_FRAMES_BATCH:
            eng.MAX_FRAMES_BATCH = need
        if duration_s is not None:
            fr = sc.rpm / 60.0 * 1.2
            eng.ensure_kf_capacity(int(duration_s * fr) + 8)
            eng.ensure_capacity(-(-(int(duration_s * fr)
                                    + 2 * eng.MAX_FRAMES_BATCH + 16)
                                  // 1024) * 1024)
        return eng

    @_recorded
    def run_online(self, lidar_port: int = None, ins_port: int = None,
                   position_port: int = None,
                   origin_llh_deg=None, duration_s: Optional[float] = None,
                   idle_timeout_s: float = 2.0,
                   on_ready=None, fast: bool = False) -> Dict:
        """Live acquisition: UDP LiDAR, INS and position-packet ingest
        until `duration_s` elapses or the stream is idle for
        `idle_timeout_s` (counted from the end of the last processing, and
        first from when the ports are bound and `on_ready` has returned).

        HDL µs-into-hour stamps resolve against GPS UTC once a position
        packet carries a valid $GPRMC fix, else against the first INS
        datagram's time, else (after 1 s without either) the wall clock;
        the base latches on first resolution, so LiDAR packets that
        arrive before it are held and replayed first.  Packets are
        consumed in fixed `packets_per_batch` batches, the trailing one
        padded with idle packets: per frame through `process_packets`, or
        with `fast=True` through the FullSlam stream
        (`StreamingOdometry.feed`, no readback while streaming) and, at
        the end, the same device finalize as run_offline_batched.
        `live_stats` on the result counts packets, batches, receiver drops
        and the per-batch feed time (enqueue time on the card)."""
        import time as _time

        lidar_port = lidar_port or C.LIDAR_DATA_PORT
        ins_port = ins_port or C.INS_PORT
        position_port = position_port or C.LIDAR_POSITION_PORT
        conv = InsConverter(origin_llh_deg)
        clock = timesync.HdlClock()
        B = self.cfg.pipeline.packets_per_batch
        buf: List[np.ndarray] = []          # resolved, not yet consumed
        buf_times: List[np.ndarray] = []
        pre_buf: List[np.ndarray] = []      # held until a time base exists
        pre_times: List[np.ndarray] = []
        first_ins_us: Optional[int] = None
        t_start = _time.monotonic()
        stats = {"lidar_packets": 0, "ins_datagrams": 0,
                 "position_packets": 0, "batches": 0,
                 "batch_feed_ms_max": 0.0, "batch_feed_ms_sum": 0.0}
        eng = self._live_engine(duration_s) if fast else None

        def consume(pkts_b: np.ndarray, times_b: np.ndarray) -> None:
            t0b = _time.perf_counter()
            if eng is not None:
                t0, t1 = int(times_b[0]), int(times_b[-1])
                eng.feed(pkts_b, times_b,
                         self.track.window(t0, t1, anchor_us=t0))
            else:
                self.process_packets(pkts_b, times_b)
            ms = (_time.perf_counter() - t0b) * 1e3
            stats["batches"] += 1
            stats["batch_feed_ms_sum"] += ms
            stats["batch_feed_ms_max"] = max(stats["batch_feed_ms_max"], ms)

        def resolve(pkts: np.ndarray, rx_times: np.ndarray) -> None:
            """Resolve a chunk's stamps (GPS base, else the first INS
            time, else its first receive time) into the batch buffer and
            consume every full batch."""
            nonlocal buf, buf_times
            ref = (None if clock.grounded
                   else (first_ins_us if first_ins_us is not None
                         else int(rx_times[0])))
            buf.append(pkts)
            buf_times.append(clock.resolve_batch(
                pk.decode_lidar_packets_np(pkts)["gps_us"], ref_time_us=ref))
            while sum(len(b) for b in buf) >= B:
                allp, allt = np.concatenate(buf), np.concatenate(buf_times)
                consume(allp[:B], allt[:B])
                buf, buf_times = [allp[B:]], [allt[B:]]

        with udp.UdpReceiver(lidar_port, C.HDL_PACKET_BYTES) as hdl_rx, \
                udp.UdpReceiver(ins_port, pk.INSPVA_BYTES,
                                variable=True) as ins_rx, \
                udp.UdpReceiver(position_port,
                                C.POSITION_PACKET_BYTES) as pos_rx:
            if on_ready is not None:
                on_ready()          # ports are bound; senders may start
            # The idle window opens here: building the fast engine, binding
            # the ports and on_ready may outlast it before any sender ran.
            last_rx = _time.monotonic()
            while True:
                if (duration_s is not None
                        and _time.monotonic() - t_start > duration_s):
                    break
                ins_pkts, ins_lens, _ = ins_rx.poll_var()
                for raw, ln in zip(ins_pkts, ins_lens):
                    t_us = self.handle_ins_datagram(raw[:ln].tobytes(), conv)
                    if t_us is not None and first_ins_us is None:
                        first_ins_us = t_us
                stats["ins_datagrams"] += len(ins_pkts)
                pos_pkts, _ = pos_rx.poll()
                for raw in pos_pkts:
                    self.handle_position_packet(raw.tobytes(), clock)
                stats["position_packets"] += len(pos_pkts)
                pkts, rx_times = hdl_rx.poll()
                stats["lidar_packets"] += len(pkts)
                if len(pkts):
                    # Resolving latches the hour base, so wait for a
                    # proper one: a wall-clock base latched just before
                    # the first INS datagram would put the LiDAR times
                    # and the pose track in different epochs.
                    if not (clock.grounded or first_ins_us is not None
                            or _time.monotonic() - t_start > 1.0):
                        pre_buf.append(pkts)
                        pre_times.append(rx_times)
                    else:
                        if pre_buf:          # the backlog first
                            pkts = np.concatenate(pre_buf + [pkts])
                            rx_times = np.concatenate(pre_times + [rx_times])
                            pre_buf, pre_times = [], []
                        resolve(pkts, rx_times)
                if len(pkts) or len(ins_pkts) or len(pos_pkts):
                    # Stamped after processing: a batch's compute time
                    # does not count toward the idle window.
                    last_rx = _time.monotonic()
                else:
                    if _time.monotonic() - last_rx > idle_timeout_s:
                        break
                    _time.sleep(0.005)
            if pre_buf:
                # The stream ended before a base arrived: the wall clock.
                resolve(np.concatenate(pre_buf), np.concatenate(pre_times))
            buffered = sum(len(b) for b in buf)
            if buffered > 0:
                # The trailing partial batch, padded with idle packets (no
                # returns, frozen azimuth) to the batch size.
                allp = np.concatenate(buf)
                allt = np.concatenate(buf_times)
                pad = B - buffered
                allp = np.concatenate(
                    [allp, pk.idle_lidar_packets(allp[-1], pad)])
                allt = np.concatenate(
                    [allt, np.full(pad, allt[-1], np.int64)])
                consume(allp, allt)
            stats["lidar_dropped"] = hdl_rx.dropped
            stats["ins_dropped"] = ins_rx.dropped
        if eng is not None and stats["batches"] > 0:
            self._finalize_batched_engine(eng)
        stats["batch_feed_ms_mean"] = round(
            stats.pop("batch_feed_ms_sum") / max(stats["batches"], 1), 3)
        res = self.results()
        res["live_stats"] = stats
        return res

    # --- graph solves and the map ------------------------------------------

    def _solve_graph(self) -> None:
        """Pose-only solve of the host graph on the pipeline's device,
        dense up to pcg.DENSE_MAX_POSES cropped poses and matrix-free PCG
        above (a multi-device session overrides the solve primitives)."""
        g = self.graph
        Kc, cropped, _ = crop_graph(g.arrays(self.device), g.n_poses, 0,
                                    g.n_edges, 0)
        out, _ = pcg.solve_auto(cropped, max_poses=Kc,
                                iterations=self.cfg.graph.gn_iterations)
        with sync_span(out.q):
            q = out.q[:g.n_poses].cpu().numpy()
        with sync_span(out.t):
            t = out.t[:g.n_poses].cpu().numpy()
        g.update_from(q, t)

    def _solve_graph_landmarks(self) -> None:
        """Landmark-aided solve (Schur-eliminated landmarks) of the host
        graph on the pipeline's device: the dense Schur solve up to
        pcg.DENSE_MAX_POSES cropped poses, the landmark-Schur PCG above."""
        g = self.graph
        Kc, cropped, Mc = crop_graph(g.arrays(self.device), g.n_poses,
                                     g.n_landmarks, g.n_edges, g.n_obs)
        out, _ = pcg.solve_auto_landmarks(
            cropped, max_poses=Kc, max_landmarks=Mc,
            iterations=self.cfg.graph.gn_iterations)
        with sync_span(out.q):
            q = out.q[:g.n_poses].cpu().numpy()
        with sync_span(out.t):
            t = out.t[:g.n_poses].cpu().numpy()
        with sync_span(out.l_pos):
            l_pos = out.l_pos[:g.n_landmarks].cpu().numpy()
        g.update_from(q, t, l_pos)

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

    # --- the per-frame SLAM loop ------------------------------------------

    def _ins_pose_at(self, t_us: int) -> Optional[se3.Pose]:
        """The INS pose at t_us (host float32), None without a track."""
        if len(self.track) == 0:
            return None
        w = self.track.window(t_us, t_us + 1, anchor_us=t_us)
        p = interpolate_poses(*(torch.as_tensor(w[k]) for k in
                                ("rel_s", "q", "t", "v")),
                              torch.zeros(1, dtype=torch.float32))
        return se3.Pose(p.q[0], p.t[0])

    def _subsample(self, frame: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """A frame's valid points, strided down to at most max_points,
        padded to max_points with their mask."""
        pts = frame["xyz"][frame["mask"]]
        P = self.cfg.registration.max_points
        if len(pts) > P:
            stride = int(np.ceil(len(pts) / P))
            pts = pts[::stride][:P]
        out = np.zeros((P, 3), np.float32)
        msk = np.zeros(P, bool)
        out[:len(pts)] = pts
        msk[:len(pts)] = True
        return out, msk

    def _register_frame(self, pts: np.ndarray, mask: np.ndarray,
                        T_prior: se3.Pose) -> Optional[FrameRegistration]:
        """Scan-to-map registration against the ROI around the prior, on
        the device, by `registration.method`: "gicp" with the exact
        nearest-mean correspondence of seven cells through the ROI's
        dense index (or, with use_dense_index=False, the binary-search
        lookup), re-associated every `reassociate_every` iterations;
        "d2d", the scan's voxel Gaussians against the ROI's; "ndt", the
        scan's points against the ROI's voxel Gaussians (both with the
        binary-search lookup; any other name registers by GICP, as in the
        JAX package).  GICP with the dense index on a CUDA card runs its
        target build and correspondence searches as CUDA graphs
        (`_gicp_graphs`).  The scan and the
        prior go up in one upload and the result comes back in one
        readback.  Returns None when the map holds nothing around the
        prior yet.  A multi-device session overrides it to register
        against its sharded map."""
        rc = self.cfg.registration
        prior_t = T_prior.t.numpy()
        with self.timers.stage("roi"):
            roi = self.map.roi_grid(float(prior_t[0]), float(prior_t[1]))
        if roi is None:
            return None
        gicp_kw = dict(iterations=rc.max_iterations, damping=rc.damping,
                       huber_delta=rc.huber_delta,
                       max_dist=rc.max_correspondence_dist,
                       reassociate_every=rc.reassociate_every)
        with self.timers.stage("register"):
            graphs = self._gicp_graphs(roi, len(pts))
            if graphs is not None:
                res = graphs.register(pts, mask, T_prior, roi, **gicp_kw)
            else:
                res = self._register_eager(pts, mask, T_prior, roi, gicp_kw)
            out = torch.cat([res.pose.q, res.pose.t,
                             res.n_matched.to(torch.float32)[None],
                             res.mean_error[None]])
            with sync_span(out):
                out = out.cpu()
        return FrameRegistration(pose=se3.Pose(out[:4], out[4:7]),
                                 n_matched=int(out[7]),
                                 mean_error=float(out[8]))

    def _gicp_graphs(self, roi: vx.VoxelGrid,
                     n_points: int) -> Optional[GicpGraphs]:
        """The CUDA graphs of the frame's GICP chain where they apply,
        GICP with the dense index on a CUDA card (made at the first frame
        registered, which captures them); None elsewhere, which registers
        eagerly."""
        rc = self.cfg.registration
        if (self.device.type != "cuda" or rc.method in ("d2d", "ndt")
                or not rc.use_dense_index):
            return None
        if self._reg_graphs is None:
            self._reg_graphs = GicpGraphs(
                roi, n_points, min_points=rc.min_points_per_voxel,
                min_planarity=rc.min_planarity)
        return self._reg_graphs

    def _register_eager(self, pts: np.ndarray, mask: np.ndarray,
                        T_prior: se3.Pose, roi: vx.VoxelGrid, gicp_kw: dict):
        """`_register_frame`'s registration launch by launch, by method;
        returns the method's result on the device."""
        rc = self.cfg.registration
        dev = self.device
        # Points and prior in one upload.
        P = len(pts)
        with sync_span(dev):
            buf = torch.as_tensor(np.concatenate(
                [pts.reshape(-1), T_prior.q.numpy(), T_prior.t.numpy()]),
                device=dev)
        pts_dev = buf[:3 * P].reshape(P, 3)
        with sync_span(dev):
            mask_dev = torch.as_tensor(mask, device=dev)
        prior = se3.Pose(buf[3 * P:3 * P + 4], buf[3 * P + 4:])
        if rc.method == "d2d":
            src = vx.build_grid(pts_dev, mask_dev, roi.origin,
                                roi.voxel_size,
                                capacity=rc.scan_voxel_capacity)
            return d2d.register_d2d(
                src, roi, d2d.usable_mask(
                    roi, min_points=rc.min_points_per_voxel),
                prior, iterations=rc.max_iterations,
                damping=rc.damping, max_dist=rc.max_correspondence_dist)
        if rc.method == "ndt":
            # NDT keeps its own damping (1e-4), as in the JAX package.
            return ndt.register(
                pts_dev, mask_dev, ndt.build_ndt_grid(
                    roi, min_points=rc.min_points_per_voxel),
                prior, iterations=rc.max_iterations,
                max_dist=rc.max_correspondence_dist)
        target = gicp.plane_grid_from(
            roi, min_points=rc.min_points_per_voxel,
            min_planarity=rc.min_planarity)
        dense = (vx.build_dense_index(roi) if rc.use_dense_index
                 else None)
        return gicp.register(pts_dev, mask_dev, target, prior, dense,
                             **gicp_kw)

    def _handle_frame(self, frame: Dict, start_us: int,
                      source: Optional[tuple] = None) -> None:
        """Localize one frame against the map, integrate it, record it,
        and maybe make it a keyframe.  Frames are compensated into the
        INS world frame; registration takes them relative to the
        frame-start INS pose, with the prior T_est_prev ∘ (T_ins_prev⁻¹ ∘
        T_ins_cur)."""
        rc = self.cfg.registration
        timers = self.timers
        with timers.stage("frame_prep"):
            ins = self._ins_pose_at(start_us)
            if ins is not None:
                pts_local_full = se3.apply(
                    se3.inverse(ins), torch.as_tensor(frame["xyz"])).numpy()
            else:
                pts_local_full = frame["xyz"]
            pts, mask = self._subsample({"xyz": pts_local_full,
                                         "mask": frame["mask"]})

            # Prior: previous estimate composed with the INS relative
            # motion.
            if self._last_est is None:
                T_prior = ins if ins is not None else se3.Pose.identity()
            elif ins is not None and self._last_ins is not None:
                rel = se3.compose(se3.inverse(self._last_ins), ins)
                T_prior = se3.compose(self._last_est, rel)
            else:
                T_prior = self._last_est

        registered = False
        n_matched, mean_error = 0, float("nan")
        T_est = T_prior
        res = self._register_frame(pts, mask, T_prior)
        if res is not None:
            n_matched, mean_error = res.n_matched, res.mean_error
            # d2d matches voxels; gicp and ndt match points.
            min_matched = (rc.min_matched_voxels if rc.method == "d2d"
                           else rc.min_matched_points)
            if n_matched > min_matched and np.isfinite(mean_error):
                T_est = res.pose
                registered = True

        # Integrate the corrected scan into the map.
        with timers.stage("frame_prep"):
            pts_world = se3.apply(T_est, torch.as_tensor(pts)).numpy()
            est_q, est_t = _np(T_est.q), _np(T_est.t)
        with timers.stage("map_update"):
            self._integrate_scan(pts_world, mask, est_t)

        with timers.stage("frame_store"):
            self.frames.add_frame(start_us, frame, carpose_q=est_q,
                                  carpose_t=est_t, source=source)
            self.trajectory.append(FrameResult(
                start_us=start_us, pose_q=est_q, pose_t=est_t,
                n_points=int(mask.sum()), n_matched=n_matched,
                mean_error=mean_error, registered=registered))
        self._maybe_keyframe(T_est, pts, mask, start_us)
        self._last_ins = ins
        self._last_est = T_est

    # --- keyframes + loop closure -------------------------------------------

    def _maybe_keyframe(self, T_est: se3.Pose, pts: np.ndarray,
                        mask: np.ndarray, start_us: int) -> None:
        """A new keyframe once the estimate moved keyframe_translation_m or
        turned keyframe_rotation_deg since the last one (float32, as the
        JAX package decides it); every keyframes_per_closure_sweep
        keyframes, a loop-closure sweep."""
        gc = self.cfg.graph
        g = self.graph
        if g.n_poses > 0:
            k = g.n_poses - 1
            rel = se3.relative(_host_pose(g.q[k], g.t[k]), T_est)
            dt = float(torch.linalg.vector_norm(rel.t))
            dr = float(torch.linalg.vector_norm(se3.quat_log(rel.q)))
            if dt < gc.keyframe_translation_m and \
                    dr < np.deg2rad(gc.keyframe_rotation_deg):
                return
        est_q, est_t = _np(T_est.q), _np(T_est.t)
        k = g.add_pose(est_q, est_t)
        self.keyframe_scans.append((pts.copy(), mask.copy()))
        if gc.use_scan_context:
            dev = self.device
            with self.timers.stage("scan_context"):
                with sync_span(dev):
                    pts_dev = torch.as_tensor(pts, device=dev)
                with sync_span(dev):
                    mask_dev = torch.as_tensor(mask, device=dev)
                self.keyframe_descs.append(_np(sc_mod.scan_context(
                    pts_dev, mask_dev)))
        self.keyframe_times.append(start_us)
        # The pose (and path) this keyframe's scan entered the map with,
        # in _handle_frame just before: the downdate anchor.
        self._kf_map_pose.append((est_q, est_t))
        self._kf_integrated_via.append("stream")
        self._kf_pose_at_creation.append((est_q.copy(), est_t.copy()))
        if k > 0:
            rel = se3.relative(_host_pose(g.q[k - 1], g.t[k - 1]), T_est)
            g.add_edge(k - 1, k, _np(rel.q), _np(rel.t),
                       info=gc.odom_edge_info)
        if k - self._kf_count_at_last_close >= \
                gc.keyframes_per_closure_sweep:
            self._try_loop_closure()
            self._kf_count_at_last_close = k

    def _closure_candidates(self) -> List[Tuple[int, int, se3.Pose]]:
        """Candidate (i, j, rel_prior) pairs from both proposal channels:
        the position radius (prior from the graph poses) and scan-context
        descriptors scored on the device (prior: the best shift's yaw,
        zero translation, independent of the drifted estimates)."""
        gc = self.cfg.graph
        q, t = self.graph.poses()
        seen = set(self.closures)
        out: List[Tuple[int, int, se3.Pose]] = []
        for i, j in loopclosure.find_candidates(
                t, radius=gc.loop_closure_radius_m,
                min_gap=gc.loop_closure_min_gap):
            if (i, j) in seen:
                continue
            seen.add((i, j))
            out.append((i, j, se3.relative(_host_pose(q[i], t[i]),
                                           _host_pose(q[j], t[j]))))
        if gc.use_scan_context and len(self.keyframe_descs) >= 2:
            with sync_span(self.device):
                descs = torch.as_tensor(np.stack(self.keyframe_descs),
                                        device=self.device)
            scores, shifts = sc_mod.descriptor_scores(descs)
            host = torch.stack([scores, shifts.to(torch.float32)])
            with sync_span(host):
                host = host.cpu().numpy()
            for i, j, _, shift in sc_mod.propose(
                    host[0], host[1].astype(np.int32),
                    n_valid=len(self.keyframe_descs),
                    min_score=gc.sc_min_score,
                    min_gap=gc.loop_closure_min_gap,
                    exclude=seen):
                seen.add((i, j))
                yaw = float(sc_mod.relative_yaw(shift))
                out.append((i, j, _host_pose(
                    [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                    np.zeros(3))))
        return out[:gc.max_closure_candidates_per_sweep]

    def _try_loop_closure(self) -> None:
        """One closure sweep: the candidates verified together on the
        device, accepted ones added as closure edges; after any acceptance
        the graph solve and the incremental map downdate."""
        rc = self.cfg.registration
        gc = self.cfg.graph
        dev = self.device

        def stack(rows):
            with sync_span(dev):
                return torch.as_tensor(np.stack(rows), device=dev)

        def upload(x):
            with sync_span(dev):
                return x.to(dev)

        with self.timers.stage("loop_propose"):
            new_p = self._closure_candidates()
            new = [(i, j) for i, j, _ in new_p]
            if new:
                scans = self.keyframe_scans
                pi = stack([scans[i][0] for i, _ in new])
                mi = stack([scans[i][1] for i, _ in new])
                pj = stack([scans[j][0] for _, j in new])
                mj = stack([scans[j][1] for _, j in new])
                rel_priors = se3.Pose(
                    upload(torch.stack([p.q for _, _, p in new_p])),
                    upload(torch.stack([p.t for _, _, p in new_p])))
        accepted = 0
        if new:
            with self.timers.stage("loop_verify"):
                measures = loopclosure.verify_closures_batch(
                    pi, mi, pj, mj, rel_priors,
                    voxel_size=gc.verify_voxel_m,
                    capacity=rc.scan_voxel_capacity)
            for (i, j), meas in zip(new, measures):
                if meas is None:
                    continue
                self.graph.add_edge(i, j, meas.q, meas.t,
                                    info=gc.closure_edge_info)
                self.closures.append((i, j))
                accepted += 1
        if accepted:
            with self.timers.stage("graph_solve"):
                self._solve_graph()
            with self.timers.stage("map_downdate"):
                self.update_map_incremental()

    @_recorded
    def update_map_incremental(self, move_threshold_m: float = 0.05
                               ) -> int:
        """Incremental voxel downdating: for each keyframe whose optimized
        pose moved more than `move_threshold_m` (or turned) since its scan
        was integrated, subtract the scan's voxel statistics at the old
        pose and re-add them at the new one, through the path it entered
        by (`_kf_integrated_via`), so the subtraction is the exact inverse
        of the addition.  Non-keyframe frames stay as integrated.  Returns
        the number of keyframes re-integrated."""
        with self.timers.stage("map_reintegrate"):
            return self._reintegrate_moved(move_threshold_m)

    def _reintegrate_moved(self, move_threshold_m: float) -> int:
        q, t = self.graph.poses()
        moved_k = [
            k for k in range(len(self.keyframe_scans))
            if not (np.linalg.norm(t[k] - self._kf_map_pose[k][1])
                    < move_threshold_m
                    and abs(float(np.dot(q[k], self._kf_map_pose[k][0])))
                    > 0.999995)]
        if not moved_k:
            return 0

        def via(k):  # untracked keyframes default to the stream path
            return (self._kf_integrated_via[k]
                    if k < len(self._kf_integrated_via) else "stream")
        stream_k = [k for k in moved_k if via(k) == "stream"]
        batch_k = [k for k in moved_k if via(k) != "stream"]
        # Stream-integrated scans: replay se3.apply + integrate_points at
        # the old pose with sign −1, then re-add at the new pose.
        for k in stream_k:
            pts_k, msk_k = self.keyframe_scans[k]
            old_q, old_t = self._kf_map_pose[k]
            pw_old = se3.apply(_host_pose(old_q, old_t),
                               torch.as_tensor(pts_k)).numpy()
            self._integrate_scan(pw_old, msk_k, old_t, sign=-1.0)
            pw_new = se3.apply(_host_pose(q[k], t[k]),
                               torch.as_tensor(pts_k)).numpy()
            self._integrate_scan(pw_new, msk_k, t[k])
        if batch_k:
            # One batched pass: every moved scan at its old pose (sign −1),
            # then at its new pose.
            pts = np.stack([self.keyframe_scans[k][0] for k in batch_k] * 2)
            msk = np.stack([self.keyframe_scans[k][1] for k in batch_k] * 2)
            qs = np.stack([self._kf_map_pose[k][0] for k in batch_k]
                          + [q[k] for k in batch_k])
            ts = np.stack([self._kf_map_pose[k][1] for k in batch_k]
                          + [t[k] for k in batch_k])
            signs = np.concatenate([-np.ones(len(batch_k)),
                                    np.ones(len(batch_k))])
            self.map.integrate_scans_batch(pts, msk, qs, ts, signs=signs,
                                           tile_filter=self._tile_filter())
        for k in moved_k:
            self._kf_map_pose[k] = (q[k].copy(), t[k].copy())
        return len(moved_k)

    @_recorded
    def rebuild_map(self) -> None:
        """Re-integrate all keyframe scans at their optimized graph poses
        into a fresh map."""
        with self.timers.stage("map_rebuild"):
            q, t = self.graph.poses()
            fresh = VoxelMap(self.cfg.map, spill_dir=self.map.spill_dir,
                             device=self.device)
            K = len(self.keyframe_scans)
            if K:
                fresh.integrate_scans_batch(
                    np.stack([p for p, _ in self.keyframe_scans]),
                    np.stack([m for _, m in self.keyframe_scans]),
                    q[:K], t[:K], tile_filter=self._tile_filter())
                for k in range(min(K, len(self._kf_map_pose))):
                    self._kf_map_pose[k] = (q[k].copy(), t[k].copy())
                    self._kf_integrated_via[k] = "batch"
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

    @_recorded
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

    @_recorded
    def finalize(self) -> Dict:
        """End-of-session pass: a last loop-closure sweep (skipped after
        run_offline_batched, whose sweep ran on the device), landmark
        extraction and association, the graph solve (Schur-eliminated
        landmarks when present, an outlier trim and one re-solve), the
        map rebuild, the per-frame trajectory correction."""
        g = self.graph
        if not self._device_closed:
            self._try_loop_closure()
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
        with self.timers.stage("trajectory"):
            # Correct the per-frame trajectory by each keyframe's total
            # motion since creation.
            if self._kf_pose_at_creation:
                old_q = np.stack([q for q, _ in self._kf_pose_at_creation])
                old_t = np.stack([t for _, t in self._kf_pose_at_creation])
                self._correct_trajectory(old_q, old_t)
                new_q, new_t = g.poses()
                self._kf_pose_at_creation = [
                    (new_q[k].copy(), new_t[k].copy())
                    for k in range(g.n_poses)]
            res = self.results()
        res["timing"] = self.timers.summary()   # `trajectory` included
        return res

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
            "ins_health": dict(self.ins_health),
            "gps_health": dict(self.gps_health),
        }

    # --- checkpoints --------------------------------------------------------

    @_recorded
    def save_checkpoint(self, dirname: str) -> None:
        """Full-session checkpoint: frame meta (with every frame's payload
        and pcap source), the INS track, the map and the graph, in the
        JAX package's file formats."""
        os.makedirs(dirname, exist_ok=True)
        self.frames.save_meta(os.path.join(dirname, "frames_meta.npz"),
                              frames_dir=os.path.join(dirname, "frames"))
        self.track.save(os.path.join(dirname, "ins_track.npz"))
        self.map.save(os.path.join(dirname, "map"))
        self.graph.save(os.path.join(dirname, "graph.npz"))

    def load_checkpoint(self, dirname: str) -> None:
        self.frames.load_meta(os.path.join(dirname, "frames_meta.npz"),
                              spill_dir=os.path.join(dirname, "frames"))
        self.track = PoseTrack.load(os.path.join(dirname, "ins_track.npz"))
        self.map = VoxelMap.load(os.path.join(dirname, "map"), self.cfg.map,
                                 device=self.device)
        self.graph = PoseGraph.load(os.path.join(dirname, "graph.npz"))
