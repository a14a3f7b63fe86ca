"""Vectorized HDL packet decode + INS motion compensation on torch tensors.

Port of veloslam_tpu/decode/decode.py.  A batch of (N, 1206) uint8
packets decodes as dense (N, 12, 32) arrays: byte fields by integer
arithmetic, the per-packet azimuth step (sorted index 6 of the 11 block
diffs), per-laser time/azimuth interpolation from the sensor timing
model, polar → Cartesian with the 5-term laser calibration, and the
crop-region and points-skip options as mask updates.  Dual-return pairs
are classified and filtered as in the JAX package.  `compensate`
interpolates an INS pose per firing block (or, with `per_packet`, one per
packet) and applies the full SE(3) pose to every point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.timeline import interpolate_poses
from veloslam_tpu_torch.utils.profiling import sync_span


class DeviceCalib(NamedTuple):
    """Device-resident per-laser calibration (see calibration.LaserCalib)."""

    rot_correction_deg: torch.Tensor   # (L,)
    sin_vert: torch.Tensor             # (L,)
    cos_vert: torch.Tensor             # (L,)
    dist_correction_m: torch.Tensor    # (L,)
    vert_offset_m: torch.Tensor        # (L,)
    horiz_offset_m: torch.Tensor       # (L,)
    laser_enabled: torch.Tensor        # (L,) bool — laser selection mask
    beam_row: torch.Tensor             # (L,) int32 — wire id → frame row

    @classmethod
    def from_host(cls, calib, *, device, enabled=None,
                  sort_beams=None) -> "DeviceCalib":
        """`enabled`: (L,) bool laser-selection mask.  `sort_beams`: order
        output rows by ascending vertical angle (default: only for 64-laser
        calibrations)."""
        L = calib.n_lasers
        en = np.ones(L, bool) if enabled is None else np.asarray(enabled, bool)
        if sort_beams is None:
            sort_beams = L == 64
        rows = np.argsort(calib.beam_order()) if sort_beams else np.arange(L)

        def up(a):
            with sync_span(device):
                return torch.as_tensor(a, device=device)

        def f32(a):
            return up(np.asarray(a, np.float32))

        return cls(f32(calib.rot_correction_deg), f32(calib.sin_vert),
                   f32(calib.cos_vert), f32(calib.dist_correction_m),
                   f32(calib.vert_offset_m), f32(calib.horiz_offset_m),
                   up(en), up(rows.astype(np.int32)))


class DecodedBatch(NamedTuple):
    """Dense decode of N packets: leading shape (N, 12, 32)."""

    xyz: torch.Tensor          # (N, 12, 32, 3) float32, sensor frame
    intensity: torch.Tensor    # (N, 12, 32) float32
    dist_m: torch.Tensor       # (N, 12, 32) float32
    valid: torch.Tensor        # (N, 12, 32) bool
    laser_id: torch.Tensor     # (N, 12, 32) int32 — output beam row
    az_ticks: torch.Tensor     # (N, 12) int32 — raw block azimuth
    az_pt_ticks: torch.Tensor  # (N, 12, 32) float32 — interpolated per point
    dt_s: torch.Tensor         # (N, 12, 32) float32 — firing offset in packet
    is_upper: torch.Tensor     # (N, 12) bool — HDL-64 upper block (0xeeff)
    subfiring: torch.Tensor    # (N, 12, 32) int32 — VLP-16 sub-firing


def _u16(lo, hi):
    return lo.to(torch.int32) | (hi.to(torch.int32) << 8)


def parse_packet_fields(pkts_u8: torch.Tensor):
    """Raw (N, 1206) uint8 → (block_id, az_ticks, dist_raw, intensity,
    gps_us).  12 × 100-byte firing blocks [u16 block id, u16 azimuth,
    32 × (u16 distance, u8 intensity)], then a u32 µs-into-hour stamp at
    byte 1200; little-endian.  The stamp is assembled in int64 (torch has
    no uint32 shifts on the CPU)."""
    n = pkts_u8.shape[0]
    blocks = pkts_u8[:, :1200].reshape(n, C.HDL_FIRINGS_PER_PACKET,
                                       C.HDL_FIRING_BYTES)
    block_id = _u16(blocks[..., 0], blocks[..., 1])
    az_ticks = _u16(blocks[..., 2], blocks[..., 3]) % C.AZIMUTH_TICKS_PER_REV
    rets = blocks[:, :, 4:].reshape(n, C.HDL_FIRINGS_PER_PACKET,
                                    C.HDL_LASERS_PER_FIRING, 3)
    dist_raw = _u16(rets[..., 0], rets[..., 1])
    intensity = rets[..., 2].to(torch.float32)
    gps = pkts_u8[:, 1200:1204].to(torch.int64)
    gps_us = (gps[:, 0] | (gps[:, 1] << 8) | (gps[:, 2] << 16)
              | (gps[:, 3] << 24))
    return block_id, az_ticks, dist_raw, intensity, gps_us


def _timing_model(model: str, device):
    """Per-(block, dsr) firing time offsets (µs) and azimuth-interpolation
    fraction within a block, each (12, 32) float32."""
    blocks = torch.arange(C.HDL_FIRINGS_PER_PACKET, dtype=torch.float32,
                          device=device)[:, None]
    dsr = torch.arange(C.HDL_LASERS_PER_FIRING, dtype=torch.float32,
                       device=device)[None, :]
    if model == "hdl32":
        t = blocks * C.HDL32_FIRING_BLOCK_US + dsr * C.HDL32_LASER_US
        frac = (dsr * C.HDL32_LASER_US) / C.HDL32_FIRING_BLOCK_US
    elif model == "vlp16":
        laser = torch.where(dsr >= 16, dsr - 16, dsr)
        sub = torch.where(dsr >= 16, 1.0, 0.0)
        within = laser * C.VLP16_LASER_US + sub * C.VLP16_SUBFIRING_US
        t = blocks * C.VLP16_FIRING_BLOCK_US + within
        frac = within / C.VLP16_FIRING_BLOCK_US
    elif model == "hdl64":
        # No intra-block interpolation; block pairs share a firing time.
        t = torch.div(blocks, 2, rounding_mode="floor") \
            * C.HDL32_FIRING_BLOCK_US + dsr * 0.0
        frac = dsr * 0.0
    else:
        raise ValueError(f"unknown sensor model {model!r}")
    return t, frac


def decode_packets(pkts_u8: torch.Tensor, calib: DeviceCalib, *,
                   model: str,
                   crop_region: Optional[Tuple[float, ...]] = None,
                   crop_inside: bool = False,
                   points_skip: int = 0) -> DecodedBatch:
    """Decode (N, 1206) uint8 packets into sensor-frame points + masks.

    `points_skip` keeps every (points_skip+1)-th firing block;
    `crop_region` (x0, x1, y0, y1, z0, z1) keeps only the points inside
    the box, or with `crop_inside` drops them."""
    block_id, az_ticks, dist_raw, intensity, _ = parse_packet_fields(pkts_u8)
    n = pkts_u8.shape[0]
    device = pkts_u8.device

    # Per-packet azimuth step: sorted index 6 of the 11 block diffs.
    diffs = (az_ticks[:, 1:] - az_ticks[:, :-1]) % C.AZIMUTH_TICKS_PER_REV
    az_step = torch.sort(diffs, dim=-1).values[:, C.HDL_FIRINGS_PER_PACKET
                                               // 2]

    t_us, frac = _timing_model(model, device)
    dt_s = (t_us * 1e-6).expand(n, *t_us.shape)

    az_pt = az_ticks[..., None].to(torch.float32) + \
        az_step[:, None, None].to(torch.float32) * frac[None]

    dsr = torch.arange(C.HDL_LASERS_PER_FIRING, dtype=torch.int32,
                       device=device)
    is_upper = block_id == C.BLOCK_ID_0_TO_31
    if model == "vlp16":
        laser_id = torch.where(dsr >= 16, dsr - 16, dsr).expand(
            dist_raw.shape)
        subfiring = (dsr >= 16).to(torch.int32).expand(dist_raw.shape)
    elif model == "hdl64":
        offset = torch.where(is_upper, 0, 32).to(torch.int32)
        laser_id = offset[..., None] + dsr
        subfiring = torch.zeros_like(laser_id)
    else:
        laser_id = dsr.expand(dist_raw.shape)
        subfiring = torch.zeros_like(dist_raw)
    corr_id = laser_id.long()

    rot = calib.rot_correction_deg[corr_id]
    sin_v = calib.sin_vert[corr_id]
    cos_v = calib.cos_vert[corr_id]
    d_corr = calib.dist_correction_m[corr_id]
    v_off = calib.vert_offset_m[corr_id]
    h_off = calib.horiz_offset_m[corr_id]

    # Polar → Cartesian.
    az_rad = torch.deg2rad(az_pt / C.AZIMUTH_TICKS_PER_DEG - rot)
    sin_a, cos_a = torch.sin(az_rad), torch.cos(az_rad)
    dist_m = dist_raw.to(torch.float32) * C.DISTANCE_UNIT_M + d_corr
    xy = dist_m * cos_v
    x = xy * sin_a - h_off * cos_a
    y = xy * cos_a + h_off * sin_a
    z = dist_m * sin_v + v_off
    xyz = torch.stack([x, y, z], dim=-1)

    valid = (dist_raw != 0) & calib.laser_enabled[corr_id]
    if points_skip:
        keep = (torch.arange(C.HDL_FIRINGS_PER_PACKET, device=device)
                % (points_skip + 1)) == 0
        valid = valid & keep[None, :, None]
    if crop_region is not None:
        x0, x1, y0, y1, z0, z1 = crop_region
        inside = ((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
                  & (z >= z0) & (z <= z1))
        valid = valid & (~inside if crop_inside else inside)
    return DecodedBatch(xyz=xyz, intensity=intensity, dist_m=dist_m,
                        valid=valid, laser_id=calib.beam_row[corr_id],
                        az_ticks=az_ticks, az_pt_ticks=az_pt, dt_s=dt_s,
                        is_upper=is_upper, subfiring=subfiring)


def dual_return_flags(decoded: DecodedBatch):
    """Per-point dual-return classification (batch-local): a block whose
    azimuth repeats its neighbour's is one member of a dual pair.

    Returns (dist_flag, int_flag, is_dual), each (N, 12, 32):
      dist_flag: int8 −1 nearer return, +1 farther, 0 single/equal;
      int_flag:  int8 +1 higher intensity, −1 lower, 0 single/equal;
      is_dual:   bool, True on both members of a pair where both returned.
    Pairs spanning a batch boundary count as single returns."""
    n = decoded.xyz.shape[0]
    shape = (n * C.HDL_FIRINGS_PER_PACKET, C.HDL_LASERS_PER_FIRING)
    az = decoded.az_ticks.reshape(-1)
    edge = torch.full((1,), -1, dtype=az.dtype, device=az.device)
    prev_az = torch.cat([edge, az[:-1]])
    next_az = torch.cat([az[1:], edge])
    second = az == prev_az                    # this block repeats previous
    first = az == next_az                     # next block repeats this one
    sec = second[:, None]

    def other(a):
        return torch.where(sec, torch.roll(a, 1, dims=0),
                           torch.roll(a, -1, dims=0))

    dist = decoded.dist_m.reshape(shape)
    inten = decoded.intensity.reshape(shape)
    valid = decoded.valid.reshape(shape)
    is_dual = (first | second)[:, None] & valid & other(valid)
    other_dist, other_int = other(dist), other(inten)
    zero = torch.zeros(shape, dtype=torch.int8, device=az.device)
    dist_flag = torch.where(
        ~is_dual, zero, torch.where(dist < other_dist, -1,
                                    torch.where(dist > other_dist, 1, 0)
                                    ).to(torch.int8))
    int_flag = torch.where(
        ~is_dual, zero, torch.where(inten > other_int, 1,
                                    torch.where(inten < other_int, -1, 0)
                                    ).to(torch.int8))
    out = (n, C.HDL_FIRINGS_PER_PACKET, C.HDL_LASERS_PER_FIRING)
    return dist_flag.reshape(out), int_flag.reshape(out), is_dual.reshape(out)


def apply_dual_return_filter(decoded: DecodedBatch, mode: str
                             ) -> DecodedBatch:
    """Keep one member of each dual pair: mode "near" | "far" | "high" |
    "low".  Single returns always pass; a pair with equal distance and
    intensity keeps its first member only."""
    dist_flag, int_flag, is_dual = dual_return_flags(decoded)
    az = decoded.az_ticks.reshape(-1)
    prev_az = torch.cat([torch.full((1,), -1, dtype=az.dtype,
                                    device=az.device), az[:-1]])
    second = (az == prev_az).reshape(is_dual.shape[:2])[..., None]
    if mode == "near":
        keep = dist_flag == -1
    elif mode == "far":
        keep = dist_flag == 1
    elif mode == "high":
        keep = int_flag == 1
    elif mode == "low":
        keep = int_flag == -1
    else:
        raise ValueError(f"unknown dual-return filter {mode!r}")
    tie = is_dual & (dist_flag == 0) & (int_flag == 0)
    keep = torch.where(tie, ~second, keep)
    return decoded._replace(valid=decoded.valid
                            & torch.where(is_dual, keep, True))


def frame_break_flags(az_ticks: torch.Tensor, last_azimuth: torch.Tensor):
    """Azimuth-wrap frame segmentation: True where a block's azimuth drops
    below its predecessor's (the carried `last_azimuth` for the first
    block; −1 before the first batch never triggers).  Returns
    (flags (N*12,) bool, new last_azimuth () int32)."""
    flat = az_ticks.reshape(-1)
    prev = torch.cat([last_azimuth.reshape(1), flat[:-1]])
    return flat < prev, flat[-1]


def compensate(decoded: DecodedBatch, pkt_rel_s: torch.Tensor,
               track_rel_s: torch.Tensor, track_q: torch.Tensor,
               track_t: torch.Tensor, track_v: torch.Tensor, *,
               per_packet: bool = False):
    """Sensor-frame points → world frame with one INS pose per firing
    block, or with `per_packet` one per packet (at its time stamp).
    Returns (xyz_world (N, 12, 32, 3), firing poses (N, 12))."""
    n = decoded.xyz.shape[0]
    blocks = C.HDL_FIRINGS_PER_PACKET
    if per_packet:
        poses = interpolate_poses(track_rel_s, track_q, track_t, track_v,
                                  pkt_rel_s)
        poses = se3.Pose(poses.q[:, None].expand(n, blocks, 4),
                         poses.t[:, None].expand(n, blocks, 3))
    else:
        block_dt = decoded.dt_s[:, :, 0]                    # (N, 12)
        q_t = (pkt_rel_s[:, None] + block_dt).reshape(-1)
        poses = interpolate_poses(track_rel_s, track_q, track_t, track_v,
                                  q_t)
        poses = se3.Pose(poses.q.reshape(n, blocks, 4),
                         poses.t.reshape(n, blocks, 3))
    xyz_w = se3.apply(se3.Pose(poses.q[:, :, None], poses.t[:, :, None]),
                      decoded.xyz)
    return xyz_w, poses
