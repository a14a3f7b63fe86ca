"""Synthetic-world LiDAR simulator (host, numpy).

A jax-free copy of the parts of veloslam_tpu/io/simulate.py that
`generate_sequence` needs (importing the original imports jax through the
io and decode package __init__s).  A closed-form raycast world (ground
plane + posts + walls + painted marks) is swept by a simulated vehicle;
the result is a bit-exact HDL packet stream, the INS log and the true
trajectory.  tests/test_torch_host.py holds the copy byte-equal to the
original.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.core.se3 import euler_deg_to_quat_np
from veloslam_tpu_torch.core.timeline import PoseTrack
from veloslam_tpu_torch.decode import calibration as calib_mod
from veloslam_tpu_torch.io import packets as pk


def truth_track(seq: Dict[str, np.ndarray],
                drift_rate: float = 0.0) -> PoseTrack:
    """PoseTrack of a sequence's 100 Hz INS truth, optionally with a
    lateral (+y) position drift of `drift_rate` m/s."""
    track = PoseTrack()
    t0 = seq["ins_t_us"][0]
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        q = euler_deg_to_quat_np(0.0, 0.0, np.rad2deg(yaw))
        dp = np.array([0.0, drift_rate * (t_us - t0) * 1e-6, 0.0])
        track.add(int(t_us), q=q, t=np.asarray(p) + dp, v=v)
    return track

# --- world -------------------------------------------------------------------

@dataclasses.dataclass
class World:
    """Ground plane + posts (cx, cy, r, z0, z1) + walls (x0, y0, x1, y1,
    zlo, zhi) + painted ground marks (x0, y0, x1, y1, width) — stripes on
    the ground plane that return paint-level retro-reflective intensity
    (the GroundLineMark source, reference MapObjects.h:38-45)."""

    ground_z: float = 0.0
    posts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 5)))
    walls: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 6)))
    marks: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 5)))

    @staticmethod
    def demo(seed: int = 0, extent: float = 80.0, n_posts: int = 24,
             n_walls: int = 8) -> "World":
        rng = np.random.default_rng(seed)
        posts = np.column_stack([
            rng.uniform(-extent, extent, n_posts),       # cx
            rng.uniform(-extent, extent, n_posts),       # cy
            rng.uniform(0.15, 0.5, n_posts),             # radius
            np.zeros(n_posts),                           # z0
            rng.uniform(3.0, 8.0, n_posts),              # z1
        ])
        walls = []
        for _ in range(n_walls):
            x0, y0 = rng.uniform(-extent, extent, 2)
            ang = rng.uniform(0, 2 * np.pi)
            ln = rng.uniform(10.0, 30.0)
            walls.append([x0, y0, x0 + ln * np.cos(ang),
                          y0 + ln * np.sin(ang), 0.0, rng.uniform(3.0, 6.0)])
        return World(posts=posts, walls=np.asarray(walls))


def raycast(world: World, origins: np.ndarray, dirs: np.ndarray,
            max_range: float = 120.0, chunk: int = 262144
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form ray intersection with the world.

    Returns (dist (R,) float64 — 0 where no hit within max_range,
    kind (R,) uint8 — 0 none, 1 ground, 2 post, 3 wall, 4 painted mark
    (a ground hit inside a mark stripe — same geometry, paint-level
    intensity)).
    """
    R = origins.shape[0]
    dist = np.zeros(R)
    kind = np.zeros(R, np.uint8)
    for s in range(0, R, chunk):
        o = origins[s:s + chunk]
        d = dirs[s:s + chunk]
        best = np.full(len(o), max_range)
        k = np.zeros(len(o), np.uint8)

        # ground plane
        dz = d[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = (world.ground_z - o[:, 2]) / dz
        hit = (dz != 0) & (tg > 0.1) & (tg < best)
        best = np.where(hit, tg, best)
        k = np.where(hit, 1, k)
        # painted marks: ground hits whose xy lies inside a stripe
        if len(world.marks):
            tg_safe = np.where(hit, tg, 0.0)
            gx = o[:, 0] + tg_safe * d[:, 0]
            gy = o[:, 1] + tg_safe * d[:, 1]
            for x0, y0, x1, y1, width in world.marks:
                seg = np.array([x1 - x0, y1 - y0])
                ln = np.hypot(*seg)
                u = ((gx - x0) * seg[0] + (gy - y0) * seg[1]) / (ln * ln)
                perp = np.abs((gx - x0) * (-seg[1]) + (gy - y0) * seg[0]) \
                    / ln
                on = hit & (u >= 0) & (u <= 1) & (perp <= width / 2)
                k = np.where(on, 4, k)

        # posts (finite vertical cylinders)
        for cx, cy, r, z0, z1 in world.posts:
            ox, oy = o[:, 0] - cx, o[:, 1] - cy
            a = d[:, 0] ** 2 + d[:, 1] ** 2
            b = 2 * (ox * d[:, 0] + oy * d[:, 1])
            c0 = ox * ox + oy * oy - r * r
            disc = b * b - 4 * a * c0
            with np.errstate(invalid="ignore", divide="ignore"):
                t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
            z = o[:, 2] + t * d[:, 2]
            hit = (disc > 0) & (a > 0) & (t > 0.1) & (t < best) \
                & (z >= z0) & (z <= z1)
            best = np.where(hit, t, best)
            k = np.where(hit, 2, k)

        # walls (vertical rectangles)
        for x0, y0, x1, y1, zlo, zhi in world.walls:
            seg = np.array([x1 - x0, y1 - y0])
            ln = np.hypot(*seg)
            n2 = np.array([-seg[1], seg[0]]) / ln       # 2D normal
            denom = d[:, 0] * n2[0] + d[:, 1] * n2[1]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = ((x0 - o[:, 0]) * n2[0] + (y0 - o[:, 1]) * n2[1]) / denom
            px = o[:, 0] + t * d[:, 0] - x0
            py = o[:, 1] + t * d[:, 1] - y0
            u = (px * seg[0] + py * seg[1]) / (ln * ln)
            z = o[:, 2] + t * d[:, 2]
            hit = (np.abs(denom) > 1e-12) & (t > 0.1) & (t < best) \
                & (u >= 0) & (u <= 1) & (z >= zlo) & (z <= zhi)
            best = np.where(hit, t, best)
            k = np.where(hit, 3, k)

        got = k > 0
        dist[s:s + chunk] = np.where(got, best, 0.0)
        kind[s:s + chunk] = k
    return dist, kind


# --- trajectories ------------------------------------------------------------

def circle_trajectory(radius: float = 30.0, speed: float = 5.0,
                      z: float = 2.0) -> Callable:
    """Counter-clockwise circle through the origin, heading = tangent."""
    def f(t: np.ndarray):
        w = speed / radius
        ang = w * np.asarray(t)
        pos = np.stack([radius * np.sin(ang), radius * (1 - np.cos(ang)),
                        np.full_like(ang, z)], -1)
        yaw = ang                      # tangent heading (ccw about +z)
        vel = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                        np.zeros_like(ang)], -1)
        return pos, yaw, vel
    return f


def figure8_trajectory(radius: float = 8.0, speed: float = 8.0,
                       z: float = 2.0) -> Callable:
    """Figure-8: alternating CCW (center (0, R)) and CW (center (0, −R))
    circles, both through the origin heading +x — the double-revisit
    drive (the crossing point is revisited once per circle)."""
    def f(t: np.ndarray):
        t = np.asarray(t, np.float64)
        w = speed / radius
        T = 2.0 * np.pi / w
        ccw = (np.floor(t / T).astype(np.int64) % 2) == 0
        ang = w * (t % T)
        sgn = np.where(ccw, 1.0, -1.0)
        pos = np.stack([radius * np.sin(ang),
                        sgn * radius * (1 - np.cos(ang)),
                        np.full_like(ang, z)], -1)
        yaw = sgn * ang
        vel = np.stack([speed * np.cos(ang), sgn * speed * np.sin(ang),
                        np.zeros_like(ang)], -1)
        return pos, yaw, vel
    return f


def straight_trajectory(speed: float = 5.0, z: float = 2.0,
                        heading: float = 0.0) -> Callable:
    def f(t: np.ndarray):
        t = np.asarray(t)
        dx = np.array([np.cos(heading), np.sin(heading), 0.0])
        pos = t[..., None] * speed * dx + np.array([0.0, 0.0, z])
        return pos, np.full_like(t, heading), np.broadcast_to(
            speed * dx, (*t.shape, 3)).copy()
    return f


def _yaw_matrix(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    z, o = np.zeros_like(yaw), np.ones_like(yaw)
    m = np.stack([c, -s, z, s, c, z, z, z, o], -1)
    return m.reshape(*yaw.shape, 3, 3)


# --- sequence generation -----------------------------------------------------

def _block_timing(model: str) -> Tuple[float, np.ndarray, np.ndarray]:
    """(block period µs, per-dsr time offset µs, per-dsr azimuth fraction)."""
    dsr = np.arange(32)
    if model == "hdl32":
        return C.HDL32_FIRING_BLOCK_US, dsr * C.HDL32_LASER_US, \
            (dsr * C.HDL32_LASER_US) / C.HDL32_FIRING_BLOCK_US
    if model == "vlp16":
        within = (np.where(dsr >= 16, dsr - 16, dsr) * C.VLP16_LASER_US
                  + np.where(dsr >= 16, C.VLP16_SUBFIRING_US, 0.0))
        return C.VLP16_FIRING_BLOCK_US, within, \
            within / C.VLP16_FIRING_BLOCK_US
    if model == "hdl64":
        return C.HDL32_FIRING_BLOCK_US, np.zeros(32), np.zeros(32)
    raise ValueError(model)


def generate_sequence(duration_s: float = 2.0, model: str = "hdl32",
                      rpm: float = 600.0, world: Optional[World] = None,
                      trajectory: Optional[Callable] = None,
                      calib=None, noise_std: float = 0.0, seed: int = 0,
                      t0_us: int = 1_700_000_000_000_000,
                      max_range: float = 120.0) -> Dict[str, np.ndarray]:
    """Simulate a drive and return the packet stream + ground truth.

    Returns dict with:
      packets (N, 1206) uint8, pkt_times_us (N,) int64,
      ins_t_us / ins_pos / ins_yaw / ins_vel — 100 Hz ground truth,
      block_times_us (B,) — absolute firing-block times (for oracles).
    """
    world = world or World.demo()
    trajectory = trajectory or circle_trajectory()
    calib = calib or calib_mod.default_for(model)
    rng = np.random.default_rng(seed)

    period_us, dsr_dt_us, dsr_frac = _block_timing(model)
    hdl64 = model == "hdl64"
    n_fire = int(duration_s * 1e6 / period_us)
    n_blocks = n_fire * (2 if hdl64 else 1)
    n_blocks -= n_blocks % C.HDL_FIRINGS_PER_PACKET
    n_pkts = n_blocks // C.HDL_FIRINGS_PER_PACKET
    n_fire = n_blocks // (2 if hdl64 else 1)

    # Firing-block schedule and azimuths.
    fire_t_s = np.arange(n_fire) * period_us * 1e-6
    rate_ticks = rpm / 60.0 * C.AZIMUTH_TICKS_PER_REV     # ticks/s
    fire_az = np.floor(fire_t_s * rate_ticks).astype(np.int64) \
        % C.AZIMUTH_TICKS_PER_REV

    # Per-laser interpolated azimuth/time (matches decoder interpolation).
    step = period_us * 1e-6 * rate_ticks                  # ticks per block
    az_pt = (fire_az[:, None] + step * dsr_frac[None, :]) \
        % C.AZIMUTH_TICKS_PER_REV                          # (Bf, 32)
    t_pt_s = fire_t_s[:, None] + dsr_dt_us[None, :] * 1e-6

    if hdl64:  # a block pair shares azimuth/time; lasers 0..63
        az_pt = np.repeat(az_pt, 2, axis=0).reshape(n_fire, 2, 32)
        t_pt_s = np.repeat(t_pt_s, 2, axis=0).reshape(n_fire, 2, 32)
        laser = np.broadcast_to(
            np.arange(64).reshape(1, 2, 32), (n_fire, 2, 32))
        az_flat = az_pt.reshape(-1, 32)
        t_flat = t_pt_s.reshape(-1, 32)
        laser_flat = laser.reshape(-1, 32)
    else:
        laser_flat = np.broadcast_to(
            (np.where(np.arange(32) >= 16, np.arange(32) - 16,
                      np.arange(32)) if model == "vlp16"
             else np.arange(32))[None, :], (n_fire, 32))
        az_flat, t_flat = az_pt, t_pt_s

    # Beam directions in the sensor frame (decode math,
    # reference HDLParser.cxx:597-623 with zero offsets).
    vert = np.deg2rad(calib.vert_correction_deg)[laser_flat]
    rot = calib.rot_correction_deg[laser_flat]
    az_rad = np.deg2rad(az_flat / C.AZIMUTH_TICKS_PER_DEG - rot)
    dirs_s = np.stack([np.cos(vert) * np.sin(az_rad),
                       np.cos(vert) * np.cos(az_rad),
                       np.sin(vert)], -1)                  # (B, 32, 3)

    # Vehicle pose at each firing; rays in world frame.
    pos, yaw, _ = trajectory(t_flat.reshape(-1))
    Rm = _yaw_matrix(yaw)
    dirs_w = np.einsum("rij,rj->ri", Rm, dirs_s.reshape(-1, 3))
    dist, kindv = raycast(world, pos, dirs_w, max_range=max_range)
    if noise_std > 0:
        dist = np.where(dist > 0, dist + rng.normal(0, noise_std, dist.shape),
                        0.0)

    dist_raw = np.round(np.maximum(dist, 0.0) / C.DISTANCE_UNIT_M)
    dist_raw = np.where((dist_raw > 0) & (dist_raw < 65536), dist_raw, 0)
    # none / ground / post / wall / painted mark (retro-reflective paint
    # saturates the return, the GroundLineMark intensity edge)
    intensity = np.choose(kindv, [0, 80, 200, 150, 255])

    nb = n_blocks
    az_blocks = (np.repeat(fire_az, 2) if hdl64 else fire_az).reshape(-1)
    block_t_s = (np.repeat(fire_t_s, 2) if hdl64 else fire_t_s)
    dist_blocks = dist_raw.reshape(nb, 32)
    int_blocks = intensity.reshape(nb, 32)

    shape12 = (n_pkts, 12)
    pkt_az = az_blocks.reshape(shape12)
    pkt_dist = dist_blocks.reshape(n_pkts, 12, 32)
    pkt_int = int_blocks.reshape(n_pkts, 12, 32)
    pkt_t_us = t0_us + (block_t_s.reshape(shape12)[:, 0] * 1e6).astype(np.int64)
    gps_us = (pkt_t_us % (3600 * 1_000_000)).astype(np.int64)
    if hdl64:
        ids = np.where(np.arange(12) % 2 == 0, C.BLOCK_ID_0_TO_31,
                       C.BLOCK_ID_32_TO_63)
        block_ids = np.broadcast_to(ids, shape12)
    else:
        block_ids = np.full(shape12, C.BLOCK_ID_0_TO_31)

    pkts = pk.encode_lidar_packets(pkt_az, pkt_dist, pkt_int, gps_us,
                                   block_ids)

    # 100 Hz INS ground truth.
    ins_t_s = np.arange(0.0, duration_s + 0.01, C.INS_PERIOD_MS * 1e-3)
    ins_pos, ins_yaw, ins_vel = trajectory(ins_t_s)
    return {
        "packets": pkts,
        "pkt_times_us": pkt_t_us,
        "block_times_us": t0_us + (block_t_s * 1e6).astype(np.int64),
        "ins_t_us": t0_us + (ins_t_s * 1e6).astype(np.int64),
        "ins_pos": ins_pos, "ins_yaw": ins_yaw, "ins_vel": ins_vel,
        "model": model,
    }
