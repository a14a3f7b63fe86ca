"""The map and the landmarks, judged against the world.

The reference decodes the revolutions that the program made keyframes of
from the packets itself (each block's azimuth and time, each laser's
angles and firing offset, each return's range), places every return in
the world at the true pose of its firing time, and compares the
program's final map and landmarks with what those returns and the
world's closed form say:

  map_off_m           the 90th percentile, over the points of the
                      program's map (each voxel weighted by its count),
                      of the distance from the voxel's mean to the
                      nearest post or wall of the world, for the voxels
                      whose mean lies STRUCTURE_Z_M or more above the
                      ground: where the map put the world's structure
  map_voxels_missing  the structure voxels that the reference's own
                      returns fill (returns STRUCTURE_Z_M or more above
                      the ground, MIN_RETURNS or more in a voxel of the
                      map's size) with no structure voxel of the
                      program's map among the 27 about them: the
                      keyframes' points that the map leaves out
  landmark_off_max_m  the largest horizontal distance of a program
                      landmark from the nearest post or wall (0 inside a
                      post): the landmark layer takes any thin vertical
                      structure, posts and the walls' columns alike
  posts_missed_share  the share of the posts that the returns show well
                      (SEEN_RETURNS or more returns on the post in
                      SEEN_KEYFRAMES or more keyframes) with no program
                      landmark within the configuration's landmark
                      cluster radius of their surface (0 where the
                      returns show none)

The program's frame is the INS frame; the INS log carries no height, so
the program's heights are referred to its first frame: its map and
landmarks are lifted by the true height of the first frame less the
program's.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from slambench.gen import sensor as S
from slambench.reference import frames, truth

STRUCTURE_Z_M = 0.5
MIN_RETURNS = 64
ON_POST_M = 0.2
SEEN_RETURNS = 500
SEEN_KEYFRAMES = 8
_KEY_BIAS = 1 << 20


def read_db_xml(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(rotational, vertical) correction of each laser, degrees, from a
    Velodyne db.xml."""
    items = ET.parse(path).getroot().find("DB").find("points_")
    rot, vert = {}, {}
    for item in items:
        px = item.find("px")
        i = int(px.find("id_").text)
        rot[i] = float(px.find("rotCorrection_").text)
        vert[i] = float(px.find("vertCorrection_").text)
    n = len(rot)
    return (np.array([rot[i] for i in range(n)]),
            np.array([vert[i] for i in range(n)]))


def laser_angles(model: str, db_xml: Optional[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The unit's db.xml where it has one, else the model's table."""
    if db_xml:
        return read_db_xml(db_xml)
    cal = S.default_calib(model)
    return cal.rot_deg, cal.vert_deg


class Returns:
    """The stream's blocks, decoded once: azimuth ticks, time µs, the
    azimuth step to the next block, the laser of each return and its
    range (m)."""

    def __init__(self, pkts: np.ndarray, times_us: np.ndarray, model: str):
        n = len(pkts)
        blocks = pkts[:, :1200].reshape(n, 12, 100).astype(np.int64)
        ids = (blocks[..., 0] | (blocks[..., 1] << 8)).reshape(-1)
        self.az = ((blocks[..., 2] | (blocks[..., 3] << 8)) % 36000
                   ).reshape(-1).astype(np.float64)
        per_fire = 2 if model == "hdl64" else 1
        k = np.arange(12) // per_fire
        self.t_us = (times_us[:, None] + k[None, :] * frames.HDL_BLOCK_US
                     ).reshape(-1).astype(np.float64)
        step = np.diff(self.az) % 36000
        self.step = np.concatenate([step, step[-1:]]) if len(step) \
            else np.zeros(1)
        rets = blocks[..., 4:].reshape(n * 12, 32, 3)
        self.range_m = (rets[..., 0] | (rets[..., 1] << 8)) \
            * S.DISTANCE_UNIT_M
        upper = np.where(ids == S.BLOCK_ID_32_TO_63, 32, 0)
        self.laser = upper[:, None] + np.arange(32)[None, :]
        self.model = model
        self.opens, self.open_t = frames.open_blocks(pkts, times_us, model)


def world_points(r: Returns, b0: int, b1: int, rot_deg, vert_deg,
                 path, t0_us: int, device) -> torch.Tensor:
    """(n, 3) float64: the returns of blocks [b0, b1) in the world, each
    at the true pose of its firing time."""
    f64 = dict(dtype=torch.float64, device=device)
    _, dt_us, frac = S.block_timing(r.model)
    if r.model == "hdl64":
        frac = np.zeros(32)        # one azimuth for the firing's 2 blocks
    az = torch.as_tensor(r.az[b0:b1], **f64)
    step = torch.as_tensor(r.step[b0:b1], **f64)
    az_pt = az[:, None] + step[:, None] * torch.as_tensor(frac, **f64)
    t_pt = torch.as_tensor(r.t_us[b0:b1] - t0_us, **f64)[:, None] \
        + torch.as_tensor(dt_us, **f64)[None, :]
    laser = torch.as_tensor(r.laser[b0:b1], device=device)
    dist = torch.as_tensor(r.range_m[b0:b1], **f64)
    ok = dist > 0
    vert = torch.deg2rad(torch.as_tensor(vert_deg, **f64))[laser][ok]
    rot = torch.as_tensor(rot_deg, **f64)[laser][ok]
    a = torch.deg2rad(az_pt[ok] / S.TICKS_PER_DEG - rot)
    d = dist[ok]
    local = torch.stack([d * torch.cos(vert) * torch.sin(a),
                         d * torch.cos(vert) * torch.cos(a),
                         d * torch.sin(vert)], -1)
    pos, yaw, _ = path(t_pt[ok] * 1e-6)
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([pos[:, 0] + c * local[:, 0] - s * local[:, 1],
                        pos[:, 1] + s * local[:, 0] + c * local[:, 1],
                        pos[:, 2] + local[:, 2]], -1)


def pack(keys: torch.Tensor) -> torch.Tensor:
    """Integer voxel coordinates (..., 3) as one int64 each."""
    k = keys.to(torch.int64) + _KEY_BIAS
    return (k[..., 0] << 42) | (k[..., 1] << 21) | k[..., 2]


def keyframe_reference(r: Returns, kf_times_us: np.ndarray, rot_deg,
                       vert_deg, world, path, t0_us: int, voxel_m: float,
                       device) -> Dict[str, np.ndarray]:
    """What the keyframes' revolutions hold: the packed keys of the
    structure voxels with MIN_RETURNS or more returns, and for each post
    the number of keyframes that show it with SEEN_RETURNS returns."""
    posts = torch.as_tensor(world.posts, dtype=torch.float64, device=device)
    seen = torch.zeros(len(posts), dtype=torch.int64, device=device)
    keys = []
    starts = r.open_t
    for kt in np.asarray(kf_times_us, np.float64):
        i = int(np.argmin(np.abs(starts - kt)))
        if abs(starts[i] - kt) > 250.0 or i + 1 >= len(r.opens):
            continue
        p = world_points(r, int(r.opens[i]), int(r.opens[i + 1]), rot_deg,
                         vert_deg, path, t0_us, device)
        up = p[p[:, 2] >= STRUCTURE_Z_M]
        keys.append(pack(torch.floor(up / voxel_m)))
        if len(posts):
            rho = torch.hypot(up[None, :, 0] - posts[:, None, 0],
                              up[None, :, 1] - posts[:, None, 1])
            on = ((rho - posts[:, None, 2]).abs() <= ON_POST_M) \
                & (up[None, :, 2] <= posts[:, None, 4] + ON_POST_M)
            seen += (on.sum(1) >= SEEN_RETURNS).to(torch.int64)
    if keys:
        uk, cnt = torch.unique(torch.cat(keys), return_counts=True)
        full = uk[cnt >= MIN_RETURNS]
    else:
        full = torch.zeros(0, dtype=torch.int64, device=device)
    return {"voxels": full.cpu().numpy(), "post_keyframes": seen.cpu().numpy()}


def structure_distance(world, p: np.ndarray, horizontal: bool = False
                       ) -> np.ndarray:
    """Distance (m) from each point (n, 3) to the nearest post or wall
    surface of the world; with `horizontal`, in x and y alone, and 0
    inside a post."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    if horizontal:
        z = np.full_like(x, np.nan)
    best = np.full(len(p), np.inf)
    if len(world.posts):
        cx, cy, r, z0, z1 = (world.posts[:, i][None, :] for i in range(5))
        radial = np.hypot(x - cx, y - cy) - r
        dz = np.nan_to_num(np.maximum(np.maximum(z0 - z, z - z1), 0.0))
        d = np.where(dz > 0, np.hypot(np.maximum(radial, 0.0), dz),
                     np.maximum(radial, 0.0) if horizontal
                     else np.abs(radial))
        best = np.minimum(best, d.min(1))
    if len(world.walls):
        x0, y0, x1, y1, zlo, zhi = (world.walls[:, i][None, :]
                                    for i in range(6))
        sx, sy = x1 - x0, y1 - y0
        u = np.clip(((x - x0) * sx + (y - y0) * sy) / (sx * sx + sy * sy),
                    0.0, 1.0)
        horiz = np.hypot(x - (x0 + u * sx), y - (y0 + u * sy))
        dz = np.nan_to_num(np.maximum(np.maximum(zlo - z, z - zhi), 0.0))
        best = np.minimum(best, np.hypot(horiz, dz).min(1))
    return best


def weighted_quantile(values: np.ndarray, weights: np.ndarray,
                      q: float) -> float:
    if not len(values):
        return float("inf")
    o = np.argsort(values)
    cum = np.cumsum(weights[o])
    return float(values[o][np.searchsorted(cum, q * cum[-1])])


_NEIGHBOURS = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)


def judge(out: Dict, ref: Dict, world, path, t0_us: int, rules: Dict
          ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(numbers, diagnostics) of one pass's map and landmarks.  `out`
    holds the pass's `map_means` (V, 3), `map_counts` (V,), `landmarks`
    (L, 3), `times_us` and `positions`; `rules` the map's `voxel_m` and
    the configuration's `landmark_radius_m`."""
    times = np.asarray(out["times_us"], np.float64)
    pos = np.asarray(out["positions"], np.float64).reshape(-1, 3)
    if len(times):
        tpos, _ = truth.poses(path, t0_us, times[:1])
        lift = float(tpos[0, 2] - pos[0, 2])
    else:
        lift = 0.0
    means = np.asarray(out["map_means"], np.float64).reshape(-1, 3) \
        + np.array([0.0, 0.0, lift])
    counts = np.asarray(out["map_counts"], np.float64).reshape(-1)
    ok = np.isfinite(means).all(1) & (counts > 0)
    up = ok & (means[:, 2] >= STRUCTURE_Z_M)
    dist = structure_distance(world, means[up])
    nums = {"map_off_m": weighted_quantile(dist, counts[up], 0.9)}
    diag = {"map_voxels": int(ok.sum()), "map_structure_voxels":
            int(up.sum()), "map_points": float(counts[ok].sum()),
            "map_off_p50_m": weighted_quantile(dist, counts[up], 0.5),
            "map_off_p99_m": weighted_quantile(dist, counts[up], 0.99),
            "height_lift_m": lift}

    want = ref["voxels"]
    vs = rules["voxel_m"]
    have = torch.floor(torch.as_tensor(means[up] / vs))
    near = pack(have[:, None, :] + torch.as_tensor(_NEIGHBOURS)[None]
                ).reshape(-1).numpy()
    nums["map_voxels_missing"] = int(np.sum(~np.isin(want, near)))
    diag["reference_structure_voxels"] = int(len(want))

    lm = np.asarray(out["landmarks"], np.float64).reshape(-1, 3)
    lm = lm[np.isfinite(lm).all(1)]
    posts = world.posts
    nums["landmark_off_max_m"] = float(
        structure_distance(world, lm, horizontal=True).max()) \
        if len(lm) else 0.0
    if len(lm) and len(posts):
        gap = np.hypot(lm[:, None, 0] - posts[None, :, 0],
                       lm[:, None, 1] - posts[None, :, 1]) \
            - posts[None, :, 2]                           # (L, posts)
        found = (gap <= rules["landmark_radius_m"]).any(0)
    else:
        found = np.zeros(len(posts), bool)
    well_seen = ref["post_keyframes"] >= SEEN_KEYFRAMES
    nums["posts_missed_share"] = (
        float(np.sum(well_seen & ~found) / well_seen.sum())
        if well_seen.any() else 0.0)
    diag.update(landmarks=int(len(lm)), posts_seen=int(well_seen.sum()),
                posts_found=int(np.sum(well_seen & found)))
    return nums, diag
