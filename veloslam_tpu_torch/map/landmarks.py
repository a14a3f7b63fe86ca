"""Landmark layer: typed map objects as struct-of-arrays + extraction.

Port of veloslam_tpu/map/landmarks.py: the `Landmarks` record and the
extractors, host numpy (importing the original runs the JAX package's
__init__).  Posts, planes and complexes come from a map patch's voxel
statistics (`extract_landmarks`); ground marks from a scan's intensity
channel.  `extract_planes`' per-voxel eigen analysis runs on `device`
(registration.voxel's float32 Cardano eigenvalues and smallest
eigenvector; cuda unless the caller asks for cpu).
tests/test_torch_landmarks.py holds the port equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.registration import voxel as vx


@dataclasses.dataclass
class Landmarks:
    """Per-patch landmark sets (SoA).

    posts:  (P, 5)  x, y, z_base, height, radius
    planes: (Q, 16) 4 plane coeffs + 4 corner xyz
    marks:  (M, 7)  2 endpoints xyz + width
    complexes: ragged — (center+bbox (K, 6), points offsets (K+1,),
                points (Npts, 3))
    """

    posts: np.ndarray
    planes: np.ndarray
    marks: np.ndarray
    cplx_meta: np.ndarray
    cplx_offsets: np.ndarray
    cplx_points: np.ndarray

    @classmethod
    def empty(cls) -> "Landmarks":
        return cls(posts=np.zeros((0, 5), np.float64),
                   planes=np.zeros((0, 16), np.float64),
                   marks=np.zeros((0, 7), np.float64),
                   cplx_meta=np.zeros((0, 6), np.float64),
                   cplx_offsets=np.zeros(1, np.int64),
                   cplx_points=np.zeros((0, 3), np.float32))

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"lm_posts": self.posts, "lm_planes": self.planes,
                "lm_marks": self.marks, "lm_cplx_meta": self.cplx_meta,
                "lm_cplx_offsets": self.cplx_offsets,
                "lm_cplx_points": self.cplx_points}

    @classmethod
    def from_arrays(cls, d) -> "Landmarks":
        if "lm_posts" not in getattr(d, "files", d):
            return cls.empty()
        return cls(posts=d["lm_posts"], planes=d["lm_planes"],
                   marks=d["lm_marks"], cplx_meta=d["lm_cplx_meta"],
                   cplx_offsets=d["lm_cplx_offsets"],
                   cplx_points=d["lm_cplx_points"])

    def concat(self, other: "Landmarks") -> "Landmarks":
        off = other.cplx_offsets + len(self.cplx_points)
        return Landmarks(
            posts=np.concatenate([self.posts, other.posts]),
            planes=np.concatenate([self.planes, other.planes]),
            marks=np.concatenate([self.marks, other.marks]),
            cplx_meta=np.concatenate([self.cplx_meta, other.cplx_meta]),
            cplx_offsets=np.concatenate([self.cplx_offsets, off[1:]]),
            cplx_points=np.concatenate([self.cplx_points,
                                        other.cplx_points]))


def extract_posts(coords: np.ndarray, count: np.ndarray, mean: np.ndarray,
                  cov: np.ndarray, voxel_size: float,
                  min_stack: int = 3, min_points: int = 6,
                  max_radius: float = 0.8) -> np.ndarray:
    """Detect upright posts: vertical stacks of line-like voxels.

    A voxel is post-like when its dominant eigenvector is near-vertical and
    its horizontal spread is small; stacks of ≥ min_stack such voxels in
    the same (x, y) column become one UprightPost record (x, y, z_base,
    height, radius).
    """
    if len(coords) == 0:
        return np.zeros((0, 5))
    w, v = np.linalg.eigh(cov + 1e-9 * np.eye(3))
    dom = v[:, :, 2]                               # dominant eigenvector
    vertical = np.abs(dom[:, 2]) > 0.85
    horiz_sigma = np.sqrt(np.maximum(w[:, 0] + w[:, 1], 0.0))
    slim = horiz_sigma < max_radius
    ok = vertical & slim & (count >= min_points)
    if not ok.any():
        return np.zeros((0, 5))
    c = coords[ok]
    m = mean[ok]
    sig = horiz_sigma[ok]
    # Group by (x, y) column.
    col, inv = np.unique(c[:, :2], axis=0, return_inverse=True)
    # Reject columns belonging to wall runs: a sparsely-sampled wall also
    # produces vertical line voxels, but its columns come in contiguous
    # horizontal runs; a genuine post column is isolated (≤ 2 adjacent
    # post-like columns).
    col_set = {tuple(xy) for xy in col}
    n_adj = np.array([
        sum((cx + dx, cy + dy) in col_set
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            if (dx, dy) != (0, 0))
        for cx, cy in col])
    posts = []
    for i in range(len(col)):
        if n_adj[i] > 2:
            continue
        sel = inv == i
        if sel.sum() < min_stack:
            continue
        zs = c[sel, 2]
        # require a contiguous-ish stack
        if zs.max() - zs.min() + 1 > sel.sum() * 2:
            continue
        mm = m[sel]
        z_base = float(zs.min()) * voxel_size
        height = float(zs.max() - zs.min() + 1) * voxel_size
        posts.append([mm[:, 0].mean(), mm[:, 1].mean(), z_base, height,
                      float(np.median(sig[sel]))])
    return np.asarray(posts).reshape(-1, 5)


def extract_planes(coords: np.ndarray, count: np.ndarray, mean: np.ndarray,
                   cov: np.ndarray, voxel_size: float,
                   min_points: int = 8, min_planarity: float = 0.4,
                   normal_bins: int = 8, device="cuda") -> np.ndarray:
    """Detect large planes: planar voxels clustered by quantized
    (normal, offset); each cluster yields one Plane record
    (4 coefficients + 4 corners).  The voxels' normals and eigenvalues
    come from float32 Cardano on `device`."""
    if len(coords) == 0:
        return np.zeros((0, 16))
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("extract_planes runs its eigen analysis on a "
                           "CUDA card by default and torch.cuda."
                           "is_available() is False; pass device='cpu'")
    covt = torch.as_tensor(np.asarray(cov, np.float32), device=dev)
    n = vx.smallest_eigenvector(covt).cpu().numpy()
    l1, l2, l3 = (a.cpu().numpy() for a in vx.eigvals3(covt))
    planarity = (l2 - l3) / np.maximum(l1, 1e-12)
    ok = (planarity > min_planarity) & (count >= min_points)
    if not ok.any():
        return np.zeros((0, 16))
    n = n[ok]
    m = mean[ok]
    # Canonical normal orientation, quantized direction + plane offset.
    flip = (n[:, 2] < 0) | ((n[:, 2] == 0) & (n[:, 0] < 0))
    n = np.where(flip[:, None], -n, n)
    d = -np.sum(n * m, axis=1)
    qn = np.round(n * normal_bins).astype(np.int64)
    qd = np.round(d / (2.0 * voxel_size)).astype(np.int64)
    key = np.concatenate([qn, qd[:, None]], axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    planes = []
    for i in range(len(uniq)):
        sel = inv == i
        if sel.sum() < 3:
            continue
        nn = n[sel].mean(0)
        nn /= np.linalg.norm(nn)
        mm = m[sel]
        dd = -float(np.mean(mm @ nn))
        # Corners: bounding box of member voxel means projected in-plane.
        u = np.cross(nn, [0, 0, 1.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.array([1.0, 0, 0])
        u /= np.linalg.norm(u)
        v2 = np.cross(nn, u)
        center = mm.mean(0)
        pu = (mm - center) @ u
        pv = (mm - center) @ v2
        corners = [center + a * u + b * v2
                   for a, b in [(pu.min(), pv.min()), (pu.min(), pv.max()),
                                (pu.max(), pv.max()), (pu.max(), pv.min())]]
        planes.append(np.concatenate([[nn[0], nn[1], nn[2], dd],
                                      np.concatenate(corners)]))
    return np.asarray(planes).reshape(-1, 16)


def _connected_components(cells: np.ndarray, reach: int = 1) -> np.ndarray:
    """Label integer grid cells (N, D) by `reach`-neighbourhood
    connectivity (reach=1: 8- or 26-connected), union-find over a cell
    hash; each label is a member's index."""
    n = len(cells)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    index = {tuple(c): i for i, c in enumerate(cells)}
    D = cells.shape[1]
    offsets = np.array(np.meshgrid(
        *[range(-reach, reach + 1)] * D)).reshape(D, -1).T
    for off in offsets:
        if not off.any():
            continue
        for i, c in enumerate(cells):
            j = index.get(tuple(c + off))
            if j is not None:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[rb] = ra
    return np.asarray([find(i) for i in range(n)])


def extract_complexes(coords: np.ndarray, count: np.ndarray,
                      mean: np.ndarray, cov: np.ndarray, voxel_size: float,
                      min_points: int = 6, min_voxels: int = 8,
                      max_voxels: int = 400,
                      min_height_voxels: int = 2) -> Tuple[np.ndarray,
                                                           np.ndarray,
                                                           np.ndarray]:
    """Detect Complex landmarks: 26-connected clusters of occupied voxels
    that are neither post-like (vertical line) nor strongly planar, with
    min_voxels..max_voxels members and at least min_height_voxels of
    vertical extent (bushes, parked cars).

    Returns (meta (K, 6): center xyz + bbox extents, offsets (K+1,),
    points (ΣNk, 3): member voxel means), the Landmarks.cplx_* layout.
    """
    empty = (np.zeros((0, 6)), np.zeros(1, np.int64),
             np.zeros((0, 3), np.float32))
    if len(coords) == 0:
        return empty
    w, v = np.linalg.eigh(np.asarray(cov, np.float64) + 1e-9 * np.eye(3))
    dom = v[:, :, 2]
    postlike = (np.abs(dom[:, 2]) > 0.85) \
        & (np.sqrt(np.maximum(w[:, 0] + w[:, 1], 0.0)) < 0.8)
    planarity = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-12)
    planar = planarity > 0.4
    ok = (count >= min_points) & ~postlike & ~planar
    if not ok.any():
        return empty
    c = coords[ok]
    m = mean[ok]
    labels = _connected_components(c)
    meta, offsets, points = [], [0], []
    for lab in np.unique(labels):
        sel = labels == lab
        nsel = int(sel.sum())
        if not (min_voxels <= nsel <= max_voxels):
            continue
        zs = c[sel, 2]
        if zs.max() - zs.min() + 1 < min_height_voxels:
            continue   # flat ground residue, not a structure
        mm = m[sel]
        lo = mm.min(0)
        hi = mm.max(0)
        meta.append(np.concatenate([(lo + hi) / 2, hi - lo]))
        points.append(mm.astype(np.float32))
        offsets.append(offsets[-1] + nsel)
    if not meta:
        return empty
    return (np.asarray(meta).reshape(-1, 6),
            np.asarray(offsets, np.int64),
            np.concatenate(points).reshape(-1, 3))


def extract_ground_marks(pts: np.ndarray, intensity: np.ndarray,
                         mask: np.ndarray, ground_z: float = 0.0,
                         voxel_size: float = 0.5,
                         high_intensity: float = 220.0,
                         max_height: float = 0.3, min_points: int = 12,
                         min_length: float = 1.0) -> np.ndarray:
    """Detect GroundLineMark landmarks: painted lane-mark segments as
    intensity edges on the ground plane, from a scan (paint is invisible
    to the map's geometry moments).  Ground-height returns at paint-level
    intensity are clustered by 2-D grid connectivity; each cluster's
    principal xy axis gives the segment's endpoints, the transverse
    spread its width.

    Returns (M, 7): endpoint0 xyz, endpoint1 xyz, width.
    """
    sel = (np.asarray(mask, bool)
           & (np.asarray(intensity, np.float32) >= high_intensity)
           & (np.abs(pts[:, 2] - ground_z) <= max_height))
    p = np.asarray(pts, np.float32)[sel]
    if len(p) < min_points:
        return np.zeros((0, 7))
    cell = np.floor(p[:, :2] / voxel_size).astype(np.int64)
    uniq, inv = np.unique(cell, axis=0, return_inverse=True)
    labels = _connected_components(uniq)
    marks = []
    for lab in np.unique(labels):
        member = np.isin(inv, np.nonzero(labels == lab)[0])
        if member.sum() < min_points:
            continue
        mp = p[member]
        center = mp.mean(0)
        d = mp[:, :2] - center[:2]
        covm = d.T @ d / len(d)
        w, v = np.linalg.eigh(covm)
        u = v[:, 1]                       # principal xy direction
        proj = d @ u
        length = float(proj.max() - proj.min())
        if length < min_length:
            continue
        width = float(4.0 * np.sqrt(max(w[0], 0.0)))   # ±2σ transverse
        e0 = np.array([center[0] + proj.min() * u[0],
                       center[1] + proj.min() * u[1], center[2]])
        e1 = np.array([center[0] + proj.max() * u[0],
                       center[1] + proj.max() * u[1], center[2]])
        marks.append(np.concatenate([e0, e1, [width]]))
    return np.asarray(marks).reshape(-1, 7)


def extract_landmarks(patch, voxel_size: float, device="cuda") -> Landmarks:
    """Run the map-statistics extractors (posts, planes on `device`,
    complexes) over a MapPatchData's voxel statistics."""
    count = patch.count
    denom = np.maximum(count, 1.0)[:, None]
    centers = (patch.coords + 0.5) * voxel_size
    mean_rel = patch.s1 / denom
    mean = mean_rel + centers
    cov = patch.s2 / denom[..., None] \
        - mean_rel[:, :, None] * mean_rel[:, None, :]
    lm = Landmarks.empty()
    lm.posts = extract_posts(patch.coords, count, mean, cov, voxel_size)
    lm.planes = extract_planes(patch.coords, count, mean, cov, voxel_size,
                               device=device)
    lm.cplx_meta, lm.cplx_offsets, lm.cplx_points = extract_complexes(
        patch.coords, count, mean, cov, voxel_size)
    return lm
