"""Landmark layer: typed map objects as struct-of-arrays + post extraction.

A host numpy copy of `Landmarks` and `extract_posts` from
veloslam_tpu/map/landmarks.py (importing the original runs the JAX
package's __init__).  The other extractors (planes, complexes, ground
marks) are not on the batched pipeline's path and are not ported yet
(ROADMAP.md).  tests/test_torch_landmarks.py holds the copy equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


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
