"""NDT scan-to-map registration against voxel Gaussians.

Port of veloslam_tpu/registration/ndt.py.  Each source point is matched
to the nearest usable voxel Gaussian among its own cell and its six face
neighbours (`voxel.lookup_nearest` on the target stacked at F = 1: seven
binary searches whose key reads are one `gather_i32` launch) and pulled
toward the voxel mean under the voxel's inverse covariance:

    r = p′ − μ,  W = weight of the voxel (3, 3),  J = [−[p′]ₓ | I] (3, 6),
    H = Σₚ Jᵀ W J,  b = Σₚ Jᵀ W r,

as batched torch einsums (the JAX package computes them outside any
Pallas kernel too).  Each Gauss-Newton step is the D2D/NDT variant of the
guarded, clamped Cholesky step (`normal_equations._gn_delta_shifted`),
with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.normal_equations import (
    _gn_delta_shifted)


class NdtResult(NamedTuple):
    pose: se3.Pose
    n_matched: torch.Tensor     # () int32
    mean_error: torch.Tensor    # () float32 — mean Mahalanobis residual
    iterations: int


class NdtGrid(NamedTuple):
    """VoxelGrid with each voxel's weight matrix and target gate."""

    grid: vx.VoxelGrid
    w: torch.Tensor             # (V, 3, 3)
    usable: torch.Tensor        # (V,) bool


def build_ndt_grid(grid: vx.VoxelGrid, *, min_points: int = 4,
                   robust: bool = True,
                   floor_ratio: float = 0.01) -> NdtGrid:
    """Per-voxel weights of any VoxelGrid.  `robust` (the default) takes
    the inverse of the scale-normalized, planarity-inflated covariance
    (`voxel.normalized_cov`) and gates out line-like voxels
    (`voxel.structure_usable`), against the sampling bias of an
    accumulated map; `robust=False` is classic NDT, the eigenvalue-clamped
    inverse (`voxel.clamped_inverse`), for scan-to-scan use."""
    if robust:
        w = vx.regularized_inverse(vx.normalized_cov(grid.cov), eps=1e-3)
        usable = vx.structure_usable(grid, min_points=min_points)
    else:
        w = vx.clamped_inverse(grid.cov, floor_ratio=floor_ratio)
        usable = grid.occupied & (grid.count >= min_points)
    return NdtGrid(grid=grid, w=w, usable=usable)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → skew-symmetric (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _normal_equations(pts, mask, pose: se3.Pose, target: NdtGrid,
                      stacked: vx.VoxelGrid, *, max_dist: float):
    g = target.grid
    p = se3.apply(pose, pts)
    idx = vx.lookup_nearest(stacked, p[None], mask[None],
                            target.usable[None])[0]
    safe = torch.clamp(idx, min=0).long()
    r = p - g.mean[safe]
    W = target.w[safe]                                      # (P, 3, 3)
    hit = (idx >= 0) & (torch.linalg.vector_norm(r, dim=-1) < max_dist)
    w = hit.to(torch.float32)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    J = torch.cat([-_hat(p), eye.expand(*p.shape[:-1], 3, 3)], dim=-1)
    WJ = torch.einsum("pab,pbj->paj", W, J) * w[:, None, None]
    H = torch.einsum("pai,paj->ij", J, WJ)
    b = torch.einsum("paj,pa->j", WJ, r)
    mahal = torch.einsum("pa,pab,pb->p", r, W, r)
    err = torch.sum(mahal * w) / torch.clamp(w.sum(), min=1.0)
    return H, b, err, hit.sum(dtype=torch.int32)


def normal_equations(pts, mask, pose: se3.Pose, target: NdtGrid, *,
                     max_dist: float = 3.0):
    """One linearization at `pose` ((4,) / (3,)) of the (P, 3) source:
    (H (6, 6), b (6,), mean Mahalanobis error (), matched points () int32).
    A point matches when its voxel search finds a usable voxel and
    ‖r‖ < max_dist."""
    return _normal_equations(pts, mask, pose, target, vx.stack1(target.grid),
                             max_dist=max_dist)


def register(pts, mask, target: NdtGrid, init_pose: se3.Pose, *,
             iterations: int = 16, damping: float = 1e-4,
             max_dist: float = 3.0) -> NdtResult:
    """Gauss-Newton NDT registration, a fixed number of iterations; each
    step damped by damping + 1e-6·trace(H), zeroed unless finite, positive
    definite and over 10 matches, clamped to 1 m / 0.3 rad.  No host
    read."""
    stacked = vx.stack1(target.grid)
    pose = se3.Pose(init_pose.q[None], init_pose.t[None])
    err = torch.full((), float("inf"), dtype=torch.float32,
                     device=pts.device)
    n_hit = torch.zeros((), dtype=torch.int32, device=pts.device)
    for _ in range(iterations):
        H, b, err, n_hit = _normal_equations(
            pts, mask, se3.Pose(pose.q[0], pose.t[0]), target, stacked,
            max_dist=max_dist)
        delta, _, _ = _gn_delta_shifted(H[None], b[None], n_hit[None],
                                        damping)
        pose = se3.retract(pose, delta)
    return NdtResult(pose=se3.Pose(pose.q[0], pose.t[0]), n_matched=n_hit,
                     mean_error=err, iterations=iterations)
