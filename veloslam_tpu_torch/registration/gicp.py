"""Voxelized point-to-plane registration of F scans against one shared
target map.

Port of the bulk-odometry half of veloslam_tpu/registration/gicp.py.  The
target is the rolling map's voxel-Gaussian grid with a closed-form plane
normal per voxel; correspondences come from the pre-dilated dense index
(one gather per point); each Gauss-Newton iteration with fixed
correspondences is one fused normal-equations launch for all F slots
(registration.normal_equations), a damped batched 6×6 Cholesky solve, a
step clamp and a left retraction.  The JAX original vmaps `register`
over slots; here F is a batch axis throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.normal_equations import (
    fused_normal_equations)


class GicpResult(NamedTuple):
    pose: se3.Pose              # (F, ...) target-frame pose of each scan
    n_matched: torch.Tensor     # (F,) int32 — correspondences, last iter
    mean_error: torch.Tensor    # (F,) float32 — mean |point-to-plane|
    iterations: int
    H: torch.Tensor             # (F, 6, 6) normal matrix of the last iter


class PlaneGrid(NamedTuple):
    """VoxelGrid augmented with per-voxel unit normals + validity."""

    grid: vx.VoxelGrid
    normal: torch.Tensor        # (V, 3)
    usable: torch.Tensor        # (V,) bool — enough points for a stable plane


def plane_grid_from(grid: vx.VoxelGrid, *, min_points: int = 4,
                    min_planarity: float = 0.35) -> PlaneGrid:
    """Point-to-plane target from a VoxelGrid: normals + a usable gate
    (occupied, ≥ min_points, planarity (λ2 − λ3)/λ1 ≥ min_planarity)."""
    normal = vx.smallest_eigenvector(grid.cov)
    l1, l2, l3 = vx.eigvals3(grid.cov)
    planarity = (l2 - l3) / torch.clamp(l1, min=1e-12)
    usable = (grid.occupied & (grid.count >= min_points)
              & (planarity >= min_planarity))
    return PlaneGrid(grid=grid, normal=normal, usable=usable)


def associate(pts, mask, pose: se3.Pose, target: PlaneGrid,
              dense: vx.DilatedIndex):
    """Correspondences at the CURRENT poses through the dilated index:
    per-point target plane (μ, n) and hit mask, each with leading (F, P)."""
    g = target.grid
    p = se3.apply(se3.Pose(pose.q[:, None], pose.t[:, None]), pts)
    idx = vx.lookup_dilated(g, dense, p, mask)
    safe = torch.clamp(idx, min=0).long()
    return g.mean[safe], target.normal[safe], idx >= 0


def normal_equations_fixed(pts, pose: se3.Pose, mu, n, hit, *,
                           huber_delta: float = 0.5, max_dist: float = 2.0):
    """Linearization with FIXED correspondences for F slots:
    (H (F,6,6), b (F,6), mean error (F,), n_matched (F,) int32)."""
    H, b, err_sum, w_sum, n_hit = fused_normal_equations(
        pts, pose.q.contiguous(), pose.t.contiguous(), mu, n,
        hit.view(torch.uint8), huber_delta=huber_delta, max_dist=max_dist)
    return H, b, err_sum / torch.clamp(w_sum, min=1.0), n_hit


def _gn_step(pose: se3.Pose, H, b, n_hit, damping: float) -> se3.Pose:
    """Damped Cholesky solve + guarded, clamped left retraction."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    Hd = H + damping * eye + 1e-6 * trace[:, None, None] * eye
    L, info = torch.linalg.cholesky_ex(Hd)
    # L Lᵀ x = b as two triangular solves: torch.cholesky_solve's batched
    # CUDA path synchronizes the stream on every call (16 host stalls per
    # batch, measured on an H100); solve_triangular does not.
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    delta = -torch.linalg.solve_triangular(L.transpose(-2, -1), y,
                                           upper=True)[..., 0]
    # JAX's Cholesky of a non-PD matrix yields NaN that isfinite rejects;
    # cholesky_ex leaves a partial factor and sets info instead.
    ok = (torch.all(torch.isfinite(delta), dim=-1) & (n_hit > 10)
          & (info == 0))
    delta = torch.where(ok[:, None], delta, 0.0)
    # Clamp runaway steps (> 1 m or > 0.3 rad per iteration).
    tn = torch.linalg.vector_norm(delta[:, 3:], dim=-1)
    rn = torch.linalg.vector_norm(delta[:, :3], dim=-1)
    scale = torch.clamp(torch.minimum(
        1.0 / torch.clamp(tn, min=1e-12), 0.3 / torch.clamp(rn, min=1e-12)),
        max=1.0)
    return se3.retract(pose, delta * scale[:, None])


def register_batch(pts, mask, target: PlaneGrid, init_poses: se3.Pose,
                   dense: vx.DilatedIndex, *, iterations: int = 16,
                   damping: float = 1e-6, huber_delta: float = 0.5,
                   max_dist: float = 2.0,
                   reassociate_every: int = 1) -> GicpResult:
    """Gauss-Newton point-to-plane registration of F scans against one
    shared target.  Fixed iteration count; correspondences are searched
    every `reassociate_every` iterations.

    Args:
      pts: (F, P, 3) source scans (contiguous float32).
      mask: (F, P) validity.
      init_poses: Pose with (F, 4) / (F, 3) leaves.
      dense: the target's DilatedIndex.
    """
    F = pts.shape[0]
    pose = init_poses
    err = torch.full((F,), float("inf"), dtype=torch.float32,
                     device=pts.device)
    n_hit = torch.zeros((F,), dtype=torch.int32, device=pts.device)
    H = torch.zeros((F, 6, 6), dtype=torch.float32, device=pts.device)
    k = max(int(reassociate_every), 1)
    done = 0
    while done < iterations:
        block = min(k, iterations - done)
        mu, n, hit0 = associate(pts, mask, pose, target, dense)
        for _ in range(block):
            H, b, err, n_hit = normal_equations_fixed(
                pts, pose, mu, n, hit0, huber_delta=huber_delta,
                max_dist=max_dist)
            pose = _gn_step(pose, H, b, n_hit, damping)
        done += block
    return GicpResult(pose=pose, n_matched=n_hit, mean_error=err,
                      iterations=iterations, H=H)


def register(pts, mask, target: PlaneGrid, init_pose: se3.Pose,
             dense: vx.DilatedIndex, **kw) -> GicpResult:
    """One scan ((P, 3), (P,), pose (4,)/(3,)): `register_batch` at F = 1,
    with the slot axis dropped from the result."""
    res = register_batch(pts[None], mask[None], target,
                         se3.Pose(init_pose.q[None], init_pose.t[None]),
                         dense, **kw)
    return GicpResult(pose=se3.Pose(res.pose.q[0], res.pose.t[0]),
                      n_matched=res.n_matched[0],
                      mean_error=res.mean_error[0],
                      iterations=res.iterations, H=res.H[0])
