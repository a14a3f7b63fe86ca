"""Voxelized point-to-plane registration of F scans, against one shared
target map or against F targets of their own.

Port of veloslam_tpu/registration/gicp.py.  A target is a voxel-Gaussian
grid with a closed-form plane normal per voxel, plus a packed (V, 8) row
table [μ, n, 0, 0] that the association gathers from in one kernel
launch.  Correspondences come from the pre-dilated dense index (shared
map target, one gather per point; the bulk paths), from the plain dense
index with the exact nearest mean of seven cells (a shared target, the
per-frame pipeline), or from seven binary searches with a nearest-mean
choice (a shared target with no index: the streaming odometry's exact
search and the per-frame pipeline without a dense index; per-scan
targets: loop-closure verification).  Each
Gauss-Newton iteration with fixed correspondences is one
`normal_equations.gn_iteration` call for all F slots: the fused normal
equations, a damped 6×6 Cholesky solve, a step clamp and a left
retraction, on the card one kernel launch.
The JAX original vmaps `register` over slots; here F is a batch axis
throughout, and F stacked targets are leaves with a leading F.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.gather import gather_rows8
from veloslam_tpu_torch.registration.normal_equations import (
    fused_normal_equations, gn_iteration)

# The correspondence index of a shared target.
Index = Union[vx.DilatedIndex, vx.DenseIndex]


class GicpResult(NamedTuple):
    pose: se3.Pose              # (F, ...) target-frame pose of each scan
    n_matched: torch.Tensor     # (F,) int32 — correspondences, last iter
    mean_error: torch.Tensor    # (F,) float32 — mean |point-to-plane|
    iterations: int
    H: torch.Tensor             # (F, 6, 6) normal matrix of the last iter


class PlaneGrid(NamedTuple):
    """VoxelGrid augmented with per-voxel unit normals + validity, and the
    (V, 8) row table [μ, n, 0, 0] the association gathers from.  Stacked
    targets carry a leading F on every leaf."""

    grid: vx.VoxelGrid
    normal: torch.Tensor        # (V, 3)
    usable: torch.Tensor        # (V,) bool — enough points for a stable plane
    rows: torch.Tensor          # (V, 8) float32, contiguous


def make_plane_grid(grid: vx.VoxelGrid, normal, usable) -> PlaneGrid:
    """PlaneGrid with its packed row table, built once per target."""
    pad = torch.zeros_like(normal[..., :2])
    rows = torch.cat([grid.mean, normal, pad], dim=-1).contiguous()
    return PlaneGrid(grid=grid, normal=normal, usable=usable, rows=rows)


def plane_grid_from(grid: vx.VoxelGrid, *, min_points: int = 4,
                    min_planarity: float = 0.35) -> PlaneGrid:
    """Point-to-plane target from a VoxelGrid (or F stacked grids):
    normals + a usable gate (occupied, ≥ min_points, planarity
    (λ2 − λ3)/λ1 ≥ min_planarity)."""
    normal = vx.smallest_eigenvector(grid.cov)
    l1, l2, l3 = vx.eigvals3(grid.cov)
    planarity = (l2 - l3) / torch.clamp(l1, min=1e-12)
    usable = (grid.occupied & (grid.count >= min_points)
              & (planarity >= min_planarity))
    return make_plane_grid(grid, normal, usable)


def build_plane_grid(pts, mask, origin, voxel_size: float, *, capacity: int,
                     min_points: int = 4,
                     min_planarity: float = 0.35) -> PlaneGrid:
    """F scans (F, P, 3) + masks (F, P) → F stacked per-voxel plane
    targets, all keyed from one `origin` (3,) at one voxel size; the
    planarity gate rejects line-like voxels (one scan-ring arc) whose
    normal points radially."""
    F = pts.shape[0]
    f32 = dict(dtype=torch.float32, device=pts.device)
    grid = vx.build_grid(pts, mask, origin.expand(F, 3),
                         torch.full((F,), float(voxel_size), **f32),
                         capacity=capacity)
    return plane_grid_from(grid, min_points=min_points,
                           min_planarity=min_planarity)


def stack_plane_grids(grids) -> PlaneGrid:
    """Stack same-capacity PlaneGrids on a new leading axis for
    `register_batch` with per-scan targets (`dense=None`)."""
    return PlaneGrid(
        grid=vx.VoxelGrid(*(torch.stack(xs) for xs in
                            zip(*(g.grid for g in grids)))),
        normal=torch.stack([g.normal for g in grids]),
        usable=torch.stack([g.usable for g in grids]),
        rows=torch.stack([g.rows for g in grids]))


def associate(pts, mask, pose: se3.Pose, target: PlaneGrid,
              dense: Optional[Index] = None):
    """Correspondences at the CURRENT poses: per-point target plane
    (μ, n) as contiguous (F, P, 3) and the hit mask (F, P).

    A shared target (rows (V, 8)) comes with its DilatedIndex (one gather
    per point), its DenseIndex (the nearest usable mean of seven cells,
    `voxel.lookup_nearest_dense`), or no index (`dense=None`: the same
    choice by seven binary searches, `voxel.lookup_nearest` of all F·P
    points against the target stacked at F = 1); F stacked targets (rows
    (F, V, 8), `dense=None`) search slot by slot.  Either way (μ, n) come
    from one row-gather kernel launch."""
    F, P = mask.shape
    g = target.grid
    p = se3.apply(se3.Pose(pose.q[:, None], pose.t[:, None]), pts)
    if dense is None and target.rows.dim() == 3:
        idx = vx.lookup_nearest(g, p, mask, target.usable)
        V = target.rows.shape[1]
        rows = torch.clamp(idx, min=0) + V * torch.arange(
            F, dtype=torch.int32, device=pts.device)[:, None]
        table = target.rows.reshape(F * V, 8)
    else:
        if dense is None:
            idx = vx.lookup_nearest(vx.stack1(g), p.reshape(1, F * P, 3),
                                    mask.reshape(1, -1),
                                    target.usable[None]).reshape(F, P)
        elif isinstance(dense, vx.DenseIndex):
            idx = vx.lookup_nearest_dense(g, dense, p.reshape(-1, 3),
                                          mask.reshape(-1), target.usable
                                          ).reshape(F, P)
        else:
            idx = vx.lookup_dilated(g, dense, p, mask)
        rows = torch.clamp(idx, min=0)
        table = target.rows
    got = gather_rows8(table, rows.reshape(-1)).reshape(F, P, 8)
    return got[..., 0:3].contiguous(), got[..., 3:6].contiguous(), idx >= 0


def normal_equations_fixed(pts, pose: se3.Pose, mu, n, hit, *,
                           huber_delta: float = 0.5, max_dist: float = 2.0):
    """Linearization with FIXED correspondences for F slots:
    (H (F,6,6), b (F,6), mean error (F,), n_matched (F,) int32)."""
    H, b, err_sum, w_sum, n_hit = fused_normal_equations(
        pts, pose.q.contiguous(), pose.t.contiguous(), mu, n,
        hit.view(torch.uint8), huber_delta=huber_delta, max_dist=max_dist)
    return H, b, err_sum / torch.clamp(w_sum, min=1.0), n_hit


def normal_equations(pts, mask, pose: se3.Pose, target: PlaneGrid, *,
                     dense: Optional[Index] = None,
                     huber_delta: float = 0.5, max_dist: float = 2.0):
    """One full linearization (associate + linearize at the same poses):
    (H (F,6,6), b (F,6), err (F,), n_matched (F,))."""
    mu, n, hit = associate(pts, mask, pose, target, dense)
    return normal_equations_fixed(pts, pose, mu, n, hit,
                                  huber_delta=huber_delta, max_dist=max_dist)


def register_batch(pts, mask, target: PlaneGrid, init_poses: se3.Pose,
                   dense: Optional[Index] = None, *,
                   iterations: int = 16, damping: float = 1e-6,
                   huber_delta: float = 0.5, max_dist: float = 2.0,
                   reassociate_every: int = 1,
                   association: Optional[Callable] = None) -> GicpResult:
    """Gauss-Newton point-to-plane registration of F scans.  Fixed
    iteration count; correspondences are searched every
    `reassociate_every` iterations, by `association` (arguments and
    results as `associate`, which it defaults to; the per-frame
    pipeline's CUDA graph of it, `cudagraphs.GicpGraphs.associate`).

    Three uses, as in the JAX original:
      * odometry — every frame slot against one shared map target with
        its DilatedIndex, or with no index (binary search);
      * the per-frame pipeline — one scan against the map ROI with its
        DenseIndex, or with no index;
      * loop-closure verification — each candidate against its own target
        (F stacked targets, `dense=None`).

    Args:
      pts: (F, P, 3) source scans (contiguous float32).
      mask: (F, P) validity.
      init_poses: Pose with (F, 4) / (F, 3) leaves.
    """
    F = pts.shape[0]
    pose = se3.Pose(init_poses.q.contiguous(), init_poses.t.contiguous())
    err = torch.full((F,), float("inf"), dtype=torch.float32,
                     device=pts.device)
    n_hit = torch.zeros((F,), dtype=torch.int32, device=pts.device)
    H = torch.zeros((F, 6, 6), dtype=torch.float32, device=pts.device)
    search = associate if association is None else association
    k = max(int(reassociate_every), 1)
    done = 0
    while done < iterations:
        block = min(k, iterations - done)
        mu, n, hit0 = search(pts, mask, pose, target, dense)
        hit0 = hit0.view(torch.uint8)
        for _ in range(block):
            pose, H, _, err, n_hit, _ = gn_iteration(
                pts, pose, mu, n, hit0, damping=damping,
                huber_delta=huber_delta, max_dist=max_dist)
        done += block
    return GicpResult(pose=pose, n_matched=n_hit, mean_error=err,
                      iterations=iterations, H=H)


def register(pts, mask, target: PlaneGrid, init_pose: se3.Pose,
             dense: Optional[Index], **kw) -> GicpResult:
    """One scan ((P, 3), (P,), pose (4,)/(3,)) against one target:
    `register_batch` at F = 1, with the slot axis dropped."""
    res = register_batch(pts[None], mask[None], target,
                         se3.Pose(init_pose.q[None], init_pose.t[None]),
                         dense, **kw)
    return GicpResult(pose=se3.Pose(res.pose.q[0], res.pose.t[0]),
                      n_matched=res.n_matched[0],
                      mean_error=res.mean_error[0],
                      iterations=res.iterations, H=res.H[0])
