"""Distribution-to-distribution (D2D) registration: voxel Gaussians of the
source scan against voxel Gaussians of the target.

Port of veloslam_tpu/registration/d2d.py.  The residual per source voxel
is r = T·μ_s − μ_t, weighted by W = (Σ'_t + R Σ'_s Rᵀ + εI)⁻¹ over
scale-normalized covariances (`voxel.normalized_cov`) and the source
voxel's point count; J = [−[T·μ_s]ₓ | I].  The cost runs over source
VOXELS (at most the scan grid's capacity), each matched to the nearest
usable target mean among its own cell and six face neighbours
(`voxel.lookup_nearest` on the target stacked at F = 1, one `gather_i32`
launch per Gauss-Newton iteration).  The 3×3 algebra is closed form and
batched, and H, b are torch einsums (no Pallas original).  Each step is
the D2D/NDT variant of the guarded, clamped Cholesky step
(`normal_equations._gn_delta_shifted`), with no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.normal_equations import (
    _gn_delta_shifted)


class D2dResult(NamedTuple):
    pose: se3.Pose
    n_matched: torch.Tensor     # () int32 — source voxels matched
    mean_error: torch.Tensor    # () float32 — mean Mahalanobis residual
    iterations: int


# Structure-aware target gate (shared with NDT).
usable_mask = vx.structure_usable


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1)], -2)


def _normal_equations(src: vx.VoxelGrid, pose: se3.Pose,
                      target: vx.VoxelGrid, stacked: vx.VoxelGrid, usable,
                      src_cov, tgt_cov, *, eps: float, max_dist: float,
                      min_points: float):
    R = se3.quat_to_matrix(pose.q)                          # (3, 3)
    mu_s = se3.apply(pose, src.mean)                        # (V, 3)
    src_ok = src.occupied & (src.count >= min_points)
    idx = vx.lookup_nearest(stacked, mu_s[None], src_ok[None],
                            usable[None])[0]
    safe = torch.clamp(idx, min=0).long()
    r = mu_s - target.mean[safe]
    hit = (idx >= 0) & (torch.sum(r * r, -1) < max_dist * max_dist)
    cov_s_rot = torch.einsum("ij,vjk,lk->vil", R, src_cov, R)
    W = vx.regularized_inverse(tgt_cov[safe] + cov_s_rot, eps=eps)
    w = torch.where(hit, src.count, 0.0)                    # count-weighted
    W = W * w[:, None, None]
    eye = torch.eye(3, dtype=mu_s.dtype, device=mu_s.device)
    J = torch.cat([-_skew(mu_s), eye.expand(*mu_s.shape, 3)], dim=-1)
    WJ = torch.einsum("vij,vjk->vik", W, J)                 # (V, 3, 6)
    H = torch.einsum("vji,vjk->ik", J, WJ)
    b = torch.einsum("vji,vjk,vk->i", J, W, r)
    maha = torch.einsum("vi,vij,vj->v", r, W, r)
    err = torch.sum(maha) / torch.clamp(torch.sum(w), min=1.0)
    return H, b, err, hit.sum(dtype=torch.int32)


def d2d_normal_equations(src: vx.VoxelGrid, pose: se3.Pose,
                         target: vx.VoxelGrid, usable, *, eps: float = 1e-3,
                         max_dist: float = 2.0, min_points: float = 3.0,
                         src_cov: Optional[torch.Tensor] = None,
                         tgt_cov: Optional[torch.Tensor] = None):
    """One linearization of the D2D cost at `pose` ((4,) / (3,)):
    (H (6, 6), b (6,), err (), matched source voxels () int32).  A source
    voxel takes part when occupied with at least `min_points` points, its
    search finds a usable target voxel and |r|² < max_dist².  Pass the
    normalized covariance tables `src_cov` / `tgt_cov` to reuse them
    across iterations."""
    if src_cov is None:
        src_cov = vx.normalized_cov(src.cov)
    if tgt_cov is None:
        tgt_cov = vx.normalized_cov(target.cov)
    return _normal_equations(src, pose, target, vx.stack1(target), usable,
                             src_cov, tgt_cov, eps=eps, max_dist=max_dist,
                             min_points=min_points)


def register_d2d(src: vx.VoxelGrid, target: vx.VoxelGrid, usable,
                 init_pose: se3.Pose, *, iterations: int = 16,
                 damping: float = 1e-6, eps: float = 1e-3,
                 max_dist: float = 2.0) -> D2dResult:
    """Gauss-Newton D2D registration of a source grid onto a target grid
    (`usable` gates the target voxels), a fixed number of iterations; each
    step damped by damping + 1e-6·trace(H), zeroed unless finite, positive
    definite and over 10 matches, clamped to 1 m / 0.3 rad.  No host
    read."""
    src_cov = vx.normalized_cov(src.cov)      # computed once for all steps
    tgt_cov = vx.normalized_cov(target.cov)
    stacked = vx.stack1(target)
    pose = se3.Pose(init_pose.q[None], init_pose.t[None])
    err = torch.full((), float("inf"), dtype=torch.float32,
                     device=src.mean.device)
    n_hit = torch.zeros((), dtype=torch.int32, device=src.mean.device)
    for _ in range(iterations):
        H, b, err, n_hit = _normal_equations(
            src, se3.Pose(pose.q[0], pose.t[0]), target, stacked, usable,
            src_cov, tgt_cov, eps=eps, max_dist=max_dist, min_points=3.0)
        delta, _, _ = _gn_delta_shifted(H[None], b[None], n_hit[None],
                                        damping)
        pose = se3.retract(pose, delta)
    return D2dResult(pose=se3.Pose(pose.q[0], pose.t[0]), n_matched=n_hit,
                     mean_error=err, iterations=iterations)


def register_scans_d2d(src_pts, src_mask, tgt_pts, tgt_mask, origin,
                       voxel_size, *, capacity: int = 8192,
                       init_pose: Optional[se3.Pose] = None,
                       iterations: int = 16,
                       min_points: int = 3) -> D2dResult:
    """Scan-to-scan D2D: voxelize both scans from one origin (3,) and
    voxel size (a () tensor), then `register_d2d`."""
    src = vx.build_grid(src_pts, src_mask, origin, voxel_size,
                        capacity=capacity)
    tgt = vx.build_grid(tgt_pts, tgt_mask, origin, voxel_size,
                        capacity=capacity)
    usable = usable_mask(tgt, min_points=min_points)
    if init_pose is None:
        init_pose = se3.Pose.identity(device=src_pts.device)
    return register_d2d(src, tgt, usable, init_pose, iterations=iterations)
