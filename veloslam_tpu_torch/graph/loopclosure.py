"""Loop-closure candidate detection and verification for the per-frame
pipeline: host proposal over keyframe positions, GICP verification of the
candidates' scans on the device, the accept decision on the host.

Port of veloslam_tpu/graph/loopclosure.py.  A candidate (i, j) is
accepted when keyframe j's scan registers against keyframe i's (coarse
4× voxels, then fine) tightly enough (matches, mean residual) and is not
perceptually aliased: the smallest eigenvalue per match of the fit's
normal matrix, against the same of scan i registered to itself (the
scene's own ceiling), must reach `obs_reject`; in the gray zone below
`obs_accept` a reverse registration must close the round trip within
`max_cycle_t` / `max_cycle_rot_deg`.  The registrations run on the
scans' device; their results are read back once, and the eigenvalues and
the accept decision are host numpy, as in the JAX package (the reverse
pass runs only when a candidate lands in the gray zone).  The device
finalize of the batched path takes the same decision on the device
(runtime/devfinalize.py::verify_closures_device).

Measured poses come back as se3.Pose with numpy float32 leaves.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.utils.profiling import sync_span


def find_candidates(positions: np.ndarray, *, radius: float = 15.0,
                    min_gap: int = 50, max_per_keyframe: int = 1
                    ) -> List[Tuple[int, int]]:
    """Keyframe index pairs (i < j) that are spatially close but temporally
    distant — potential loop closures (host numpy), nearest first."""
    n = len(positions)
    if n == 0:
        return []
    d = np.linalg.norm(positions[:, None, :2] - positions[None, :, :2],
                       axis=-1)
    cands: List[Tuple[int, int]] = []
    taken = np.zeros(n, np.int64)
    ii, jj = np.nonzero((d < radius) & (np.triu(np.ones((n, n), bool),
                                                k=min_gap)))
    order = np.argsort(d[ii, jj])
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if taken[i] >= max_per_keyframe or taken[j] >= max_per_keyframe:
            continue
        taken[i] += 1
        taken[j] += 1
        cands.append((i, j))
    return cands


def _lam_min_per_match(H: np.ndarray, n_matched: int) -> float:
    """Smallest eigenvalue of a 6x6 GN normal matrix per correspondence
    (H scales with the matches, so this removes the overlap confound)."""
    if not np.all(np.isfinite(H)):
        return 0.0
    lam = float(np.linalg.eigvalsh(H)[0])
    return max(lam, 0.0) / max(int(n_matched), 1)


def _cycle_error(fwd: se3.Pose, bwd: se3.Pose) -> Tuple[float, float]:
    """(translation m, rotation deg) of the forward∘backward round trip,
    float32 as the JAX package computes it."""
    def pose(p):
        return se3.Pose(torch.as_tensor(np.asarray(p.q, np.float32)),
                        torch.as_tensor(np.asarray(p.t, np.float32)))

    comp = se3.compose(pose(fwd), pose(bwd))
    t = float(torch.linalg.vector_norm(comp.t))
    ang = float(2.0 * torch.arccos(torch.clamp(torch.abs(comp.q[0]), 0.0,
                                               1.0)))
    return t, math.degrees(ang)


def _read(*xs: torch.Tensor) -> List[np.ndarray]:
    """Read (C, ...) tensors back in one transfer (float32; the integer
    counts involved are exact in it): one host synchronization."""
    C = xs[0].shape[0]
    flat = torch.cat([x.reshape(C, -1).to(torch.float32) for x in xs], 1)
    with sync_span(flat):
        host = flat.cpu().numpy()
    out, col = [], 0
    for x in xs:
        w = int(np.prod(x.shape[1:], dtype=np.int64))
        out.append(host[:, col:col + w].reshape(x.shape))
        col += w
    return out


def _origin(pts: torch.Tensor) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float32, device=pts.device)


def _forward(pts_i, mask_i, pts_j, mask_j, rel_priors: se3.Pose, *,
             voxel_size: float, capacity: int, iterations: int):
    """Register each scan j against scan i (coarse 4× voxels, then fine)
    and scan i against its own fine grid at identity: (fine result,
    H_self, n_self, fine grids of i), all on the device."""
    C = pts_i.shape[0]
    grids_c = gicp.build_plane_grid(pts_i, mask_i, _origin(pts_i),
                                    4.0 * voxel_size,
                                    capacity=capacity // 4,
                                    min_planarity=0.05)
    res_c = gicp.register_batch(pts_j, mask_j, grids_c, rel_priors,
                                iterations=6, max_dist=6.0 * voxel_size)
    grids_i = gicp.build_plane_grid(pts_i, mask_i, _origin(pts_i),
                                    voxel_size, capacity=capacity)
    res = gicp.register_batch(pts_j, mask_j, grids_i, res_c.pose,
                              iterations=iterations)
    H_self, _, _, n_self = gicp.normal_equations(
        pts_i, mask_i, se3.Pose.identity((C,), device=pts_i.device), grids_i)
    return res, H_self, n_self


def _backward(pts_i, mask_i, pts_j, mask_j, fwd: se3.Pose, *,
              voxel_size: float, capacity: int, iterations: int):
    """Register each scan i against scan j's fine grid from the inverted
    forward measurement; returns the poses read back (q, t)."""
    grids_j = gicp.build_plane_grid(pts_j, mask_j, _origin(pts_j),
                                    voxel_size, capacity=capacity)
    bwd = gicp.register_batch(pts_i, mask_i, grids_j, se3.inverse(fwd),
                              iterations=iterations)
    return _read(bwd.pose.q, bwd.pose.t)


def verify_closure(pts_i, mask_i, pts_j, mask_j, rel_prior: se3.Pose,
                   *, voxel_size: float = 1.0, capacity: int = 16384,
                   iterations: int = 20,
                   max_mean_error: float = 0.05,
                   min_matches: int = 2000,
                   obs_accept: float = 0.75,
                   obs_reject: float = 0.10,
                   max_cycle_t: float = 0.3,
                   max_cycle_rot_deg: float = 2.0) -> Optional[se3.Pose]:
    """Register keyframe j's scan (P, 3) + mask (P,) against keyframe i's
    (tensors on one device); accept if the converged fit is tight and not
    perceptually aliased (see the module docstring).  `rel_prior` (q (4,),
    t (3,) on that device) is the initial guess for T_i⁻¹∘T_j.  Returns
    the measured relative pose or None: `verify_closures_batch` at C = 1."""
    return verify_closures_batch(
        pts_i[None], mask_i[None], pts_j[None], mask_j[None],
        se3.Pose(rel_prior.q[None], rel_prior.t[None]),
        voxel_size=voxel_size, capacity=capacity, iterations=iterations,
        max_mean_error=max_mean_error, min_matches=min_matches,
        obs_accept=obs_accept, obs_reject=obs_reject,
        max_cycle_t=max_cycle_t, max_cycle_rot_deg=max_cycle_rot_deg)[0]


def verify_closures_batch(pts_i, mask_i, pts_j, mask_j,
                          rel_priors: se3.Pose, *,
                          voxel_size: float = 1.0, capacity: int = 16384,
                          iterations: int = 20,
                          max_mean_error: float = 0.05,
                          min_matches: int = 2000,
                          obs_accept: float = 0.75,
                          obs_reject: float = 0.10,
                          max_cycle_t: float = 0.3,
                          max_cycle_rot_deg: float = 2.0
                          ) -> List[Optional[se3.Pose]]:
    """Verify C candidate pairs together: pts_i/pts_j (C, P, 3),
    mask_i/mask_j (C, P) and rel_priors ((C, 4), (C, 3)) on one device;
    one reverse pass for the whole batch only if some candidate lands in
    the observability gray zone.  Returns, per candidate, the measured
    relative pose or None: rejected below `min_matches` matches, above
    `max_mean_error`, with a non-finite translation, below `obs_reject`,
    or in the gray zone with a round trip beyond `max_cycle_t` /
    `max_cycle_rot_deg`."""
    kw = dict(voxel_size=voxel_size, capacity=capacity,
              iterations=iterations)
    res, H_self, n_self = _forward(pts_i, mask_i, pts_j, mask_j,
                                   rel_priors, **kw)
    n_matched, mean_error, q, t, Hs, H_self, n_self = _read(
        res.n_matched, res.mean_error, res.pose.q, res.pose.t, res.H,
        H_self, n_self)
    C = len(n_matched)
    rel_obs = np.zeros(C)
    tight = np.zeros(C, bool)
    for k in range(C):
        tight[k] = (n_matched[k] >= min_matches
                    and mean_error[k] <= max_mean_error
                    and np.all(np.isfinite(t[k])))
        if tight[k]:
            ceiling = _lam_min_per_match(H_self[k], int(n_self[k]))
            rel_obs[k] = (_lam_min_per_match(Hs[k], int(n_matched[k]))
                          / max(ceiling, 1e-12))

    gray = tight & (rel_obs >= obs_reject) & (rel_obs < obs_accept)
    cycle_ok = np.ones(C, bool)
    if np.any(gray):
        bq, bt = _backward(pts_i, mask_i, pts_j, mask_j, res.pose, **kw)
        for k in np.nonzero(gray)[0]:
            cyc_t, cyc_r = _cycle_error(se3.Pose(q[k], t[k]),
                                        se3.Pose(bq[k], bt[k]))
            cycle_ok[k] = (cyc_t <= max_cycle_t
                           and cyc_r <= max_cycle_rot_deg)

    out: List[Optional[se3.Pose]] = []
    for k in range(C):
        ok = tight[k] and rel_obs[k] >= obs_reject and (
            rel_obs[k] >= obs_accept or cycle_ok[k])
        out.append(se3.Pose(q[k], t[k]) if ok else None)
    return out
