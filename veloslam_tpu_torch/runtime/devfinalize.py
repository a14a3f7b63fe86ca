"""End-of-stream SLAM finalize on the device: propose → verify → solve →
trajectory correction, with no host read until the caller reads the
results.

Port of veloslam_tpu/runtime/devfinalize.py:

  1. `propose_closures`: both proposal channels (position radius under
     the current estimates, scan-context appearance) scored on the
     device; a per-channel top-k, interleaved, then a greedy sequential
     pass that caps each keyframe's uses per channel;
  2. `verify_closures_device`: batched GICP against per-candidate
     targets (coarse 4× voxels, fine, and an unconditional reverse pass
     for reciprocal consistency) with the tightness and self-normalized
     observability gates;
  3. `solve_and_correct`: the pose graph (consecutive odometry edges +
     accepted closures) assembled on the device, solved (dense up to
     graph.pcg.DENSE_MAX_POSES keyframes, matrix-free PCG above), and
     the keyframe corrections slerp/lerp-interpolated onto the per-frame
     trajectory.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.segment import take
from veloslam_tpu_torch.core.timeline import interpolate_poses
from veloslam_tpu_torch.graph import pcg
from veloslam_tpu_torch.graph import scancontext as sc
from veloslam_tpu_torch.graph.posegraph import GraphArrays
from veloslam_tpu_torch.registration import gicp

# Correspondence re-association period inside the verification
# registrations (the JAX package's production value).
VERIFY_REASSOCIATE_EVERY = 4


class Candidates(NamedTuple):
    i: torch.Tensor        # (C,) int32
    j: torch.Tensor        # (C,) int32
    valid: torch.Tensor    # (C,) bool
    prior_q: torch.Tensor  # (C, 4) initial guess for T_i⁻¹∘T_j
    prior_t: torch.Tensor  # (C, 3)


def device_vector(values: Sequence[float], device) -> torch.Tensor:
    """float32 vector of host constants, filled on the device: a tensor
    built from a list, or an element assigned a Python float, is a
    host-to-device copy, which synchronizes the stream; `fill_` passes the
    value to the fill kernel."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for k, v in enumerate(values):
        out[k].fill_(float(v))
    return out


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k: the k largest, a lower index first among equal values
    (a stable descending sort; torch.topk orders ties arbitrarily)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """jnp.mod(x + π, 2π) − π as XLA computes it (an exact fmod, then a
    sign fix); torch.remainder divides and would round differently."""
    two_pi = 2.0 * math.pi
    r = torch.fmod(x + math.pi, two_pi)
    return torch.where(r < 0, r + two_pi, r) - math.pi


def propose_closures(desc, q, t, n, *, min_score: float, radius: float,
                     min_gap: int, max_candidates: int,
                     max_per_keyframe: int = 2,
                     use_scan_context: bool = True) -> Candidates:
    """Both loop-closure proposal channels on the device.

    Each channel keeps its own top 2·max_candidates pairs (position pairs
    valued 3 − d/radius, appearance pairs by score); the two lists are
    interleaved (pos[0], sc[0], pos[1], …) and a greedy pass takes an
    entry when it is finite, not already taken, and both keyframes have
    fewer than `max_per_keyframe` uses in its channel.  The pass is a
    loop of device ops over the 2·M entries with no host read."""
    K = desc.shape[0]
    dev = desc.device
    scores, shifts = sc.descriptor_scores(desc)
    ar = torch.arange(K, device=dev)
    valid = ar < n
    base = (valid[:, None] & valid[None, :]
            & (ar[None, :] - ar[:, None] >= min_gap))
    d = torch.linalg.vector_norm(t[:, None, :2] - t[None, :, :2], dim=-1)
    pos_ok = base & (d < radius)
    sc_ok = (base & (scores >= min_score) if use_scan_context
             else torch.zeros_like(base))
    neg = float("-inf")
    pos_val = torch.where(pos_ok, 3.0 - d / radius, neg)
    sc_val = torch.where(sc_ok, scores, neg)
    M = min(2 * max_candidates, K * K)
    pv, pidx = _top_k(pos_val.reshape(-1), M)
    sv, sidx = _top_k(sc_val.reshape(-1), M)
    flat_val = torch.stack([pv, sv], dim=1).reshape(-1)
    flat_idx = torch.stack([pidx, sidx], dim=1).reshape(-1)
    pairs = torch.stack([flat_idx // K, flat_idx % K], dim=1)    # (2M, 2)
    finite = torch.isfinite(flat_val)

    C = max_candidates
    taken = torch.zeros((2, K), dtype=torch.int32, device=dev)
    out = torch.zeros((C + 1, 2), dtype=torch.int64, device=dev)  # C: trash
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(C, device=dev)
    for e in range(2 * M):
        ch = e % 2                 # entries alternate position, appearance
        pair = pairs[e]
        used = taken[ch].index_select(0, pair).amax()
        dup = torch.any(torch.all(out[:C] == pair, dim=1) & (slot < cnt))
        ok = finite[e] & ~dup & (used < max_per_keyframe) & (cnt < C)
        inc = ok.to(torch.int32)
        taken[ch].index_add_(0, pair, inc.expand(2))
        out.index_copy_(0, torch.where(ok, cnt, C).reshape(1), pair[None])
        cnt = cnt + inc
    out_i, out_j = out[:C, 0], out[:C, 1]
    cand_valid = slot < cnt

    # Priors: position pairs from the current estimates; appearance-only
    # pairs from the best sector shift (zero translation).
    is_pos = pos_ok[out_i, out_j]
    rel = se3.relative(se3.Pose(q[out_i], t[out_i]),
                       se3.Pose(q[out_j], t[out_j]))
    yaw = -shifts[out_i, out_j].to(torch.float32) * (
        2.0 * math.pi / desc.shape[2])
    yaw = _wrap_pi(yaw)
    zero = torch.zeros_like(yaw)
    sc_q = torch.stack([torch.cos(yaw / 2), zero, zero,
                        torch.sin(yaw / 2)], dim=-1)
    prior_q = torch.where(is_pos[:, None], rel.q, sc_q)
    prior_t = torch.where(is_pos[:, None], rel.t, 0.0)
    return Candidates(i=out_i.to(torch.int32), j=out_j.to(torch.int32),
                      valid=cand_valid, prior_q=prior_q, prior_t=prior_t)


def _lam_min_per_match(H: torch.Tensor, n_matched: torch.Tensor
                       ) -> torch.Tensor:
    """Smallest eigenvalue of each (6, 6) GN normal matrix per
    correspondence; 0 for a matrix with a non-finite entry."""
    finite = torch.all(torch.isfinite(H), dim=(-2, -1))
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    Hs = torch.where(finite[:, None, None], H, eye)
    lam = torch.linalg.eigvalsh(Hs)[:, 0]
    lam = torch.where(finite, torch.clamp(lam, min=0.0), 0.0)
    return lam / torch.clamp(n_matched.to(lam.dtype), min=1.0)


def verify_closures_device(ring_pts, ring_msk, cand: Candidates, *,
                           voxel_size: float = 1.0, capacity: int = 16384,
                           iterations: int = 20,
                           max_mean_error: float = 0.05,
                           min_matches: int = 2000,
                           obs_accept: float = 0.75,
                           obs_reject: float = 0.10,
                           max_cycle_t: float = 0.3,
                           max_cycle_rot_deg: float = 2.0,
                           reassociate_every: int = 4):
    """Batched closure verification with per-candidate targets:
    accept = tight & rel_obs ≥ obs_reject & (rel_obs ≥ obs_accept |
    reciprocal cycle within max_cycle_t / max_cycle_rot_deg) & valid.
    The reverse pass runs for every candidate.

    Returns (meas_q (C,4), meas_t (C,3), accept (C,) bool)."""
    ci, cj = cand.i.long(), cand.j.long()
    pts_i = ring_pts[ci]
    msk_i = ring_msk[ci] & cand.valid[:, None]
    pts_j = ring_pts[cj]
    msk_j = ring_msk[cj] & cand.valid[:, None]
    origin = torch.zeros(3, dtype=torch.float32, device=ring_pts.device)
    C = cand.i.shape[0]

    # Coarse to fine: the appearance prior carries yaw but no
    # translation, and the search reaches ±1 voxel, so a 4× voxel pass
    # first pulls the pose into the fine basin.
    grids_c = gicp.build_plane_grid(pts_i, msk_i, origin, 4.0 * voxel_size,
                                    capacity=capacity // 4,
                                    min_planarity=0.05)
    res_c = gicp.register_batch(pts_j, msk_j, grids_c,
                                se3.Pose(cand.prior_q, cand.prior_t),
                                iterations=6,
                                max_dist=6.0 * voxel_size,
                                reassociate_every=2)
    grids_i = gicp.build_plane_grid(pts_i, msk_i, origin, voxel_size,
                                    capacity=capacity)
    res = gicp.register_batch(pts_j, msk_j, grids_i, res_c.pose,
                              iterations=iterations,
                              reassociate_every=reassociate_every)
    H_self, _, _, n_self = gicp.normal_equations(
        pts_i, msk_i, se3.Pose.identity((C,), device=ring_pts.device),
        grids_i)

    tight = ((res.n_matched >= min_matches)
             & (res.mean_error <= max_mean_error)
             & torch.all(torch.isfinite(res.pose.t), dim=-1))
    ceiling = _lam_min_per_match(H_self, n_self)
    rel_obs = (_lam_min_per_match(res.H, res.n_matched)
               / torch.clamp(ceiling, min=1e-12))

    # Reverse pass (reciprocal consistency), computed for every slot.
    grids_j = gicp.build_plane_grid(pts_j, msk_j, origin, voxel_size,
                                    capacity=capacity)
    bwd = gicp.register_batch(pts_i, msk_i, grids_j, se3.inverse(res.pose),
                              iterations=iterations,
                              reassociate_every=reassociate_every)
    comp = se3.compose(res.pose, bwd.pose)
    cyc_t = torch.linalg.vector_norm(comp.t, dim=-1)
    cyc_r = 2.0 * torch.arccos(torch.clamp(torch.abs(comp.q[:, 0]), 0.0,
                                           1.0))
    cycle_ok = ((cyc_t <= max_cycle_t)
                & (cyc_r <= math.radians(max_cycle_rot_deg)))

    accept = (tight & (rel_obs >= obs_reject)
              & ((rel_obs >= obs_accept) | cycle_ok) & cand.valid)
    return res.pose.q, res.pose.t, accept


def solve_and_correct(kf_q, kf_t, kf_time_rel_s, n_kf, cand: Candidates,
                      meas_q, meas_t, accept, odom_info, closure_info,
                      traj_q, traj_t, traj_time, n_frames, *,
                      gn_iterations: int = 8):
    """Assemble the pose graph on the device, solve it, and carry the
    keyframe corrections onto the per-frame trajectory (slerp/lerp over
    keyframe times: exact at keyframes, smooth between).  A solve that
    failed numerically (non-finite poses) degrades to no correction.

    Returns (solved_q, solved_t, traj_q, traj_t, n_accepted, stats,
    rel_q, rel_t), rel being the consecutive odometry-edge
    measurements."""
    K = kf_q.shape[0]
    C = cand.i.shape[0]
    dev = kf_q.device
    i32 = dict(dtype=torch.int32, device=dev)
    rel = se3.relative(se3.Pose(kf_q[:-1], kf_t[:-1]),
                       se3.Pose(kf_q[1:], kf_t[1:]))
    g = GraphArrays(
        q=kf_q, t=kf_t, n_poses=n_kf,
        e_i=torch.cat([torch.arange(K - 1, **i32), cand.i]),
        e_j=torch.cat([torch.arange(1, K, **i32), cand.j]),
        e_q=torch.cat([rel.q, meas_q]), e_t=torch.cat([rel.t, meas_t]),
        e_info=torch.cat([odom_info.expand(K - 1, 6),
                          closure_info.expand(C, 6)]),
        e_valid=torch.cat([torch.arange(K - 1, device=dev) < (n_kf - 1),
                           accept]),
        l_pos=torch.zeros((1, 3), device=dev),
        n_landmarks=torch.zeros((), **i32),
        o_i=torch.zeros(1, **i32), o_l=torch.zeros(1, **i32),
        o_z=torch.zeros((1, 3), device=dev),
        o_info=torch.zeros((1, 3), device=dev),
        o_valid=torch.zeros(1, dtype=torch.bool, device=dev))
    out, stats = pcg.solve_auto(g, max_poses=K, iterations=gn_iterations)
    good = torch.all(torch.isfinite(out.q)) & torch.all(torch.isfinite(out.t))
    sq = torch.where(good, out.q, kf_q)
    st = torch.where(good, out.t, kf_t)

    # Keyframe corrections → per-frame trajectory.
    corr = se3.compose(se3.Pose(sq, st), se3.inverse(se3.Pose(kf_q, kf_t)))
    last = torch.clamp(n_kf - 1, min=0)
    ar = torch.arange(K, device=dev)
    kidx = torch.minimum(ar, last)
    kt = torch.where(ar < n_kf, kf_time_rel_s,
                     take(kf_time_rel_s, last)
                     + 1e3 * (ar.to(torch.float32) - last))
    c = interpolate_poses(kt, corr.q[kidx], corr.t[kidx],
                          torch.zeros((K, 3), device=dev), traj_time)
    fixed = se3.compose(c, se3.Pose(traj_q, traj_t))
    row = (torch.arange(traj_q.shape[0], device=dev) < n_frames)[:, None]
    new_q = torch.where(row, fixed.q, traj_q)
    new_t = torch.where(row, fixed.t, traj_t)
    n_accepted = torch.sum(accept.to(torch.int32))
    return sq, st, new_q, new_t, n_accepted, stats, rel.q, rel.t
