"""Map-sharded registration, data-parallel decode and edge-sharded
pose-graph solves over a rank mesh.

Port of veloslam_tpu/parallel/sharded.py.  Where the JAX package runs a
shard_map body on every device of a mesh, here every rank of the mesh
runs the body on its own block, and the collectives of parallel/dist.py
join the blocks:

  * Registration — "shard the map, replicate the scan": each rank holds
    its map shard as a PlaneGrid and matches the whole scan against it
    (the association's gather kernels), ONE all_gather on the "map" axis
    per association block merges the per-shard candidates into the
    global nearest correspondence per point, and the fixed-correspondence
    Gauss-Newton block then runs replicated (one normal-equations kernel
    call per iteration, `normal_equations.gn_iteration`).
  * Decode — packets are embarrassingly parallel: each "data" rank
    decodes its block, one all_gather returns the points in packet order.
  * Pose graph — edges and observations split over the "map" ranks; each
    assembles its dense normal-equation pieces, ONE all_reduce per GN
    iteration sums them, and the small solve runs replicated.

Every rank's host control flow is the same, and every rank ends each
collective with the same bits, so the replicas stay equal to the bit.
No kernel of its own: the collectives are NCCL or Gloo calls between the
port's kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.decode.decode import DeviceCalib, decode_packets
from veloslam_tpu_torch.graph.optimize import (_assemble_landmark_terms,
                                               _assemble_pose_system,
                                               _pose_step, _schur_step)
from veloslam_tpu_torch.graph.posegraph import GraphArrays
from veloslam_tpu_torch.parallel import dist
from veloslam_tpu_torch.parallel.mesh import Mesh, block, shard_to
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.gicp import PlaneGrid
from veloslam_tpu_torch.registration.normal_equations import gn_iteration


# --- map-sharded GICP --------------------------------------------------------

def plane_grid_specs(axis: str = "map") -> PlaneGrid:
    """Specs for a PlaneGrid sharded by voxel rows (for `mesh.shard_to`
    of a full grid)."""
    return PlaneGrid(
        grid=vx.VoxelGrid(keys=axis, count=axis, mean=axis, cov=axis,
                          origin=None, voxel_size=None),
        normal=axis, usable=axis, rows=axis)


def shard_plane_grid(mesh: Mesh, full: PlaneGrid,
                     axis: str = "map") -> PlaneGrid:
    """This rank's contiguous block of a full grid's rows (the JAX
    package's NamedSharding(mesh, plane_grid_specs())): its key range of
    the sorted table."""
    return shard_to(mesh, plane_grid_specs(axis), full)


def _pack_sums(*xs) -> torch.Tensor:
    return torch.cat([x.reshape(-1).to(torch.float32) for x in xs])


def sharded_normal_equations(mesh: Mesh, pts, mask, pose: se3.Pose,
                             target: PlaneGrid, *, huber_delta=0.5,
                             max_dist=2.0):
    """One linearization with the target grid sharded over "map": each
    rank's normal equations against its shard (binary-search association,
    the kernel's NE-only pass), then one all_reduce of H, b, err·n and n.
    Returns (H (6,6), b (6,), err (), n ())."""
    H, b, err, n = gicp.normal_equations(
        pts[None], mask[None], se3.Pose(pose.q[None], pose.t[None]),
        target, huber_delta=huber_delta, max_dist=max_dist)
    # err is a per-shard mean; weighted by n it sums exactly.
    sums = dist.all_reduce(mesh, _pack_sums(H[0], b[0], err * n, n))
    n_all = sums[43]
    return (sums[:36].reshape(6, 6), sums[36:42],
            sums[42] / torch.clamp(n_all, min=1.0), n_all.to(torch.int32))


def build_dense_sharded(mesh: Mesh, target: PlaneGrid) -> vx.DenseIndex:
    """This rank's shard's dense correspondence index, built once; pass it
    to register_sharded(dense=...) to reuse it across calls (the session
    keeps it with its ROI)."""
    del mesh
    return vx.build_dense_index(target.grid)


def associate_global(mesh: Mesh, pts, mask, pose: se3.Pose,
                     target: PlaneGrid, dense: Optional[vx.DenseIndex]):
    """Shard-local nearest + ONE all_gather → the global nearest (μ, n,
    hit) per point, equal on every rank.  A point near a shard boundary
    may have candidate voxels in several shards; the global
    distance-argmin (first minimum: the lowest map rank, as jnp.argmin)
    reproduces the single-device nearest-mean choice.  The candidate
    fields ride one packed (P, 8) float32 payload [μ, n, d², hit].

    pts (P, 3), mask (P,), pose (1, 4) / (1, 3); returns μ, n (1, P, 3)
    contiguous and hit (1, P) uint8."""
    mu, n, hit0 = gicp.associate(pts[None], mask[None], pose, target, dense)
    p = se3.apply(se3.Pose(pose.q[:, None], pose.t[:, None]), pts[None])
    d = p - mu
    d2 = torch.where(hit0, d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                     + d[..., 2] * d[..., 2], float("inf"))
    payload = torch.cat([mu[0], n[0], d2[0, :, None],
                         hit0[0, :, None].to(mu.dtype)], dim=-1)
    allp = dist.all_gather(mesh, payload, axis="map")         # (S, P, 8)
    best = torch.argmin(allp[..., 6], dim=0)                   # (P,)
    sel = torch.gather(allp, 0, best[None, :, None].expand(1, -1, 8))[0]
    return (sel[None, :, 0:3].contiguous(), sel[None, :, 3:6].contiguous(),
            (sel[None, :, 7] > 0.5).to(torch.uint8))


def register_sharded(mesh: Mesh, pts, mask, target: PlaneGrid,
                     init_pose: se3.Pose, *, iterations: int = 16,
                     damping: float = 1e-6, huber_delta: float = 0.5,
                     max_dist: float = 2.0, reassociate_every: int = 1,
                     use_dense: bool = False,
                     dense: Optional[vx.DenseIndex] = None
                     ) -> gicp.GicpResult:
    """Gauss-Newton registration of one scan (pts (P, 3), mask (P,), the
    same on every rank) against a map sharded over "map" (`target`: this
    rank's shard).  Same contract and association schedule as
    gicp.register: correspondences are searched every
    `reassociate_every` iterations (`associate_global`, one all_gather),
    and each fixed-correspondence iteration is one `gn_iteration` call —
    the same damped Cholesky step, guard, clamp and retraction as
    gicp.register's, so at one rank it is gicp.register.  Collectives per
    registration: ceil(iterations / reassociate_every).

    `use_dense` builds this shard's DenseIndex (the exact nearest mean of
    seven cells, as the per-frame pipeline associates); pass
    `dense=build_dense_sharded(mesh, target)` to reuse one across calls;
    neither: the binary-search lookup."""
    if dense is None and use_dense:
        dense = build_dense_sharded(mesh, target)
    F = 1
    dev = pts.device
    pose = se3.Pose(init_pose.q[None].contiguous(),
                    init_pose.t[None].contiguous())
    pts_f = pts[None].contiguous()
    err = torch.full((F,), float("inf"), dtype=torch.float32, device=dev)
    n_hit = torch.zeros((F,), dtype=torch.int32, device=dev)
    H = torch.zeros((F, 6, 6), dtype=torch.float32, device=dev)
    k = max(int(reassociate_every), 1)
    done = 0
    while done < iterations:
        n_block = min(k, iterations - done)
        mu, n, hit = associate_global(mesh, pts, mask, pose, target, dense)
        for _ in range(n_block):
            pose, H, _, err, n_hit, _ = gn_iteration(
                pts_f, pose, mu, n, hit, damping=damping,
                huber_delta=huber_delta, max_dist=max_dist)
        done += n_block
    return gicp.GicpResult(pose=se3.Pose(pose.q[0], pose.t[0]),
                           n_matched=n_hit[0], mean_error=err[0],
                           iterations=iterations, H=H[0])


# --- data-parallel decode ----------------------------------------------------

def decode_packets_sharded(mesh: Mesh, pkts_u8, calib: DeviceCalib, *,
                           model: str) -> torch.Tensor:
    """decode_packets' xyz with the packet axis split over "data": each
    "data" rank decodes its block of the (N, 1206) packets (the same on
    every rank), one all_gather returns all N packets' points, in packet
    order, on every rank.  Packets are independent (the azimuth-rate
    median is per packet), so this is pure data parallelism."""
    xyz = decode_packets(block(pkts_u8, mesh, "data"), calib,
                         model=model).xyz
    got = dist.all_gather(mesh, xyz, axis="data")
    return got.reshape((-1,) + tuple(xyz.shape[1:]))


# --- edge-sharded pose-graph solves --------------------------------------------

def graph_specs(axis: str = "map") -> GraphArrays:
    """Specs: pose and landmark state replicated, edges AND landmark
    observations split over `axis`."""
    return GraphArrays(
        q=None, t=None, n_poses=None,
        e_i=axis, e_j=axis, e_q=axis, e_t=axis, e_info=axis, e_valid=axis,
        l_pos=None, n_landmarks=None,
        o_i=axis, o_l=axis, o_z=axis, o_info=axis, o_valid=axis)


_EDGES = ("e_i", "e_j", "e_q", "e_t", "e_info", "e_valid")
_OBS = ("o_i", "o_l", "o_z", "o_info", "o_valid")


def _shard_graph(mesh: Mesh, g: GraphArrays,
                 with_landmarks: bool) -> GraphArrays:
    """This rank's block of the edges (and observations), the state
    whole.  An edge or observation count the "map" size does not divide
    raises."""
    cut = _EDGES + (_OBS if with_landmarks else ())
    return g._replace(**{f: block(getattr(g, f), mesh, "map")
                         for f in cut})


def _assembled(mesh: Mesh, g_local: GraphArrays, K: int, M: int,
               with_landmarks: bool):
    """This rank's normal-equation pieces, summed over "map" by one
    all_reduce of them packed in one buffer."""
    pieces = list(_assemble_pose_system(g_local, K))
    if with_landmarks:
        pieces.extend(_assemble_landmark_terms(g_local, K, M))
    flat = dist.all_reduce(mesh, _pack_sums(*pieces))
    out, at = [], 0
    for x in pieces:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return out


def solve_graph_step_sharded(mesh: Mesh, g: GraphArrays, *, max_poses: int,
                             damping: float = 1e-4,
                             prior_weight: float = 1e6):
    """One distributed Gauss-Newton step: edges split over "map", the
    dense normal equations all_reduce'd, the replicated solve and
    retraction.  `g` is the whole graph on every rank.  Returns (g′,
    cost)."""
    H, b, cost = _assembled(mesh, _shard_graph(mesh, g, False), max_poses,
                            1, False)
    return _pose_step(g, H, b, max_poses, damping, prior_weight), cost


def solve_graph_sharded(mesh: Mesh, g: GraphArrays, *, max_poses: int,
                        max_landmarks: int = 1, iterations: int = 8,
                        damping: float = 1e-4, prior_weight: float = 1e6,
                        with_landmarks: bool = False):
    """Distributed Gauss-Newton solve of a pose graph (optionally with
    Schur-eliminated landmarks): edges and observations split over "map",
    each rank's assembly (the per-landmark Schur coupling tensor T
    included) summed by ONE all_reduce per iteration, the small solve
    replicated.  Same contract as graph.optimize.solve /
    solve_with_landmarks; returns (g′, the last iteration's cost)."""
    K, M = max_poses, max_landmarks
    cost = torch.full((), float("inf"), device=g.q.device)
    for _ in range(iterations):
        local = _shard_graph(mesh, g, with_landmarks)
        out = _assembled(mesh, local, K, M, with_landmarks)
        if with_landmarks:
            H, b, cost_e, H_po, b_po, All, b_l, T, cost_o = out
            g = _schur_step(g, H, b, H_po, b_po, All, b_l, T, K, M,
                            damping, prior_weight)
            cost = cost_e + cost_o
        else:
            H, b, cost = out
            g = _pose_step(g, H, b, K, damping, prior_weight)
    return g, cost
