"""Landmark association: post detections → pose-graph observations.

A host numpy copy of the batched path of
veloslam_tpu/graph/landmark_assoc.py (the JAX package runs this stage in
numpy too): posts extracted from every keyframe scan in one fused voxel
pass become graph landmarks observed from several keyframes, the work
the Schur-complement solver (graph.optimize.solve_with_landmarks)
eliminates.  tests/test_torch_landmarks.py holds the copy equal,
observation order included.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from veloslam_tpu_torch.graph.posegraph import PoseGraph
from veloslam_tpu_torch.map.landmarks import extract_posts


def _post_anchors(posts: np.ndarray,
                  sensor_frame: bool = False) -> np.ndarray:
    """(K, 5) post records → (K, 3) anchors (column centre at mid height).

    Viewpoint-bias correction (`sensor_frame=True`, sensor at the origin):
    the lidar only hits the near side of a cylindrical post, so the
    hit-point centroid sits (2/π)·R in front of the axis.  The detector's
    radius estimate is the hit cloud's horizontal sigma, σ ≈ 0.77 R, so the
    centroid offset (2/π)R ≈ 0.83 σ: the anchor is pushed that far away
    from the sensor along the horizontal bearing."""
    xy = posts[:, :2].copy()
    if sensor_frame and len(posts):
        rng = np.linalg.norm(xy, axis=1)
        u = xy / np.maximum(rng[:, None], 1e-6)
        push = np.clip(0.83 * posts[:, 4], 0.0, 0.4)
        xy = xy + u * push[:, None]
    return np.stack([xy[:, 0], xy[:, 1],
                     posts[:, 2] + 0.5 * posts[:, 3]], -1)


def extract_scan_posts_batch(pts: np.ndarray, mask: np.ndarray,
                             voxel_size: float = 0.5,
                             capacity: int = 8192) -> List[np.ndarray]:
    """Per-scan post detection for K stacked sensor-frame scans, host
    only: one fused voxel-stats pass over all K scans (the scan index
    folded into the voxel key), then `extract_posts` per scan.  Returns K
    arrays of (Mk, 3) post anchors."""
    K = len(pts)
    if K == 0:
        return []
    half = 512
    p_all = np.asarray(pts, np.float32).reshape(-1, 3)
    m_all = np.asarray(mask, bool).reshape(-1)
    scan = np.repeat(np.arange(K, dtype=np.int64), pts.shape[1])
    g = np.floor(p_all / np.float32(voxel_size)).astype(np.int64) + half
    ok = m_all & np.all((g >= 0) & (g < 1024), axis=1)
    p, g, scan = p_all[ok], g[ok], scan[ok]
    keys = (scan << 30) | (g[:, 0] << 20) | (g[:, 1] << 10) | g[:, 2]
    uk, inv, count = np.unique(keys, return_inverse=True,
                               return_counts=True)
    V = len(uk)
    s1 = np.zeros((V, 3))
    np.add.at(s1, inv, p)
    mean = s1 / count[:, None]
    d = p - mean[inv]
    s2 = np.zeros((V, 3, 3))
    np.add.at(s2, inv, d[:, :, None] * d[:, None, :])
    cov = s2 / count[:, None, None]
    coords = np.stack([(uk >> 20) & 1023, (uk >> 10) & 1023,
                       uk & 1023], -1) - half
    vk = (uk >> 30).astype(np.int64)            # owning scan per voxel
    count = count.astype(np.float32)
    mean = mean.astype(np.float32)
    cov = cov.astype(np.float32)

    out: List[np.ndarray] = []
    starts = np.searchsorted(vk, np.arange(K + 1))
    for k in range(K):
        sl = slice(starts[k], starts[k + 1])
        if sl.start == sl.stop:
            out.append(np.zeros((0, 3)))
            continue
        posts = extract_posts(coords[sl], count[sl], mean[sl], cov[sl],
                              voxel_size)
        if len(posts) == 0:
            out.append(np.zeros((0, 3)))
        else:
            out.append(_post_anchors(posts, sensor_frame=True))
    return out


def associate_and_add(graph: PoseGraph,
                      keyframe_posts: List[np.ndarray],
                      radius: float = 1.0,
                      min_observations: int = 2,
                      obs_info: float = 25.0) -> Tuple[int, int]:
    """Cluster per-keyframe post detections into landmarks and add them and
    their observations to the graph.

    keyframe_posts[k]: (Mk, 3) sensor-frame detections of keyframe k
    (aligned with graph pose k).  Detections are lifted to world by the
    current pose estimates, greedily clustered by `radius` in world xy,
    and clusters seen from ≥ min_observations keyframes become graph
    landmarks with sensor-frame observations.  Returns (n_landmarks,
    n_observations)."""
    q, t = graph.poses()
    world_det = []                 # (k, sensor_xyz, world_xyz)
    for k, dets in enumerate(keyframe_posts):
        if k >= len(q) or len(dets) == 0:
            continue
        w0, x, y, z = (float(q[k][0]), float(q[k][1]), float(q[k][2]),
                       float(q[k][3]))
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z),
             2 * (x * z + w0 * y)],
            [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w0 * x)],
            [2 * (x * z - w0 * y), 2 * (y * z + w0 * x),
             1 - 2 * (x * x + y * y)]], np.float32)
        w = np.asarray(dets, np.float32) @ R.T + np.asarray(t[k],
                                                           np.float32)
        for d, wp in zip(dets, w):
            world_det.append((k, d, wp))
    if not world_det:
        return 0, 0

    # Greedy clustering in world xy.
    centers: List[np.ndarray] = []
    members: List[List[int]] = []
    for i, (_, _, wp) in enumerate(world_det):
        placed = False
        for c_idx, c in enumerate(centers):
            if np.linalg.norm(wp[:2] - c[:2]) < radius:
                n = len(members[c_idx])
                centers[c_idx] = (c * n + wp) / (n + 1)
                members[c_idx].append(i)
                placed = True
                break
        if not placed:
            centers.append(wp.copy())
            members.append([i])

    n_lm = n_obs = 0
    for c, mem in zip(centers, members):
        kfs = {world_det[i][0] for i in mem}
        if len(kfs) < min_observations:
            continue
        lm = graph.add_landmark(c)
        n_lm += 1
        for i in mem:
            k, d, _ = world_det[i]
            graph.add_observation(k, lm, d, info=(obs_info,) * 3)
            n_obs += 1
    return n_lm, n_obs
