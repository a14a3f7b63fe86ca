"""Parity of the port's landmark stage (host numpy copies) with the JAX
package: post extraction from stacked keyframe scans and the greedy
association into graph landmarks and observations.

Seeded synthetic keyframe scans, each in its sensor frame: the near
halves of 0.2 m posts (0-3 m tall) seen from 10 keyframes along a
curve, a ground plane and a wall whose columns form a run (rejected as
posts), with 2 cm noise.  Detections per scan equal (they are the same
float64 numpy arithmetic); the graphs after association hold equal
landmarks and observations, in the same order; extract_posts and the
Landmarks record round trip equal."""

import numpy as np

from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.graph import landmark_assoc as jla
from veloslam_tpu.graph.posegraph import PoseGraph as JPoseGraph
from veloslam_tpu.map import landmarks as jlm
from veloslam_tpu_torch.graph import landmark_assoc as la
from veloslam_tpu_torch.graph.posegraph import PoseGraph
from veloslam_tpu_torch.map import landmarks as lm


def keyframe_scans(K=10, P=8192, seed=0):
    rng = np.random.default_rng(seed)
    posts = np.stack([rng.uniform(-20, 20, 8), rng.uniform(-6, 14, 8)], -1)
    yaw = np.linspace(0, 0.8, K)
    kf_t = np.stack([np.linspace(-10, 10, K), 0.5 * np.sin(yaw * 3),
                     np.zeros(K)], -1)
    kf_q = np.stack([np.cos(yaw / 2), np.zeros(K), np.zeros(K),
                     np.sin(yaw / 2)], -1)
    pts = np.zeros((K, P, 3), np.float32)
    msk = np.zeros((K, P), bool)
    for k in range(K):
        c, s = np.cos(yaw[k]), np.sin(yaw[k])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        world = []
        for px, py in posts:
            # the near half of the post as seen from keyframe k
            facing = np.arctan2(kf_t[k, 1] - py, kf_t[k, 0] - px)
            a = facing + rng.uniform(-np.pi / 2, np.pi / 2, 300)
            world.append(np.stack([px + 0.2 * np.cos(a),
                                   py + 0.2 * np.sin(a),
                                   rng.uniform(0, 3, 300)], -1))
        world.append(np.stack([rng.uniform(-25, 25, 2000),
                               rng.uniform(-10, 20, 2000),
                               np.zeros(2000)], -1))             # ground
        world.append(np.stack([rng.uniform(-15, 15, 2000),
                               np.full(2000, 18.0),
                               rng.uniform(0, 4, 2000)], -1))     # wall
        w = np.concatenate(world)
        w = w + rng.normal(0, 0.02, w.shape)
        local = (w - kf_t[k]) @ R
        n = min(len(local), P)
        pts[k, :n] = local[:n]
        msk[k, :n] = True
    msk[:, ::7] = False
    return pts, msk, kf_q.astype(np.float32), kf_t.astype(np.float32)


def test_extract_scan_posts_batch_matches_jax():
    pts, msk, _, _ = keyframe_scans()
    ours = la.extract_scan_posts_batch(pts, msk)
    ref = jla.extract_scan_posts_batch(pts, msk)
    assert len(ours) == len(ref) == len(pts)
    assert sum(len(d) for d in ref) >= 40
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_associate_and_add_matches_jax():
    pts, msk, q, t = keyframe_scans()
    det = la.extract_scan_posts_batch(pts, msk)
    graphs = (PoseGraph(max_poses=16), JPoseGraph(max_poses=16))
    for g in graphs:
        for k in range(len(q)):
            g.add_pose(q[k], t[k])
    got = la.associate_and_add(graphs[0], det, radius=1.2,
                               min_observations=2, obs_info=8.0)
    want = jla.associate_and_add(graphs[1], det, radius=1.2,
                                 min_observations=2, obs_info=8.0)
    assert got == want and want[0] >= 6
    ours, ref = graphs
    for f, n in (("l_pos", ref.n_landmarks), ("o_i", ref.n_obs),
                 ("o_l", ref.n_obs), ("o_z", ref.n_obs),
                 ("o_info", ref.n_obs)):
        np.testing.assert_array_equal(getattr(ours, f)[:n],
                                      getattr(ref, f)[:n], err_msg=f)


def test_extract_posts_and_landmarks_record_equal():
    rng = np.random.default_rng(5)
    V = 400
    coords = rng.integers(-20, 20, (V, 3))
    coords[:60] = np.stack([np.full(60, 3), np.full(60, 4),
                            np.arange(60) % 6], -1)       # a stacked column
    count = rng.integers(1, 30, V).astype(np.float32)
    mean = rng.normal(0, 5, (V, 3)).astype(np.float32)
    A = rng.normal(0, 0.1, (V, 3, 3))
    cov = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    cov[:60, 2, 2] += 0.5                                  # vertical lines
    ours = lm.extract_posts(coords, count, mean, cov, 0.5)
    ref = jlm.extract_posts(coords, count, mean, cov, 0.5)
    assert len(ref) >= 1
    np.testing.assert_array_equal(ours, ref)
    rec = lm.Landmarks.empty()
    rec.posts = ours
    both = rec.concat(lm.Landmarks.from_arrays(rec.to_arrays()))
    jboth = jlm.Landmarks.empty()
    jboth.posts = ref
    jboth = jboth.concat(jboth)
    for a, b in zip(both.to_arrays().values(), jboth.to_arrays().values()):
        np.testing.assert_array_equal(a, b)
