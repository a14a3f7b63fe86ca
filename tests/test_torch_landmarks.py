"""Parity of the port's landmark stage (host numpy copies) with the JAX
package: post extraction from stacked keyframe scans and the greedy
association into graph landmarks and observations.

Seeded synthetic keyframe scans, each in its sensor frame: the near
halves of 0.2 m posts (0-3 m tall) seen from 10 keyframes along a
curve, a ground plane and a wall whose columns form a run (rejected as
posts), with 2 cm noise.  Detections per scan equal (they are the same
float64 numpy arithmetic); the graphs after association hold equal
landmarks and observations, in the same order; extract_posts and the
Landmarks record round trip equal.  The other extractors on
tests/test_map.py's scenes: plane, complex and post landmarks of every
map patch (planes within 1e-5: float32 eigen analysis), random plane
voxels, the connected components and the ground marks of painted
stripes."""

import numpy as np
import pytest

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


# --- the other extractors (tests/test_map.py's cases) -----------------------

def _complex_world_map():
    """tests/test_map.py::test_complex_extraction's scene in a JAX
    VoxelMap: a 2 × 1.5 × 1.2 m blob, flat ground and a thin post."""
    from veloslam_tpu.config import MapConfig
    from veloslam_tpu.map.voxelmap import VoxelMap
    rng = np.random.default_rng(11)
    blob = rng.uniform([5.0, 3.0, 0.0], [7.0, 4.5, 1.2], (4000, 3))
    ground = np.stack([rng.uniform(-10, 15, 8000),
                       rng.uniform(-10, 15, 8000),
                       rng.normal(0, 0.02, 8000)], -1)
    ang = rng.uniform(0, 2 * np.pi, 1500)
    post = np.stack([-4 + 0.2 * np.cos(ang), -4 + 0.2 * np.sin(ang),
                     rng.uniform(0, 4, 1500)], -1)
    wall = np.stack([rng.uniform(-8, 8, 6000), np.full(6000, 12.0),
                     rng.uniform(0, 3, 6000)], -1)
    pts = np.concatenate([blob, ground, post, wall]).astype(np.float32)
    m = VoxelMap(MapConfig(voxel_size=0.5))
    m.integrate_points(pts, np.ones(len(pts), bool), np.zeros(3))
    return m


def test_extract_landmarks_matches_jax():
    """Per patch: posts, complexes (meta, offsets, points) equal; planes
    equal in count with coefficients and corners within 1e-5 (the
    normals come from float32 Cardano in both packages)."""
    m = _complex_world_map()
    n_planes = n_cplx = 0
    for key in sorted(m._patches):
        ref = jlm.extract_landmarks(m._patches[key], 0.5)
        ours = lm.extract_landmarks(m._patches[key], 0.5, device="cpu")
        for (k, a), b in zip(ours.to_arrays().items(),
                             ref.to_arrays().values()):
            assert a.shape == b.shape, k
            if k == "lm_planes":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        n_planes += len(ref.planes)
        n_cplx += len(ref.cplx_meta)
    assert n_planes >= 2 and n_cplx >= 1


def test_extract_planes_and_components_match_jax():
    # Flat voxels on the planes x = 2, y = -3 and z = 1 (slightly tilted
    # normals, in-plane spread) and isotropic ones, which are no plane.
    rng = np.random.default_rng(7)
    V = 600
    axis = np.repeat(np.arange(3), V // 3)
    tilt = np.eye(3)[axis] + rng.normal(0, 0.02, (V, 3))
    tilt /= np.linalg.norm(tilt, axis=1, keepdims=True)
    spread = np.eye(3) - tilt[:, :, None] * tilt[:, None, :]
    cov = 0.04 * spread + 1e-5 * np.eye(3)
    cov[::5] = 0.04 * np.eye(3)
    mean = rng.uniform(-10, 10, (V, 3))
    mean[np.arange(V), axis] = np.array([2.0, -3.0, 1.0])[axis]
    coords = np.floor(mean / 0.5).astype(np.int64)
    count = rng.integers(1, 40, V).astype(np.float32)
    args = (coords, count, mean.astype(np.float32), cov.astype(np.float32),
            0.5)
    ours = lm.extract_planes(*args, device="cpu")
    ref = jlm.extract_planes(*args)
    assert ours.shape == ref.shape and len(ref) >= 3
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    cells = rng.integers(0, 12, (300, 3))
    for reach in (1, 2):
        np.testing.assert_array_equal(
            lm._connected_components(cells, reach),
            jlm._connected_components(cells, reach))
    assert lm.extract_planes(coords[:0], count[:0], mean[:0], cov[:0],
                             0.5).shape == (0, 16)


def test_extract_ground_marks_matches_jax():
    """tests/test_map.py::test_ground_mark_extraction's painted stripes:
    the same two segments."""
    from veloslam_tpu.io import simulate as jsim
    truth = np.array([[2.0, -0.15, 10.0, -0.15, 0.3],
                      [2.0, 1.85, 10.0, 1.85, 0.3]])
    world = jsim.World(marks=truth)
    origin = np.array([0.0, 0.0, 2.0])
    gx, gy = np.meshgrid(np.linspace(0.5, 12, 300), np.linspace(-2, 4, 240))
    targets = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
    dirs = targets - origin
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dist, kind = jsim.raycast(world, np.broadcast_to(origin, dirs.shape),
                              dirs)
    intensity = np.choose(kind, [0, 80, 200, 150, 255])
    pts = (origin + dirs * dist[:, None]).astype(np.float32)
    ours = lm.extract_ground_marks(pts, intensity, dist > 0, voxel_size=0.25)
    ref = jlm.extract_ground_marks(pts, intensity, dist > 0, voxel_size=0.25)
    assert len(ref) == 2
    np.testing.assert_array_equal(ours, ref)
    assert lm.extract_ground_marks(pts[:5], intensity[:5],
                                   dist[:5] > 0).shape == (0, 7)


def test_extract_planes_needs_a_card_unless_told_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.extract_planes(np.zeros((1, 3), int), np.ones(1), np.zeros((1, 3)),
                          np.eye(3)[None], 0.5)


def _graph_test_scenes():
    """tests/test_graph.py's post scenes, sensor frame: the near halves
    of two lone posts (test_post_viewpoint_bias_correction) and the four
    keyframe scans of test_landmark_association_end_to_end's world."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_registration import _static_scan
    from veloslam_tpu.io import simulate as jsim
    scenes = []
    for R, cx, cy in ((0.18, 10.25, 0.25), (0.15, 20.25, -0.25)):
        th = np.linspace(-np.pi / 2, np.pi / 2, 40)
        hits = np.stack([cx - R * np.cos(th), cy + R * np.sin(th)], -1)
        scenes.append(np.concatenate(
            [np.column_stack([hits, np.full(len(th), z)])
             for z in np.linspace(0.05, 4.95, 300)]).astype(np.float32))
    rng = np.random.default_rng(2)
    world = jsim.World.demo(seed=9, n_posts=0, n_walls=6)
    world.posts = np.column_stack([
        rng.uniform(-15, 15, 10), rng.uniform(-15, 15, 10),
        np.full(10, 0.3), np.zeros(10), np.full(10, 6.0)])
    for k in range(4):
        scenes.append(_static_scan(world, np.array([k * 1.5, 0.3 * k, 2.0]),
                                   0.08 * k, n_az=1800))
    return scenes


def test_extract_scan_posts_matches_jax():
    """extract_scan_posts (the grid built on the CPU here) against the
    JAX one on tests/test_graph.py's scenes: the same detections, values
    within 1e-5 m (the two grids' float32 moments are summed in other
    orders); its host helpers on the JAX grid and on the raw scan equal
    to the bit."""
    import jax.numpy as jnp

    from veloslam_tpu.registration import voxel as jvx
    total = 0
    for pts in _graph_test_scenes():
        mask = np.ones(len(pts), bool)
        mask[::11] = False
        got = la.extract_scan_posts(pts, mask, device="cpu")
        want = jla.extract_scan_posts(pts, mask)
        assert got.shape == want.shape and len(want) >= 1
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        total += len(want)
        grid = jvx.build_grid(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.zeros(3, jnp.float32), 0.5, capacity=8192)
        host = [np.asarray(x) for x in (grid.keys, grid.count, grid.mean,
                                        grid.cov)]
        np.testing.assert_array_equal(
            la._posts_from_host_grid(*host, 0.5, sensor_frame=True),
            jla._posts_from_host_grid(*host, 0.5, sensor_frame=True))
        for a, b in zip(la._host_voxel_stats(pts, mask, 0.5),
                        jla._host_voxel_stats(pts, mask, 0.5)):
            np.testing.assert_array_equal(a, b)
    assert total >= 10
