"""Parity of the port's batched GICP (dilated-index branch) with the JAX
package on raycast scans of a static world.

Both sides register the same three source scans against the same target
(the JAX package's PlaneGrid and DilatedIndex, handed to the port as
tensors), with 16 GN iterations re-associating every 8.  Tolerance: poses
within 1e-4 (rotation components and metres) — the two linearize with
float32 sums in different orders and solve 6×6 Cholesky systems with
different LAPACK-style kernels, a few ulps per iteration; n_matched within
10 of 2048 points (a point on the max_dist threshold may flip)."""

import jax.numpy as jnp
import numpy as np
import pytest

from test_registration import _static_scan
from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu.registration import gicp as jgicp
from veloslam_tpu.registration import voxel as jvx
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx

P = 2048
VOXEL = 0.5
# (dx, dy, dz, yaw) of each source scan relative to the target's pose.
OFFSETS = [(0.1, 0.4, 0.03, np.deg2rad(2.0)),
           (-0.25, 0.1, 0.0, np.deg2rad(-1.0)),
           (0.3, -0.2, 0.02, np.deg2rad(0.5))]


def _subsample(pts, k):
    idx = np.linspace(0, len(pts) - 1, k).round().astype(int)
    return pts[idx]


@pytest.fixture(scope="module")
def scene():
    world = jsim.World.demo(seed=5, n_posts=30, n_walls=10)
    base = np.array([0.0, 0.0, 2.0])
    tgt = _static_scan(world, base, 0.0)
    grid = jvx.build_grid(jnp.asarray(tgt), jnp.ones(len(tgt), bool),
                          jnp.zeros(3), VOXEL, capacity=8192)
    target = jgicp.plane_grid_from(grid)
    dense = jvx.build_dilated_index(grid, target.usable)
    src = np.stack([_subsample(_static_scan(world, base + o[:3], o[3]), P)
                    for o in OFFSETS]).astype(np.float32)
    mask = np.ones((len(OFFSETS), P), bool)
    mask[1, -100:] = False
    return grid, target, dense, src, mask


def _port_target(target, dense):
    return (gicp.PlaneGrid(vx.VoxelGrid(*(t(x) for x in target.grid)),
                           t(target.normal), t(target.usable)),
            vx.DilatedIndex(t(dense.table), t(dense.lo)))


def test_plane_grid_from_matches_jax(scene):
    grid, target, _, _, _ = scene
    got = gicp.plane_grid_from(vx.VoxelGrid(*(t(x) for x in grid)))
    use_t, use_j = n(got.usable), n(target.usable)
    # The planarity gate is a threshold on float32 eigenvalues: allow two
    # boundary voxels of ~3000 to fall the other way.
    assert (use_t != use_j).sum() <= 2
    both = use_t & use_j
    dots = np.abs(np.sum(n(got.normal)[both] * n(target.normal)[both], 1))
    assert both.sum() > 300 and dots.min() > 1 - 1e-5


def test_register_batch_matches_jax(scene):
    _, target, dense, src, mask = scene
    F = len(OFFSETS)
    q0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (F, 1))
    t0 = np.zeros((F, 3), np.float32)
    want = jgicp.register_batch(
        jnp.asarray(src), jnp.asarray(mask), target,
        jse3.Pose(jnp.asarray(q0), jnp.asarray(t0)), dense, iterations=16,
        reassociate_every=8)
    ttarget, tdense = _port_target(target, dense)
    got = gicp.register_batch(t(src), t(mask), ttarget,
                              se3.Pose(t(q0), t(t0)), tdense,
                              iterations=16, reassociate_every=8)
    np.testing.assert_allclose(n(got.pose.q), n(want.pose.q), atol=1e-4)
    np.testing.assert_allclose(n(got.pose.t), n(want.pose.t), atol=1e-4)
    assert np.abs(n(got.n_matched) - n(want.n_matched)).max() <= 10
    np.testing.assert_allclose(n(got.mean_error), n(want.mean_error),
                               rtol=1e-3)
    # The registration is not trivial: it recovers the true offsets.
    truth = np.array([o[:3] for o in OFFSETS])
    np.testing.assert_allclose(n(got.pose.t), truth, atol=0.05)
    assert n(got.n_matched).min() > 500


def test_register_single_scan_is_batch_of_one(scene):
    _, target, dense, src, mask = scene
    ttarget, tdense = _port_target(target, dense)
    ident = se3.Pose(t(np.array([1.0, 0, 0, 0], np.float32)),
                     t(np.zeros(3, np.float32)))
    one = gicp.register(t(src[0]), t(mask[0]), ttarget, ident, tdense,
                        iterations=4, reassociate_every=2)
    batch = gicp.register_batch(
        t(src[:1]), t(mask[:1]), ttarget,
        se3.Pose(ident.q[None], ident.t[None]), tdense, iterations=4,
        reassociate_every=2)
    np.testing.assert_array_equal(n(one.pose.t), n(batch.pose.t[0]))
    assert int(one.n_matched) == int(batch.n_matched[0])
