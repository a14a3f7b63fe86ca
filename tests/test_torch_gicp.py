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
import torch

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
    return (gicp.make_plane_grid(vx.VoxelGrid(*(t(x) for x in target.grid)),
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


def test_register_batch_one_iteration_guards_match_jax(scene):
    """One GN iteration, slot by slot against JAX: slot 0 starts 0.9 m off
    in y (a ~1.3 m step that the clamp cuts to 1 m), slot 1 keeps 8 valid
    points (n_hit ≤ 10: the step is rejected and the pose stays), slot 2
    takes a full step.  The port's step decisions are read from
    normal_equations.gn_iteration at the same inputs.  Tolerances as
    test_register_batch_matches_jax."""
    from veloslam_tpu_torch.registration import normal_equations as ne
    _, target, dense, src, mask = scene
    mask = mask.copy()
    mask[1] = False
    mask[1, :8] = True
    q0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (3, 1))
    t0 = np.zeros((3, 3), np.float32)
    t0[0, 1] = -0.9
    want = jgicp.register_batch(
        jnp.asarray(src), jnp.asarray(mask), target,
        jse3.Pose(jnp.asarray(q0), jnp.asarray(t0)), dense, iterations=1)
    ttarget, tdense = _port_target(target, dense)
    init = se3.Pose(t(q0), t(t0))
    got = gicp.register_batch(t(src), t(mask), ttarget, init, tdense,
                              iterations=1)
    mu, nrm, hit = gicp.associate(t(src), t(mask), init, ttarget, tdense)
    step = ne.gn_iteration(t(src), init, mu, nrm, hit.view(torch.uint8)).step
    assert step.tolist() == [2, 0, 1]
    assert int(got.n_matched[1]) <= 10
    np.testing.assert_array_equal(n(got.pose.t[1]), t0[1])
    np.testing.assert_array_equal(n(want.pose.t[1]), t0[1])
    for f in range(3):
        np.testing.assert_allclose(n(got.pose.q[f]), n(want.pose.q[f]),
                                   atol=1e-4)
        np.testing.assert_allclose(n(got.pose.t[f]), n(want.pose.t[f]),
                                   atol=1e-4)
        assert abs(int(got.n_matched[f]) - int(want.n_matched[f])) <= 10
        np.testing.assert_allclose(float(got.mean_error[f]),
                                   float(want.mean_error[f]), rtol=1e-3)


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


@pytest.mark.parametrize("search", [False, True])
def test_register_against_one_target_matches_jax(scene, search):
    """The per-frame pipeline's registration: one scan against one
    target, the exact nearest mean of seven cells through a DenseIndex
    (JAX: register(dense=DenseIndex, dense_approx_centers=False)), or
    without an index the binary-search lookup, the port's target stacked
    at F = 1.  16 iterations re-associating every 8; poses within 1e-4."""
    grid, target, _, src, mask = scene
    init = (np.array([1.0, 0, 0, 0], np.float32),
            np.array([0.05, -0.1, 0.0], np.float32))
    jdense = None if search else jvx.build_dense_index(grid)
    want = jgicp.register(
        jnp.asarray(src[0]), jnp.asarray(mask[0]), target,
        jse3.Pose(*(jnp.asarray(a) for a in init)), iterations=16,
        dense=jdense, reassociate_every=8, dense_approx_centers=False)
    ttarget = gicp.plane_grid_from(vx.VoxelGrid(*(t(x) for x in grid)))
    ttarget = gicp.make_plane_grid(ttarget.grid, ttarget.normal,
                                   t(target.usable))
    if search:
        ttarget = gicp.PlaneGrid(
            grid=vx.VoxelGrid(*(x[None] for x in ttarget.grid)),
            normal=ttarget.normal[None], usable=ttarget.usable[None],
            rows=ttarget.rows[None])
        tdense = None
    else:
        tdense = vx.build_dense_index(vx.VoxelGrid(*(t(x) for x in grid)))
        assert isinstance(tdense, vx.DenseIndex)
    got = gicp.register(t(src[0]), t(mask[0]), ttarget,
                        se3.Pose(*(t(a) for a in init)), tdense,
                        iterations=16, reassociate_every=8)
    np.testing.assert_allclose(n(got.pose.q), n(want.pose.q), atol=1e-4)
    np.testing.assert_allclose(n(got.pose.t), n(want.pose.t), atol=1e-4)
    assert abs(int(got.n_matched) - int(want.n_matched)) <= 10
    np.testing.assert_allclose(n(got.pose.t), OFFSETS[0][:3], atol=0.05)


# --- per-scan targets (loop-closure verification) ----------------------------

VERIFY_VOXEL = 1.0


@pytest.fixture(scope="module")
def stacked():
    """Four target scans from different spots of one world, each with a
    source scan offset from it; the targets as JAX vmapped plane grids."""
    import jax
    world = jsim.World.demo(seed=3, extent=40.0, n_posts=40, n_walls=16)
    bases = [np.array(b) for b in ([0.0, 0.0, 2.0], [6.0, -3.0, 2.0],
                                   [-5.0, 4.0, 2.0], [2.0, 7.0, 2.0])]
    offs = OFFSETS + [(-0.15, -0.3, 0.0, np.deg2rad(1.5))]
    tgt = np.stack([_subsample(_static_scan(world, b, 0.0), 4 * P)
                    for b in bases]).astype(np.float32)
    src = np.stack([_subsample(_static_scan(world, b + np.array(o[:3]),
                                            o[3]), P)
                    for b, o in zip(bases, offs)]).astype(np.float32)
    tmask = np.ones(tgt.shape[:2], bool)
    tmask[2, -300:] = False
    smask = np.ones(src.shape[:2], bool)
    smask[0, :50] = False
    jgrids = jax.vmap(lambda p, m: jgicp.build_plane_grid(
        p, m, jnp.zeros(3), VERIFY_VOXEL, capacity=4096))(
            jnp.asarray(tgt), jnp.asarray(tmask))
    return tgt, tmask, src, smask, jgrids, np.array([o[:3] for o in offs])


def test_build_plane_grid_batched_matches_vmapped_jax(stacked):
    """Keys and counts exact; moments as test_torch_voxel; the planarity
    gate may put two boundary voxels of ~8000 the other way."""
    tgt, tmask, _, _, want, _ = stacked
    got = gicp.build_plane_grid(t(tgt), t(tmask), torch.zeros(3),
                                VERIFY_VOXEL, capacity=4096)
    np.testing.assert_array_equal(n(got.grid.keys), n(want.grid.keys))
    np.testing.assert_array_equal(n(got.grid.count), n(want.grid.count))
    np.testing.assert_allclose(n(got.grid.mean), n(want.grid.mean),
                               rtol=1e-4, atol=1e-6)
    assert (n(got.usable) != n(want.usable)).sum() <= 2
    rows = n(got.rows)
    assert rows.shape == (4, 4096, 8) and got.rows.is_contiguous()
    np.testing.assert_array_equal(rows[..., :3], n(got.grid.mean))
    np.testing.assert_array_equal(rows[..., 3:6], n(got.normal))
    assert not rows[..., 6:].any()
    one = [gicp.build_plane_grid(t(tgt[f:f + 1]), t(tmask[f:f + 1]),
                                 torch.zeros(3), VERIFY_VOXEL, capacity=4096)
           for f in range(4)]
    restacked = gicp.stack_plane_grids(
        [gicp.PlaneGrid(*(type(x)(*(y[0] for y in x)) if isinstance(x, tuple)
                          else x[0] for x in g)) for g in one])
    for a, b in zip(torch.utils._pytree.tree_leaves(restacked),
                    torch.utils._pytree.tree_leaves(got)):
        assert torch.equal(a, b)


def test_register_batch_per_scan_targets_matches_jax(stacked):
    """Stacked targets, dense=None (the verification call): the JAX
    package vmaps register with lookup_nearest over stacked targets.
    Tolerances as test_register_batch_matches_jax."""
    _, _, src, smask, jgrids, truth = stacked
    F = len(src)
    q0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (F, 1))
    t0 = np.zeros((F, 3), np.float32)
    want = jgicp.register_batch(
        jnp.asarray(src), jnp.asarray(smask), jgrids,
        jse3.Pose(jnp.asarray(q0), jnp.asarray(t0)), iterations=12,
        share_target=False, reassociate_every=4)
    target = gicp.make_plane_grid(
        vx.VoxelGrid(*(t(x) for x in jgrids.grid)), t(jgrids.normal),
        t(jgrids.usable))
    got = gicp.register_batch(t(src), t(smask), target,
                              se3.Pose(t(q0), t(t0)), iterations=12,
                              reassociate_every=4)
    np.testing.assert_allclose(n(got.pose.q), n(want.pose.q), atol=1e-4)
    np.testing.assert_allclose(n(got.pose.t), n(want.pose.t), atol=1e-4)
    assert np.abs(n(got.n_matched) - n(want.n_matched)).max() <= 10
    np.testing.assert_allclose(n(got.mean_error), n(want.mean_error),
                               rtol=1e-3)
    np.testing.assert_allclose(n(got.H), n(want.H), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(n(got.pose.t), truth, atol=0.05)


def test_one_shot_normal_equations_matches_jax(stacked):
    """gicp.normal_equations at the identity (verification's H_self)."""
    import jax
    tgt, tmask, _, _, jgrids, _ = stacked
    want = jax.vmap(lambda p, m, g: jgicp.normal_equations(
        p, m, jse3.Pose.identity(), g))(jnp.asarray(tgt),
                                        jnp.asarray(tmask), jgrids)
    target = gicp.make_plane_grid(
        vx.VoxelGrid(*(t(x) for x in jgrids.grid)), t(jgrids.normal),
        t(jgrids.usable))
    got = gicp.normal_equations(t(tgt), t(tmask),
                                se3.Pose.identity((len(tgt),)), target)
    np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(n(got[1]), n(want[1]), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(n(got[3]), n(want[3]))
