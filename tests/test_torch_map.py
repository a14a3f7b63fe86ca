"""Parity of the port's tiled voxel map with the JAX package.

The same seeded scans go through both packages' VoxelMap: 70 frame-local
scans of 512 points (two 64-scan chunks, the second padded) at poses
spread over ±150 m, so they fall into several 100 m tiles.  Tiles, voxel
coordinates and counts must be equal; the moment sums s1, s2 within
1e-4 of the largest magnitude (float32 voxel moments summed in another
order).  Downdating every scan (signs −1) empties the map in both; a
2-patch residency budget spills to disk and reloads the same map; single
scans through integrate_points / deintegrate_points; the tile-ownership
filter; save and load.  The ROI assembly of the per-frame pipeline
(roi_grid) from the same tiles in both packages: keys and counts exact,
means and covariances within 1e-6 relative.  A stream downdate (the
per-frame pipeline's update_map_incremental) restores a tile to the bit.
"""

import numpy as np
import pytest
import torch

from torch_helpers import map_scans as scans
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.config import MapConfig as JMapConfig
from veloslam_tpu.map.voxelmap import VoxelMap as JVoxelMap
from veloslam_tpu_torch.config import MapConfig
from veloslam_tpu_torch.map.voxelmap import VoxelMap


def patches(m):
    """{tile: patch} over resident and spilled tiles (reloading them)."""
    keys = sorted(set(m._patches) | set(m._spilled))
    return {k: m._materialize(k, create=False) for k in keys}


def assert_same_map(ours, ref):
    a, b = patches(ours), patches(ref)
    assert list(a) == list(b)
    for k in b:
        np.testing.assert_array_equal(a[k].coords, b[k].coords, err_msg=k)
        np.testing.assert_array_equal(a[k].count, b[k].count, err_msg=k)
        for f in ("s1", "s2"):
            want = getattr(b[k], f)
            np.testing.assert_allclose(
                getattr(a[k], f), want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(initial=0.0), 1.0),
                err_msg=f"{k} {f}")


@pytest.fixture(scope="module")
def built():
    pts, msk, q, t = scans()
    ours = VoxelMap(MapConfig(), device="cpu")
    ref = JVoxelMap(JMapConfig())
    for m in (ours, ref):
        m.integrate_scans_batch(pts, msk, q, t)
    return ours, ref, (pts, msk, q, t)


def test_integrate_scans_batch_matches_jax(built):
    ours, ref, _ = built
    assert ours.n_patches == ref.n_patches >= 4
    assert_same_map(ours, ref)
    assert sum(p.n_voxels for p in patches(ours).values()) > 10000


def test_downdate_empties_the_map(built):
    """Signs −1 subtract each scan's statistics again: every voxel's count
    returns to 0 and is pruned, in both packages."""
    _, _, (pts, msk, q, t) = built
    for m in (VoxelMap(MapConfig(), device="cpu"), JVoxelMap(JMapConfig())):
        m.integrate_scans_batch(pts, msk, q, t)
        m.integrate_scans_batch(pts, msk, q, t, signs=-np.ones(len(pts)))
        assert m.n_patches >= 4
        assert all(p.n_voxels == 0 for p in patches(m).values())


def test_spill_and_reload(built, tmp_path):
    """A 2-patch residency budget spills the least recently used tiles to
    npz and reloads them on access: the same map as unbounded, and as
    the JAX package's under the same budget."""
    ours_full, _, (pts, msk, q, t) = built
    ours = VoxelMap(MapConfig(max_resident_patches=2),
                    spill_dir=str(tmp_path / "ours"), device="cpu")
    ref = JVoxelMap(JMapConfig(max_resident_patches=2),
                    spill_dir=str(tmp_path / "ref"))
    for m in (ours, ref):
        m.integrate_scans_batch(pts, msk, q, t)
    assert len(ours._patches) == 2 and len(ours._spilled) >= 2
    assert sorted(ours._spilled) == sorted(ref._spilled)
    assert_same_map(ours, ref)
    assert_same_map(ours, ours_full)


def test_integrate_points_and_deintegrate(built):
    """Single scans, the port's through the pipeline's per-scan hook
    (SlamPipeline._integrate_scan) into its map."""
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    _, _, (pts, msk, q, t) = built
    pipe = SlamPipeline(device="cpu")
    ref = JVoxelMap(JMapConfig())
    world = pts[:3] + t[:3, None]          # three scans, identity rotation
    for k in range(3):
        pipe._integrate_scan(world[k], msk[k], t[k])
        ref.integrate_points(world[k], msk[k], t[k])
    pipe._integrate_scan(world[1], msk[1], t[1], sign=-1.0)
    ref.deintegrate_points(world[1], msk[1], t[1])
    assert_same_map(pipe.map, ref)
    pipe.map.deintegrate_points(world[0], msk[0], t[0])
    ref.deintegrate_points(world[0], msk[0], t[0])
    assert_same_map(pipe.map, ref)


def test_tile_filter_keeps_owned_tiles(built):
    """The tile-ownership hook: only tiles the filter accepts are built,
    as in the JAX package, and they equal the unfiltered map's."""
    ours_full, _, (pts, msk, q, t) = built
    def owned(tx, ty):
        return (tx + ty) % 2 == 0
    ours = VoxelMap(MapConfig(), device="cpu")
    ref = JVoxelMap(JMapConfig())
    for m in (ours, ref):
        m.integrate_scans_batch(pts, msk, q, t, tile_filter=owned)
    assert 0 < ours.n_patches < ours_full.n_patches
    assert all(owned(*k) for k in patches(ours))
    assert_same_map(ours, ref)
    full = patches(ours_full)
    for k, p in patches(ours).items():
        np.testing.assert_array_equal(p.coords, full[k].coords)


def test_save_and_load(built, tmp_path):
    ours, ref, _ = built
    ours.save(str(tmp_path / "map"))
    back = VoxelMap.load(str(tmp_path / "map"), MapConfig(), device="cpu")
    assert back.n_patches == ours.n_patches
    assert_same_map(back, ref)


def _jax_copy(ours):
    """A JAX VoxelMap holding the port map's tiles (the same float64
    statistics), so roi_grid is compared on equal inputs."""
    from veloslam_tpu.map.voxelmap import MapPatchData as JPatch
    ref = JVoxelMap(JMapConfig())
    for k, p in patches(ours).items():
        q = JPatch()
        q.coords, q.count, q.s1, q.s2 = (p.coords.copy(), p.count.copy(),
                                         p.s1.copy(), p.s2.copy())
        ref._patches[k] = q
        ref._touch[k] = 0
    return ref


@pytest.mark.parametrize("xy,cap", [((0.0, 0.0), None), ((-120.0, 75.0), None),
                                    ((30.0, -40.0), 3000), ((900.0, 900.0),
                                                            None)])
def test_roi_grid_matches_jax(built, xy, cap):
    """The ROI around a query point as one device VoxelGrid (keys packed
    relative to it; the nearest voxels first when `cap` cuts it): keys,
    counts, origin and voxel size exact, means and covariances within
    1e-6 relative; no ROI far from every tile."""
    ours = built[0]
    ref = _jax_copy(ours)
    assert ours.roi_patches(*xy) == ref.roi_patches(*xy)
    want = ref.roi_grid(*xy, capacity=cap)
    got = ours.roi_grid(*xy, capacity=cap)
    if want is None:
        assert got is None and xy == (900.0, 900.0)
        return
    assert got.keys.dtype == torch.int32
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert float(got.voxel_size) == float(want.voxel_size)
    for f in ("mean", "cov"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    occupied = int((got.keys.numpy() != 2**31 - 1).sum())
    assert occupied == (cap or occupied) and occupied > 1000


def test_stream_downdate_restores_tiles_to_the_bit():
    """tests/test_map.py::test_stream_downdate_is_exact_inverse on the
    port: keyframe 1, integrated through the per-frame path (se3.apply +
    integrate_points), moves 2 m after a graph solve;
    update_map_incremental subtracts it at the old pose and adds it at
    the new one.  Every tile then equals, to the bit, a map where
    keyframe 1 was integrated at the new pose directly."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    def build(move):
        pipe = SlamPipeline(device="cpu")
        rng = np.random.default_rng(7)
        pts = rng.uniform(-5, 5, (1500, 3)).astype(np.float32)
        # Points at voxel boundaries, where rounding would show.
        pts = np.round(pts) + rng.choice(
            [0.0, 1e-7, -1e-7], size=pts.shape).astype(np.float32)
        mask = np.ones(1500, bool)
        for k, tx in enumerate((0.0, 20.0)):
            q = np.array([1.0, 0, 0, 0], np.float32)
            pose_t = np.array([tx, 0.0, 0.0], np.float32)
            if move and k == 1:
                pose_t[1] += 2.0
            pw = se3.apply(se3.Pose(torch.as_tensor(q),
                                    torch.as_tensor(pose_t)),
                           torch.as_tensor(pts)).numpy()
            pipe._integrate_scan(pw, mask, pose_t)
            pipe.graph.add_pose(q, pose_t)
            pipe.keyframe_scans.append((pts.copy(), mask.copy()))
            pipe.keyframe_times.append(k)
            pipe._kf_map_pose.append((q, pose_t.copy()))
            pipe._kf_integrated_via.append("stream")
        return pipe

    a = build(move=False)
    q, t = a.graph.poses()
    t2 = t.copy()
    t2[1, 1] += 2.0
    a.graph.update_from(q, t2)
    assert a.update_map_incremental() == 1
    assert a.update_map_incremental() == 0          # nothing moved since
    b = build(move=True)
    pa, pb = patches(a.map), patches(b.map)
    assert [k for k, p in pa.items() if p.n_voxels] == list(pb)
    for k, p in pb.items():
        for f in ("coords", "count", "s1", "s2"):
            assert getattr(pa[k], f).tobytes() == getattr(p, f).tobytes(), \
                (k, f)
