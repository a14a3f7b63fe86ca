"""Parity of the port's tiled voxel map with the JAX package.

The same seeded scans go through both packages' VoxelMap: 70 frame-local
scans of 512 points (two 64-scan chunks, the second padded) at poses
spread over ±150 m, so they fall into several 100 m tiles.  Tiles, voxel
coordinates and counts must be equal; the moment sums s1, s2 within
1e-4 of the largest magnitude (float32 voxel moments summed in another
order).  Downdating every scan (signs −1) empties the map in both; a
2-patch residency budget spills to disk and reloads the same map; single
scans through integrate_points / deintegrate_points; the tile-ownership
filter; save and load.
"""

import numpy as np
import pytest

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
