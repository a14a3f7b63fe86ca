"""Parity of the port's tiled voxel map with the JAX package.

The same seeded scans go through both packages' VoxelMap: 70 frame-local
scans of 512 points (a 64-scan chunk and a short one) at poses
spread over ±150 m, so they fall into several 100 m tiles.  Tiles, voxel
coordinates and counts must be equal; the moment sums s1, s2 within
1e-4 of the largest magnitude (float32 voxel moments summed in another
order).  Downdating every scan (signs −1) empties the map in both; a
2-patch residency budget spills to disk and reloads the same map; single
scans through integrate_points / deintegrate_points; the tile-ownership
filter; save and load.  The ROI assembly of the per-frame pipeline
(roi_grid) from the same tiles in both packages: keys and counts exact,
means and covariances within 1e-6 relative.  Every entry reaches the
tiles through the map's one device step: a scan through
integrate_points from points transformed on the host, or alone, equals
it in a batch of scans, to the bit; a downdate of moved keyframes (the
per-frame pipeline's update_map_incremental) is the same single-scan
integrations in order, to the bit.
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


def same_bytes(a, b):
    """Two port maps with the same tiles, and in each the same bytes of
    coords, count, s1 and s2."""
    pa, pb = patches(a), patches(b)
    return list(pa) == list(pb) and all(
        getattr(pa[k], f).tobytes() == getattr(pb[k], f).tobytes()
        for k in pb for f in ("coords", "count", "s1", "s2"))


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
    """Single world-frame scans through integrate_points and
    deintegrate_points (the map's device step at the identity pose)
    against the JAX package's."""
    _, _, (pts, msk, q, t) = built
    ours = VoxelMap(MapConfig(), device="cpu")
    ref = JVoxelMap(JMapConfig())
    world = pts[:3] + t[:3, None]          # three scans, identity rotation
    for m in (ours, ref):
        for k in range(3):
            m.integrate_points(world[k], msk[k], t[k])
        m.deintegrate_points(world[1], msk[1], t[1])
    assert_same_map(ours, ref)
    for m in (ours, ref):
        m.deintegrate_points(world[0], msk[0], t[0])
    assert_same_map(ours, ref)


@pytest.mark.parametrize("alone", ["integrate_points", "single_scans"])
def test_a_scan_alone_equals_it_in_a_batch_to_the_bit(built, alone):
    """The 70 rotated scans over several tiles, then the first 10
    downdated (80 scans: a 64-scan chunk and a short one), in one
    integrate_scans_batch call, against each scan integrated alone in
    the same order: through integrate_scans_batch at its pose
    (single_scans), or transformed on the host (se3.apply) and through
    integrate_points about its position.  The same tiles, to the bit."""
    from veloslam_tpu_torch.core import se3
    _, _, (pts, msk, q, t) = built
    idx = np.concatenate([np.arange(len(pts)), np.arange(10)])
    signs = np.where(np.arange(len(idx)) < len(pts), 1.0, -1.0)
    batch = VoxelMap(MapConfig(), device="cpu")
    batch.integrate_scans_batch(pts[idx], msk[idx], q[idx], t[idx],
                                signs=signs)
    each = VoxelMap(MapConfig(), device="cpu")
    for i, sign in zip(idx, signs):
        if alone == "single_scans":
            sl = slice(i, i + 1)
            each.integrate_scans_batch(pts[sl], msk[sl], q[sl], t[sl],
                                       signs=[sign])
        else:
            world = se3.apply(se3.Pose(torch.as_tensor(q[i]),
                                       torch.as_tensor(t[i])),
                              torch.as_tensor(pts[i])).numpy()
            each.integrate_points(world, msk[i], t[i], sign=sign)
    assert batch.n_patches >= 4
    assert same_bytes(batch, each)


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
    port, with two moved keyframes that share voxels.  Three keyframe
    scans enter the map as the per-frame pipeline integrates a frame (one
    scan at its pose); a graph solve moves keyframes 1 and 2, and
    update_map_incremental subtracts each at its old pose and adds it at
    its new one.  Every tile then equals, to the bit, the same
    single-scan integrations made in the order keyframe 1 out, in,
    keyframe 2 out, in (and not the order 1 out, 2 out, 1 in, 2 in); its
    voxels and counts equal a map with keyframes 1 and 2 integrated at
    their new poses directly."""
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    rng = np.random.default_rng(7)
    pts = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    # Half the points at voxel boundaries, where rounding would show.
    pts[:750] = np.round(pts[:750]) + rng.choice(
        [0.0, 1e-7, -1e-7], size=(750, 3)).astype(np.float32)
    mask = np.ones(1500, bool)

    def pose(yaw, x, y):
        return (np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                         np.float32), np.array([x, y, 0.0], np.float32))

    def frame(m, p, sign=1.0):
        m.integrate_scans_batch(pts[None], mask[None], p[0][None],
                                p[1][None], signs=[sign])

    # Keyframes 1 and 2 overlap near the origin, where the moments'
    # float64 sums round, so the order of the merges shows in the bits.
    old = [pose(0.0, 50.0, 0.0), pose(0.3, 0.0, 0.0), pose(-0.2, 0.7, 0.3)]
    new = [old[0], pose(0.31, 0.0, 0.2), pose(-0.2, 0.8, 0.45)]
    pipe = SlamPipeline(device="cpu")
    for k, p in enumerate(old):
        frame(pipe.map, p)
        pipe.graph.add_pose(*p)
        pipe.keyframe_scans.append((pts.copy(), mask.copy()))
        pipe.keyframe_times.append(k)
        pipe._kf_map_pose.append((p[0], p[1].copy()))
    pipe.graph.update_from(np.stack([q for q, _ in new]),
                           np.stack([t for _, t in new]))
    assert pipe.update_map_incremental() == 2
    assert pipe.update_map_incremental() == 0       # nothing moved since

    def replay(steps):
        m = VoxelMap(MapConfig(), device="cpu")
        for p, sign in [(p, 1.0) for p in old] + steps:
            frame(m, p, sign)
        return m

    out1, in1, out2, in2 = ((old[1], -1.0), (new[1], 1.0), (old[2], -1.0),
                            (new[2], 1.0))
    assert same_bytes(pipe.map, replay([out1, in1, out2, in2]))
    assert not same_bytes(pipe.map, replay([out1, out2, in1, in2]))
    direct = VoxelMap(MapConfig(), device="cpu")
    for p in new:
        frame(direct, p)
    pa, pd = patches(pipe.map), patches(direct)
    assert [k for k, p in pa.items() if p.n_voxels] == list(pd)
    for k, p in pd.items():
        for f in ("coords", "count"):
            assert getattr(pa[k], f).tobytes() == getattr(p, f).tobytes(), \
                (k, f)


def _voxel_stats(rng, coords, sign=1.0):
    """Seeded statistics for the voxels `coords` (shuffled): counts of
    1-29 points, moment sums scaled by them, some entries signed zeros."""
    coords = rng.permutation(np.asarray(coords, np.int32))
    count = rng.integers(1, 30, len(coords)).astype(np.float64)
    s1 = rng.normal(size=(len(coords), 3)) * count[:, None]
    s2 = rng.normal(size=(len(coords), 3, 3)) * count[:, None, None]
    for s in (s1, s2):
        zero = rng.random(s.shape) < 0.05
        s[zero] = rng.choice([0.0, -0.0], int(zero.sum()))
    return coords, sign * count, sign * s1, sign * s2


def _cube(rng, n, center, spread=30):
    """Up to n distinct voxels within ±spread of center."""
    c = rng.integers(-spread, spread, (n, 3)) + np.asarray(center)
    return np.unique(c, axis=0)


def _merge_steps(case, rng):
    """(coords, count, s1, s2, prune) merges, one list per case."""
    empty = (np.zeros((0, 3), np.int32), np.zeros(0), np.zeros((0, 3)),
             np.zeros((0, 3, 3)))
    if case.startswith("adds_and_downdates"):
        # Scans around a drifting centre; 30% downdate an earlier scan
        # (counts and sums negated) with prune.
        steps, added = [], []
        for i in range(60):
            if i > 5 and rng.random() < 0.3:
                c, n, a, b = added[rng.integers(len(added))]
                steps.append((c, -n, -a, -b, True))
            else:
                scan = _voxel_stats(rng, _cube(rng, 400, (i, 0, i % 3)))
                added.append(scan)
                steps.append(scan + (False,))
        return steps
    first = _voxel_stats(rng, _cube(rng, 2000, (0, 0, 0)))
    if case == "all_new":
        return [first + (False,),
                _voxel_stats(rng, _cube(rng, 500, (100, -100, 0))) + (False,)]
    if case == "all_exist":
        some = first[0][rng.random(len(first[0])) < 0.3]
        return [first + (False,), _voxel_stats(rng, some) + (False,),
                _voxel_stats(rng, some, sign=-1.0) + (True,)]
    if case == "empty_scan":
        return [empty + (False,), empty + (True,), first + (False,),
                empty + (False,), empty + (True,)]
    if case == "negative_coords":
        return [_voxel_stats(rng, _cube(rng, 800, c)) + (p,)
                for c, p in (((-70000, -3000, -40), False),
                             ((-70010, -2990, -45), False),
                             ((-69990, -3000, -30), True))]
    if case == "wide_span":
        far = _voxel_stats(rng, [[2 ** 21 + 5, 0, 0], [-3, 1, 2]])
        return [first + (False,), far + (False,),
                _voxel_stats(rng, _cube(rng, 300, (0, 0, 0))) + (True,)]
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "adds_and_downdates_seed0", "adds_and_downdates_seed1", "all_new",
    "all_exist", "empty_scan", "negative_coords", "wide_span"])
def test_tile_merge_equals_the_jax_merge_to_the_bit(case):
    """MapPatchData.merge, by sorted-key lookup, against the JAX
    package's merge (np.unique over the whole tile), step by step: coords,
    count, s1 and s2 equal to the bit, dtypes and shapes included.  A
    span of 2^21 voxels or more on an axis takes the re-sort, counted in
    the stage map_merge_resort; every merge is one stage map_merge."""
    from veloslam_tpu.map.voxelmap import MapPatchData as JPatch
    from veloslam_tpu_torch.map.voxelmap import MapPatchData
    from veloslam_tpu_torch.utils.profiling import StageTimers, recording
    rng = np.random.default_rng(sum(map(ord, case)))
    ours, ref = MapPatchData(), JPatch()
    timers = StageTimers()
    steps = _merge_steps(case, rng)
    for i, (c, n, a, b, prune) in enumerate(steps):
        with recording(timers):
            ours.merge(c, n, a, b, prune=prune)
        ref.merge(c, n, a, b, prune=prune)
        for f in ("coords", "count", "s1", "s2"):
            got, want = getattr(ours, f), getattr(ref, f)
            np.testing.assert_array_equal(got, want, err_msg=(i, f))
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (i, f)
    assert ref.n_voxels > 0 or case == "empty_scan"
    s = timers.summary()
    assert s["map_merge"]["count"] == len(steps)
    resorts = s.get("map_merge_resort", {"count": 0})["count"]
    assert resorts == (2 if case == "wide_span" else 0)
