"""Parity of the port's voxel grids and dilated dense index with the JAX
package.

Exact: packed keys, counts, the dense/dilated tables and their origin
`lo` (including a grid whose occupied coordinates have an even count with
distinct middle values, where torch.median and jnp.median disagree), and
lookups.  Tolerance: means and covariances rtol 1e-4 (+ atol 1e-6 for
entries near zero) — the 13-channel segment sums add the same float32
terms in another order.  Eigen-analysis: see the eigen tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.registration import gicp as jgicp
from veloslam_tpu.registration import voxel as jvx
from veloslam_tpu_torch.registration import voxel as vx

SMALL_BOX = (32, 32, 8)


def _cloud(seed, n_pts=6000, spread=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (40, 3))
    pts = centers[rng.integers(0, 40, n_pts)] + rng.normal(0, 0.3,
                                                          (n_pts, 3))
    pts[:, 2] *= 0.3
    mask = rng.random(n_pts) < 0.9
    return pts.astype(np.float32), mask


def _jgrid(pts, mask, origin, vs, cap):
    return jvx.build_grid(jnp.asarray(pts), jnp.asarray(mask),
                          jnp.asarray(origin, jnp.float32), vs, capacity=cap)


def _tgrid(g):
    """A JAX VoxelGrid as the port's (same leaves)."""
    return vx.VoxelGrid(*(t(x) for x in g))


def _check_grid(got, want):
    np.testing.assert_array_equal(n(got.keys), n(want.keys))
    np.testing.assert_array_equal(n(got.count), n(want.count))
    np.testing.assert_allclose(n(got.mean), n(want.mean), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(n(got.cov), n(want.cov), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(n(got.origin), n(want.origin))


@pytest.mark.parametrize("cap", [4096, 300])     # 300 drops overflow
def test_build_grid_matches_jax(cap):
    pts, mask = _cloud(0)
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    want = _jgrid(pts, mask, origin, 0.5, cap)
    got = vx.build_grid(t(pts), t(mask), t(origin), t(0.5, np.float32),
                        capacity=cap)
    _check_grid(got, want)
    assert int(n(got.occupied).sum()) == min(cap, int(
        n(want.occupied).sum()))


def test_pack_unpack_keys_match_jax():
    pts, mask = _cloud(1)
    pts[:10] *= 200.0                                # out of key range
    origin = np.zeros(3, np.float32)
    k_j = jvx.pack_keys(jnp.asarray(pts), jnp.asarray(mask),
                        jnp.asarray(origin), jnp.float32(0.5))
    k_t = vx.pack_keys(t(pts), t(mask), t(origin), t(0.5, np.float32))
    np.testing.assert_array_equal(n(k_t), n(k_j))
    np.testing.assert_array_equal(
        n(vx.unpack_keys(k_t, t(origin), t(0.5, np.float32))),
        n(jvx.unpack_keys(k_j, jnp.asarray(origin), jnp.float32(0.5))))


def test_merge_stats_matches_jax():
    origin = np.zeros(3, np.float32)
    a = _jgrid(*_cloud(2), origin, 0.5, 2048)
    b = _jgrid(*_cloud(3), origin, 0.5, 2048)
    a = a._replace(count=a.count * 0.98)
    want = jvx.merge_stats(a, b, capacity=2048)
    got = vx.merge_stats(_tgrid(a), _tgrid(b), capacity=2048)
    _check_grid(got, want)


def test_sorted_segment_sum_adds_rows_left_to_right():
    """build_grid's and merge_stats' sum (core.segment.segment_sum_sorted)
    adds each segment's rows in row order: on rows where float32 order
    matters (1e8 + 1 rounds back to 1e8) it equals the left-to-right sum
    to the bit, 1, where other orders give 0, 2 or 4; rows with the trash id
    are in no segment; a batch row's segments are its own."""
    from veloslam_tpu_torch.core.segment import segment_sum_sorted
    vals = np.array([[1e8, 1.0, -1e8, 1.0, 5.0, 3.0, 7.0],
                     [2.0, 1e8, 1.0, -1e8, 1.0, 4.0, 9.0]], np.float32)
    ids = np.array([[0, 0, 0, 0, 2, 3, 3], [1, 1, 1, 1, 1, 3, 3]])
    got = n(segment_sum_sorted(t(vals)[..., None], t(ids), 3))[..., 0]
    want = np.zeros((2, 3), np.float32)
    for f in range(2):
        for p in range(7):
            if ids[f, p] < 3:
                want[f, ids[f, p]] = np.float32(want[f, ids[f, p]]
                                                + vals[f, p])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1.0, 0.0, 5.0], [0.0, 1.0, 0.0]])


def test_sorted_segment_sum_matches_index_add_and_keeps_trash_short():
    """segment_sum_sorted on build_grid's own segments (a 6000-point cloud,
    10% invalid, capacity 300 so voxels overflow into the trash) against
    segment_sum (index_add_) with the trash rows dropped, within float32
    rounding, equal to the bit on the CPU, where both add in row order;
    and the trash lengths: at most 32 rows each, adding up to the trash."""
    from veloslam_tpu_torch.core.segment import (_TRASH_ROWS, _trash_lengths,
                                                 segment_sum,
                                                 segment_sum_sorted)
    pts, mask = _cloud(7)
    keys = vx.pack_keys(t(pts), t(mask), t(np.zeros(3, np.float32)),
                        t(0.5, np.float32))
    sk, order = torch.sort(keys, stable=True)
    _, seg = vx._segments(sk[None], 300)
    data = t(np.random.default_rng(7).normal(size=(6000, 13))
             .astype(np.float32))[order][None]
    got = segment_sum_sorted(data, seg, 300)[0]
    want = segment_sum(data[0], seg[0], 301)[:300]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, want)
    n_trash = int((seg == 300).sum())
    assert n_trash > 600
    lengths = _trash_lengths(torch.tensor([n_trash, 0, 5]), 6000)
    assert lengths.shape == (3, -(-6000 // _TRASH_ROWS))
    assert int(lengths.max()) <= _TRASH_ROWS
    assert lengths.sum(1).tolist() == [n_trash, 0, 5]


def test_rebase_grid_matches_jax():
    g = _jgrid(*_cloud(4, spread=40.0), np.zeros(3, np.float32), 0.5, 4096)
    for center in ([30.2, -11.7, 0.4], [260.0, 0.0, 0.0]):   # 2nd drops
        c = np.array(center, np.float32)
        want = jvx.rebase_grid(g, jnp.asarray(c))
        got = vx.rebase_grid(_tgrid(g), t(c))
        np.testing.assert_array_equal(n(got.keys), n(want.keys))
        np.testing.assert_array_equal(n(got.count), n(want.count))
        np.testing.assert_array_equal(n(got.mean), n(want.mean))
        np.testing.assert_array_equal(n(got.origin), n(want.origin))


def _usable(g):
    return jgicp.plane_grid_from(g).usable


@pytest.mark.parametrize("shape", [SMALL_BOX, (256, 256, 32)])
def test_dilated_index_and_lookup_match_jax(shape):
    g = _jgrid(*_cloud(5, spread=10.0), np.zeros(3, np.float32), 0.5, 4096)
    usable = _usable(g)
    want = jvx.build_dilated_index(g, usable, shape=shape)
    got = vx.build_dilated_index(_tgrid(g), t(usable), shape=shape)
    np.testing.assert_array_equal(n(got.lo), n(want.lo))
    np.testing.assert_array_equal(n(got.table), n(want.table))
    assert (n(got.table) >= 0).sum() > 100

    rng = np.random.default_rng(6)
    q = rng.uniform(-14, 14, (3, 2000, 3)).astype(np.float32)
    m = rng.random((3, 2000)) < 0.9
    idx_j = jvx.lookup_dilated(g, want, jnp.asarray(q), jnp.asarray(m))
    idx_t = vx.lookup_dilated(_tgrid(g), got, t(q), t(m))
    np.testing.assert_array_equal(n(idx_t), n(idx_j))
    assert (n(idx_t) >= 0).any() and (n(idx_t) < 0).any()

    cov_j = jvx.window_coverage(g, usable, want.lo, shape)
    cov_t = vx.window_coverage(_tgrid(g), t(usable), got.lo, shape)
    assert float(cov_t) == float(cov_j)


def test_dense_index_median_averages_even_middle_pair():
    """All 8 rows occupied, x voxel coords [0,0,0,10,20,30,30,30]: the
    middle pair (10, 20) averages to 15 (jnp.median); torch.median would
    centre the box on 10."""
    xs = [0, 0, 0, 10, 20, 30, 30, 30]
    pts = np.array([[x + 0.25, i * 1.0 + 0.25, 0.25]
                    for i, x in enumerate(xs)], np.float32)
    mask = np.ones(len(xs), bool)
    g = _jgrid(pts, mask, np.zeros(3, np.float32), 1.0, 8)
    assert bool(n(g.occupied).all())
    want = jvx.build_dense_index(g, shape=SMALL_BOX)
    got = vx.build_dense_index(_tgrid(g), shape=SMALL_BOX)
    np.testing.assert_array_equal(n(got.lo), n(want.lo))
    np.testing.assert_array_equal(n(got.table), n(want.table))
    gx = n(vx._grid_coords(t(n(g.keys)), 10))[:, 0]
    naive = int(torch.median(t(gx)).item()) - SMALL_BOX[0] // 2
    assert naive != int(n(got.lo)[0])


def _covs(seed):
    rng = np.random.default_rng(seed)
    k = 500
    A = rng.normal(size=(k, 3, 3))
    lam = np.abs(rng.normal(size=(k, 3))) * np.array([1.0, 0.5, 0.02])
    Q, _ = np.linalg.qr(A)
    cov = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    # Degenerate voxels: empty, isotropic, line (rank 1), exact plane.
    cov[0] = 0.0
    cov[1] = np.eye(3) * 0.01
    cov[2] = np.outer([1.0, 2.0, 0.5], [1.0, 2.0, 0.5]) * 0.01
    cov[3] = np.diag([0.04, 0.02, 0.0])
    return cov.astype(np.float32)


def test_eigvals3_matches_jax():
    """Tolerance atol 1e-4 on eigenvalues of order 1: the port takes a
    cofactor determinant, JAX an LU one, and near a repeated eigenvalue
    Cardano's arccos(r) has unbounded slope at r = ±1, so a float32
    rounding δ of r moves λ by ~p·sqrt(2δ) (measured up to 3e-5 here)."""
    cov = _covs(7)
    for a, b in zip(vx.eigvals3(t(cov)), jvx.eigvals3(jnp.asarray(cov))):
        np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=0)


def test_smallest_eigenvector_matches_jax():
    """Directions agree to |cos| > 1 − 1e-5 and with the same sign where
    the smallest eigenvalue is separated from the middle one by > 1e-4
    (every planar voxel); near-degenerate spectra have no unique normal."""
    cov = _covs(8)
    got = n(vx.smallest_eigenvector(t(cov)))
    want = n(jvx.smallest_eigenvector(jnp.asarray(cov)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    w = np.linalg.eigvalsh(cov.astype(np.float64))
    sep = (w[:, 1] - w[:, 0]) > 1e-4
    dots = np.sum(got * want, axis=1)
    assert sep.sum() > 400
    assert np.all(dots[sep] > 1 - 1e-5), dots[sep].min()
    np.testing.assert_array_equal(got[0], want[0])       # +z fallback


def _stacked(seeds, vs, cap):
    """F clouds → the JAX grids (vmapped build) and the port's batched
    build, origin 0, one voxel size."""
    clouds = [_cloud(s, spread=10.0) for s in seeds]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    import jax
    want = jax.vmap(lambda p, m: jvx.build_grid(
        p, m, jnp.zeros(3), vs, capacity=cap))(jnp.asarray(pts),
                                               jnp.asarray(mask))
    F = len(seeds)
    got = vx.build_grid(t(pts), t(mask), torch.zeros(F, 3),
                        torch.full((F,), vs), capacity=cap)
    return pts, mask, want, got


@pytest.mark.parametrize("cap", [4096, 500])
def test_batched_build_grid_matches_vmapped_jax(cap):
    """F scans in one build equal F separate builds: keys and counts
    exact, moments as test_build_grid_matches_jax."""
    _, _, want, got = _stacked([11, 12, 13], 0.5, cap)
    assert tuple(got.keys.shape) == (3, cap) and got.capacity == cap
    _check_grid(got, want)


def test_lookup_matches_jax():
    """Binary-search lookup through the int32 gather, one grid and F
    stacked grids: rows exact, −1 for absent and INVALID_KEY queries."""
    pts, mask, want, got = _stacked([14, 15], 0.5, 4096)
    rng = np.random.default_rng(16)
    keys = n(want.keys)
    for f in range(2):
        occ = keys[f][keys[f] != vx.INVALID_KEY]
        q = np.concatenate([rng.choice(occ, 300),
                            rng.integers(0, 2**30, 200),
                            [vx.INVALID_KEY]]).astype(np.int32)
        single = vx.VoxelGrid(*(x[f] for x in got))
        jsingle = jvx.VoxelGrid(*(x[f] for x in want))
        exp = n(jvx.lookup(jsingle, jnp.asarray(q)))
        np.testing.assert_array_equal(n(vx.lookup(single, t(q))), exp)
        assert (exp >= 0).sum() >= 300 and (exp < 0).sum() >= 1
    q2 = np.stack([keys[0][:100], keys[1][:100]])
    np.testing.assert_array_equal(
        n(vx.lookup(got, t(q2))),
        np.stack([n(jvx.lookup(jvx.VoxelGrid(*(x[f] for x in want)),
                               jnp.asarray(q2[f]))) for f in range(2)]))


def test_lookup_nearest_matches_vmapped_jax():
    """Seven-neighbour nearest usable voxel, F stacked grids: rows exact."""
    import jax
    _, _, want, got = _stacked([17, 18, 19], 1.0, 4096)
    usable = jax.vmap(lambda *g: jgicp.plane_grid_from(jvx.VoxelGrid(*g))
                      .usable)(*want)
    rng = np.random.default_rng(20)
    q = rng.uniform(-12, 12, (3, 3000, 3)).astype(np.float32)
    q[..., 2] *= 0.2
    m = rng.random((3, 3000)) < 0.9
    exp = n(jax.vmap(jvx.lookup_nearest)(want, jnp.asarray(q),
                                         jnp.asarray(m), usable))
    got_idx = n(vx.lookup_nearest(got, t(q), t(m), t(usable)))
    np.testing.assert_array_equal(got_idx, exp)
    assert (exp >= 0).mean() > 0.05 and (exp < 0).any()


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("shape", [SMALL_BOX, (256, 256, 32)])
def test_lookup_nearest_dense_matches_jax(shape, approx):
    """The per-frame pipeline's exact nearest-mean lookup through the
    dense index (and its voxel-centre variant): the chosen rows equal the
    JAX package's, misses included."""
    g = _jgrid(*_cloud(5, spread=10.0), np.zeros(3, np.float32), 0.5, 4096)
    usable = _usable(g)
    want_idx = jvx.build_dense_index(g, shape=shape)
    got_idx = vx.build_dense_index(_tgrid(g), shape=shape)
    np.testing.assert_array_equal(n(got_idx.table), n(want_idx.table))
    rng = np.random.default_rng(8)
    q = rng.uniform(-14, 14, (6000, 3)).astype(np.float32)
    q[:3000] = n(g.mean)[rng.integers(0, int(n(g.occupied).sum()), 3000)] \
        + rng.normal(0, 0.3, (3000, 3)).astype(np.float32)
    m = rng.random(6000) < 0.9
    want = jvx.lookup_nearest_dense(g, want_idx, jnp.asarray(q),
                                    jnp.asarray(m), usable,
                                    approx_centers=approx)
    got = vx.lookup_nearest_dense(_tgrid(g), got_idx, t(q), t(m),
                                  t(usable), approx_centers=approx)
    assert n(got).dtype == np.int32
    np.testing.assert_array_equal(n(got), n(want))
    hits = n(got) >= 0
    assert hits.sum() > 500 and (~hits).sum() > 100
