"""Parity of the port's D2D and NDT registration with the JAX package:
the five voxel helpers only they use, both methods' normal equations,
their Gauss-Newton registrations, and the guarded step.

Each test feeds both packages the same numpy inputs made from a seed.
Tolerances (float32; the two packages round Cardano's cosines, the
einsum sums and the determinant differently): weight matrices within
1e-3 of their largest entry; H and b within 1e-4 of their largest
entry, errors within 1e-4 relative; poses within 1e-4 m and 1e-5 in the
quaternion; integer outputs (keys, counts, masks, matches) exactly
equal.  Line-like covariances (λ2 ≈ λ3 ≪ λ1) are ill-conditioned in
float32 in both packages: their eigenvector frame tilts by up to ~20° from
the float64 one in either, so there the test holds the spectra equal and
the port's frame no further from the float64 one than the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.registration import d2d as jd2d
from veloslam_tpu.registration import ndt as jndt
from veloslam_tpu.registration import voxel as jvx
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import d2d, ndt
from veloslam_tpu_torch.registration import normal_equations as ne
from veloslam_tpu_torch.registration import voxel as vx

W_REL = 1e-3
NE_REL = 1e-4


def _covs(kind, n_cov=512, seed=0):
    """Symmetric PSD (n, 3, 3) covariances: "random" (well separated
    spectra), "isotropic", "planar" (λ1 ≈ λ2, λ3 = 1e-3·λ1) or "linear"
    (λ2 = λ3 = 1e-3·λ1), in random frames."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        a = rng.normal(size=(n_cov, 3, 3))
        return (a @ a.transpose(0, 2, 1) * 0.05).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(n_cov, 3, 3)))
    s = rng.uniform(0.01, 0.1, (n_cov, 1))
    d = {"isotropic": np.repeat(s, 3, 1),
         "planar": np.concatenate([s, s * rng.uniform(0.9, 1, (n_cov, 1)),
                                   s * 1e-3], 1),
         "linear": np.concatenate([s, s * 1e-3, s * 1e-3], 1)}[kind]
    return (q * d[:, None, :] @ q.transpose(0, 2, 1)).astype(np.float32)


def _rel(a, b):
    """Largest |a − b| per matrix over the largest |b| of that matrix."""
    ax = tuple(range(1, b.ndim))
    return float((np.abs(a - b).max(axis=ax)
                  / np.abs(b).max(axis=ax)).max())


@pytest.mark.parametrize("kind", ["random", "isotropic", "planar",
                                  "linear"])
def test_weight_helpers_match_jax(kind):
    c = _covs(kind)
    for name in ("clamped_inverse", "normalized_cov", "regularized_inverse"):
        want = n(getattr(jvx, name)(jnp.asarray(c)))
        got = n(getattr(vx, name)(t(c)))
        np.testing.assert_allclose(got, np.swapaxes(got, -1, -2), atol=1e-6
                                   * np.abs(got).max())
        if kind != "linear" or name == "regularized_inverse":
            assert _rel(got, want) <= W_REL, (name, _rel(got, want))
            continue
        # Line-like: the same spectrum, and a frame no further from the
        # float64 eigenvectors than the JAX package's own.
        ew, eg = (np.linalg.eigvalsh(x.astype(np.float64))
                  for x in (want, got))
        assert _rel(eg[:, None], ew[:, None]) <= W_REL, name
        axis = np.linalg.eigh(c.astype(np.float64))[1][..., 2]
        col = 0 if name == "clamped_inverse" else 2   # the line direction

        def tilt(w):
            v = np.linalg.eigh(w.astype(np.float64))[1][..., col]
            return np.degrees(np.arccos(np.clip(
                np.abs(np.sum(v * axis, -1)), 0, 1)))
        assert tilt(got).max() <= tilt(want).max() + 1.0, name
    if kind == "random":      # distinct rows: the same argmax in both
        np.testing.assert_allclose(
            n(vx._nullspace_dir(t(c))), n(jvx._nullspace_dir(jnp.asarray(c))),
            rtol=0, atol=1e-6 * np.abs(c).max() ** 2)


@pytest.mark.parametrize("kind", ["random", "planar", "linear"])
def test_structure_usable_matches_jax(kind):
    c = _covs(kind, seed=3)
    rng = np.random.default_rng(4)
    V = len(c)
    keys = np.where(rng.random(V) < 0.9, np.arange(V), vx.INVALID_KEY)
    count = rng.integers(0, 9, V).astype(np.float32)
    leaves = dict(keys=keys.astype(np.int32), count=count,
                  mean=np.zeros((V, 3), np.float32), cov=c,
                  origin=np.zeros(3, np.float32),
                  voxel_size=np.float32(1.0))
    want = jvx.structure_usable(jvx.VoxelGrid(**{
        k: jnp.asarray(v) for k, v in leaves.items()}), min_points=4)
    got = vx.structure_usable(vx.VoxelGrid(**{
        k: t(v) for k, v in leaves.items()}), min_points=4)
    np.testing.assert_array_equal(n(got), n(want))


def _corner_scene(seed, n_walls=12, extent=20.0, pts_per=96):
    """Wall pairs meeting at right angles on a ground plane: corner,
    plane and edge voxels at 1 m (tests/test_d2d.py's scene, smaller)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n_walls):
        c = rng.uniform(-extent, extent, 2)
        h = rng.uniform(0.0, 3.0, (pts_per, 1))
        u = rng.uniform(-2.0, 2.0, (pts_per, 1))
        pts += [np.concatenate([c[0] + u, np.full_like(u, c[1]), h], -1),
                np.concatenate([np.full_like(u, c[0]), c[1] + u, h], -1)]
    pts.append(np.concatenate([rng.uniform(-extent, extent, (1024, 2)),
                               np.zeros((1024, 1))], -1))
    surf = np.concatenate(pts)
    a = surf + rng.normal(0, 0.01, surf.shape)
    b = surf[rng.permutation(len(surf))] + rng.normal(0, 0.01, surf.shape)
    return a.astype(np.float32), b.astype(np.float32)


def _grids(cap=2048, seed=11):
    """Source and target grids of two samplings of one scene, built by
    the JAX package and carried into the port leaf by leaf."""
    a, b = _corner_scene(seed)
    jg = [jvx.build_grid(jnp.asarray(x), jnp.ones(len(x), bool),
                         np.zeros(3, np.float32), 1.0, capacity=cap)
          for x in (a, b)]
    pg = [vx.VoxelGrid(*(t(np.asarray(y)) for y in g)) for g in jg]
    return jg, pg, (a, b)


POSE = (jse3.euler_deg_to_quat_np(0.5, -1.0, 2.0),
        np.array([0.12, -0.08, 0.03], np.float32))


def _poses(q=POSE[0], tr=POSE[1]):
    q, tr = np.asarray(q, np.float32), np.asarray(tr, np.float32)
    return (jse3.Pose(jnp.asarray(q), jnp.asarray(tr)),
            se3.Pose(t(q), t(tr)))


def _check_ne(got, want):
    H, b, err, m = (n(x) for x in got)
    wH, wb, werr, wm = (n(x) for x in want)
    assert int(m) == int(wm) > 100
    np.testing.assert_allclose(H, wH, rtol=0, atol=NE_REL * np.abs(wH).max())
    np.testing.assert_allclose(b, wb, rtol=0, atol=NE_REL * np.abs(wb).max())
    np.testing.assert_allclose(err, werr, rtol=NE_REL)


def test_build_grid_drops_the_same_rows_past_capacity():
    """A scan with more voxels than the grid holds keeps the same keys
    (the smallest in key order) and the same statistics in both."""
    a, _ = _corner_scene(5)
    m = np.ones(len(a), bool)
    origin = np.array([-3.0, 2.0, 0.5], np.float32)
    jg = jvx.build_grid(jnp.asarray(a), jnp.asarray(m), origin, 1.0,
                        capacity=256)
    pg = vx.build_grid(t(a), t(m), t(origin), torch.tensor(1.0),
                       capacity=256)
    assert int(np.sum(n(jvx.build_grid(
        jnp.asarray(a), jnp.asarray(m), origin, 1.0,
        capacity=8192).keys) != vx.INVALID_KEY)) > 256
    np.testing.assert_array_equal(n(pg.keys), n(jg.keys))
    np.testing.assert_array_equal(n(pg.count), n(jg.count))
    np.testing.assert_allclose(n(pg.mean), n(jg.mean), atol=1e-5)


def test_d2d_normal_equations_match_jax():
    (js, jt), (ps, pt), _ = _grids()
    jpose, ppose = _poses()
    usable_j = jd2d.usable_mask(jt, min_points=3)
    usable_p = d2d.usable_mask(pt, min_points=3)
    np.testing.assert_array_equal(n(usable_p), n(usable_j))
    _check_ne(d2d.d2d_normal_equations(ps, ppose, pt, usable_p),
              jd2d.d2d_normal_equations(js, jpose, jt, usable_j))


@pytest.mark.parametrize("robust", [True, False])
def test_ndt_normal_equations_match_jax(robust):
    (_, jt), (_, pt), (a, _) = _grids()
    m = np.ones(len(a), bool)
    jg = jndt.build_ndt_grid(jt, robust=robust)
    pg = ndt.build_ndt_grid(pt, robust=robust)
    np.testing.assert_array_equal(n(pg.usable), n(jg.usable))
    jpose, ppose = _poses()
    _check_ne(ndt.normal_equations(t(a), t(m), ppose, pg),
              jndt.normal_equations(jnp.asarray(a), jnp.asarray(m), jpose,
                                    jg))


def _check_result(got, want):
    assert int(got.n_matched) == int(want.n_matched) > 100
    np.testing.assert_allclose(n(got.pose.t), n(want.pose.t), atol=1e-4)
    np.testing.assert_allclose(n(got.pose.q), n(want.pose.q), atol=1e-5)
    np.testing.assert_allclose(float(got.mean_error),
                               float(want.mean_error), rtol=1e-3)


def test_register_d2d_matches_jax():
    (js, jt), (ps, pt), _ = _grids()
    jpose, ppose = _poses()
    want = jd2d.register_d2d(js, jt, jd2d.usable_mask(jt, min_points=4),
                             jpose, iterations=8)
    got = d2d.register_d2d(ps, pt, d2d.usable_mask(pt, min_points=4),
                           ppose, iterations=8)
    _check_result(got, want)
    # It recovers the identity the two samplings share.
    assert np.linalg.norm(n(got.pose.t)) < 0.02


@pytest.mark.parametrize("robust", [True, False])
def test_ndt_register_matches_jax(robust):
    (_, jt), (_, pt), (a, _) = _grids()
    m = np.ones(len(a), bool)
    jpose, ppose = _poses()
    want = jndt.register(jnp.asarray(a), jnp.asarray(m),
                         jndt.build_ndt_grid(jt, robust=robust), jpose,
                         iterations=8)
    got = ndt.register(t(a), t(m), ndt.build_ndt_grid(pt, robust=robust),
                       ppose, iterations=8)
    _check_result(got, want)


def test_register_scans_d2d_matches_jax():
    _, _, (a, b) = _grids()
    m = np.ones(len(a), bool)
    origin = np.zeros(3, np.float32)
    jpose, ppose = _poses()
    want = jd2d.register_scans_d2d(jnp.asarray(a), jnp.asarray(m),
                                   jnp.asarray(b), jnp.asarray(m), origin,
                                   1.0, capacity=2048, init_pose=jpose,
                                   iterations=8)
    got = d2d.register_scans_d2d(t(a), t(m), t(b), t(m), t(origin),
                                 torch.tensor(1.0), capacity=2048,
                                 init_pose=ppose, iterations=8)
    _check_result(got, want)


def test_gn_step_on_indefinite_h_is_zero_in_both():
    """An indefinite H (a negative eigenvalue) with many matches: the
    JAX package's Cholesky gives NaN, which its isfinite guard turns into
    no step; the port's factor reports failure, and the step is zero."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 6))
    H = (a @ a.T).astype(np.float32)
    w, v = np.linalg.eigh(H.astype(np.float64))
    w[0] = -5.0
    H = ((v * w) @ v.T).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    damping = 1e-4
    Hd = jnp.asarray(H) + (damping + 1e-6 * jnp.trace(jnp.asarray(H))) \
        * jnp.eye(6)
    jdelta = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hd),
                                         jnp.asarray(b))
    ok = bool(jnp.all(jnp.isfinite(jdelta)))
    delta, pok, _ = ne._gn_delta_shifted(t(H)[None], t(b)[None],
                                         torch.tensor([500]), damping)
    assert not ok and not bool(pok[0])
    np.testing.assert_array_equal(n(delta), np.zeros((1, 6), np.float32))
    # A positive-definite H takes the same step in both.
    Hp = (20.0 * (a @ a.T + np.eye(6))).astype(np.float32)
    Hd = jnp.asarray(Hp) + (damping + 1e-6 * jnp.trace(jnp.asarray(Hp))) \
        * jnp.eye(6)
    jdelta = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hd),
                                         jnp.asarray(b))
    delta, pok, scale = ne._gn_delta_shifted(t(Hp)[None], t(b)[None],
                                             torch.tensor([500]), damping)
    assert bool(pok[0]) and float(scale[0]) == 1.0
    np.testing.assert_allclose(n(delta)[0], n(jdelta), rtol=1e-4, atol=1e-6)
