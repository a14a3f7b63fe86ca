"""Parity of the port's SE(3) math and pose interpolation with the JAX
package, on the same seeded numpy inputs (every quaternion and pose
function of veloslam_tpu/core/se3.py, the axis-angle, matrix and Euler
conversions and to_matrix among them).

Tolerance: atol 1e-6 — both sides are float32 elementwise math on unit
quaternions and metre-scale vectors (inputs of order 1 m), so differences
are a few ulps (transcendentals and operation order differ between XLA
and torch)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.core import timeline as jtl
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core import timeline as tl

ATOL = 1e-6


def _quats(rng, k):
    q = rng.normal(size=(k, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    k = 64
    return {"qa": _quats(rng, k), "qb": _quats(rng, k),
            "ta": rng.normal(0, 2, (k, 3)).astype(np.float32),
            "tb": rng.normal(0, 2, (k, 3)).astype(np.float32),
            "v": rng.normal(0, 2, (k, 3)).astype(np.float32),
            "u": rng.random(k).astype(np.float32),
            "tangent": np.concatenate(
                [rng.normal(0, 0.5, (k, 3)),
                 rng.normal(0, 2, (k, 3))], 1).astype(np.float32),
            "axis": _quats(rng, k)[:, 1:] / np.linalg.norm(
                _quats(rng, k)[:, 1:], axis=1, keepdims=True),
            "euler": rng.uniform(-180, 180, (3, k)).astype(np.float32)}


def _leaves(x):
    """A Pose's (q, t) or a lone array."""
    return list(x) if isinstance(x, tuple) else [x]


def _pose(mod, q, tr, conv):
    return mod.Pose(conv(q), conv(tr))


CASES = {
    "quat_mul": lambda m, d, c: m.quat_mul(c(d["qa"]), c(d["qb"])),
    "quat_rotate": lambda m, d, c: m.quat_rotate(c(d["qa"]), c(d["v"])),
    "quat_conj": lambda m, d, c: m.quat_conj(c(d["qa"])),
    "quat_exp": lambda m, d, c: m.quat_exp(c(d["tangent"][:, :3])),
    "quat_log": lambda m, d, c: m.quat_log(c(d["qa"])),
    "quat_slerp": lambda m, d, c: m.quat_slerp(c(d["qa"]), c(d["qb"]),
                                               c(d["u"])),
    "compose": lambda m, d, c: m.compose(_pose(m, d["qa"], d["ta"], c),
                                         _pose(m, d["qb"], d["tb"], c)),
    "inverse": lambda m, d, c: m.inverse(_pose(m, d["qa"], d["ta"], c)),
    "apply": lambda m, d, c: m.apply(_pose(m, d["qa"], d["ta"], c),
                                     c(d["v"])),
    "interp": lambda m, d, c: m.interp(_pose(m, d["qa"], d["ta"], c),
                                       _pose(m, d["qb"], d["tb"], c),
                                       c(d["u"])),
    "exp": lambda m, d, c: m.exp(c(d["tangent"])),
    "log": lambda m, d, c: m.log(_pose(m, d["qa"], d["ta"], c)),
    "retract": lambda m, d, c: m.retract(_pose(m, d["qa"], d["ta"], c),
                                         c(d["tangent"])),
    "quat_from_axis_angle": lambda m, d, c: m.quat_from_axis_angle(
        c(d["axis"]), c(d["u"] * 7.0 - 3.5)),
    "matrix_to_quat": lambda m, d, c: m.matrix_to_quat(
        m.quat_to_matrix(c(d["qa"]))),
    "euler_deg_to_quat": lambda m, d, c: m.euler_deg_to_quat(
        *(c(a) for a in d["euler"])),
    "to_matrix": lambda m, d, c: m.to_matrix(_pose(m, d["qa"], d["ta"], c)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_op_matches_jax(data, name):
    want = CASES[name](jse3, data, jnp.asarray)
    got = CASES[name](se3, data, t)
    for w, g in zip(_leaves(want), _leaves(got), strict=True):
        np.testing.assert_allclose(n(g), n(w), atol=ATOL, rtol=0)


def test_small_angle_exp_log_match_jax():
    """The series branches near the identity (|ω| < 1e-6)."""
    tiny = np.array([[0.0, 0.0, 0.0], [1e-8, -2e-8, 3e-9],
                     [4e-7, 0.0, 0.0]], np.float32)
    np.testing.assert_allclose(n(se3.quat_exp(t(tiny))),
                               n(jse3.quat_exp(jnp.asarray(tiny))),
                               atol=ATOL, rtol=0)
    q = n(jse3.quat_exp(jnp.asarray(tiny)))
    np.testing.assert_allclose(n(se3.quat_log(t(q))),
                               n(jse3.quat_log(jnp.asarray(q))),
                               atol=ATOL, rtol=0)


def test_euler_host_copy_matches_jax():
    rng = np.random.default_rng(3)
    ang = rng.uniform(-180, 180, (3, 50))
    np.testing.assert_array_equal(se3.euler_deg_to_quat_np(*ang),
                                  jse3.euler_deg_to_quat_np(*ang))


@pytest.fixture(scope="module")
def track():
    rng = np.random.default_rng(11)
    m = 16
    rel = np.sort(rng.uniform(-0.2, 1.0, m)).astype(np.float32)
    yaw = np.cumsum(rng.normal(0, 0.05, m))
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                 1).astype(np.float32)
    tr = np.cumsum(rng.normal(0, 0.5, (m, 3)), 0).astype(np.float32)
    v = rng.normal(0, 5, (m, 3)).astype(np.float32)
    # Queries inside, on samples, and outside both ends (extrapolation).
    query = np.concatenate([rng.uniform(-0.5, 1.3, 200), rel[:4],
                            [-1.0, 2.5]]).astype(np.float32)
    return rel, q, tr, v, query


def test_interpolate_poses_matches_jax(track):
    want = jtl.interpolate_poses(*(jnp.asarray(a) for a in track))
    got = tl.interpolate_poses(*(t(a) for a in track))
    np.testing.assert_allclose(n(got.q), n(want.q), atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(got.t), n(want.t), atol=ATOL, rtol=0)


def test_interpolate_poses_extrapolates_outside_track(track):
    rel, q, tr, v, _ = track
    query = np.array([rel[0] - 0.3, rel[-1] + 0.4], np.float32)
    got = tl.interpolate_poses(t(rel), t(q), t(tr), t(v), t(query))
    np.testing.assert_allclose(n(got.t[0]), tr[0] + v[0] * (-0.3),
                               atol=1e-5)
    np.testing.assert_allclose(n(got.t[1]), tr[-1] + v[-1] * 0.4,
                               atol=1e-5)
    np.testing.assert_array_equal(n(got.q), q[[0, -1]])


def test_interpolate_poses_np_host_copy_matches_jax(track):
    a = tl.interpolate_poses_np(*track)
    b = jtl.interpolate_poses_np(*track)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_matrix_to_quat_takes_each_of_shepperds_branches():
    """Rotations by π about x, y and z and the identity: each picks
    another of the four constructions (the largest diagonal term), w ≥ 0,
    on the caller's device."""
    q = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
                  [0.5, 0.5, 0.5, 0.5]], np.float32)
    m = n(se3.quat_to_matrix(t(q)))
    got = se3.matrix_to_quat(t(m))
    want = n(jse3.matrix_to_quat(jnp.asarray(m)))
    np.testing.assert_allclose(n(got), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.abs(n(got)), np.abs(q), atol=ATOL)
    assert got.device.type == "cpu"
    assert se3.euler_deg_to_quat(0.0, 0.0, 90.0).shape == (4,)
