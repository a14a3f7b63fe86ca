"""Parity of the port's pose-graph solver with the JAX package.

Edge residuals and Jacobians: the port writes the Jacobian out where
the JAX package takes jax.jacfwd under vmap; within 1e-5 at residual
rotations from 0 (exact edges) past the 0.5 rad switch of its series
(float32 sums of terms up to ~|t| = 15 m).

The dense solve at K = 24: a drifted ring of keyframes with odometry
edges (information 1e6 on rotation, 100 on translation) and loop
closures, a 1e6 gauge prior on keyframe 0.  Both solve it in float32,
and the normal matrix mixes 1e6 weights with O(1) ones, so each Cholesky
loses ~6 of float32's 7 digits: poses agree within 2e-3 m and 1e-4 in
the quaternion, and both land on the true loop within 0.2 m.

Landmarks: the observation Jacobians against jax.jacfwd within 1e-5;
solve_with_landmarks (Schur elimination) on that loop with 14 posts
seen ~7 times each, four of the observations outliers, taken into the
port from the JAX package's own PoseGraph through `convert`: poses and
landmarks within 1e-4, before and after the residual trim, whose masks
are equal.  The port's host PoseGraph against the original: arrays,
residual norms, growth and save/load equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.graph import optimize as jopt
from veloslam_tpu.graph import pcg as jpcg
from veloslam_tpu.graph.posegraph import GraphArrays as JGraph
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.graph import optimize, pcg
from veloslam_tpu_torch.graph.posegraph import GraphArrays, PoseGraph

ODOM_INFO = [1e6] * 3 + [100.0] * 3
CLOSURE_INFO = [1e4] * 3 + [500.0] * 3


def _yaw_q(yaw):
    return np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw),
                     np.sin(yaw / 2)], -1).astype(np.float32)


def _rel(qa, ta, qb, tb):
    r = jse3.relative(jse3.Pose(jnp.asarray(qa), jnp.asarray(ta)),
                      jse3.Pose(jnp.asarray(qb), jnp.asarray(tb)))
    return np.asarray(r.q), np.asarray(r.t)


def loop_graph(K=24, n_poses=20, seed=0):
    """Keyframes on an 8 m circle; estimates drift +0.3 m/keyframe in y;
    odometry edges measure the true relative motion; closures join the
    loop's ends.  Rows past n_poses are padding."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(K) / n_poses
    true_t = np.stack([8 * np.sin(ang), 8 * (1 - np.cos(ang)),
                       np.zeros(K)], -1).astype(np.float32)
    true_q = _yaw_q(ang)
    est_t = true_t + np.stack([rng.normal(0, 0.02, K),
                               0.3 * np.arange(K), np.zeros(K)], -1)
    est_q = _yaw_q(ang + rng.normal(0, 0.01, K))
    est_t, est_q = est_t.astype(np.float32), est_q.astype(np.float32)
    est_t[n_poses:] = 0.0
    est_q[n_poses:] = [1, 0, 0, 0]
    oq, ot = _rel(true_q[:-1], true_t[:-1], true_q[1:], true_t[1:])
    ci = np.array([0, 1, 0, 2, 0, 0], np.int32)
    cj = np.array([n_poses - 1, n_poses - 1, n_poses - 2, n_poses - 1, 0, 0],
                  np.int32)
    cq, ct = _rel(true_q[ci], true_t[ci], true_q[cj], true_t[cj])
    c_valid = np.array([1, 1, 1, 1, 0, 0], bool)
    E_o = K - 1
    g = dict(
        q=est_q, t=est_t, n_poses=np.int32(n_poses),
        e_i=np.concatenate([np.arange(E_o, dtype=np.int32), ci]),
        e_j=np.concatenate([np.arange(1, K, dtype=np.int32), cj]),
        e_q=np.concatenate([oq, cq]).astype(np.float32),
        e_t=np.concatenate([ot, ct]).astype(np.float32),
        e_info=np.concatenate([np.tile(ODOM_INFO, (E_o, 1)),
                               np.tile(CLOSURE_INFO, (len(ci), 1))]
                              ).astype(np.float32),
        e_valid=np.concatenate([np.arange(E_o) < n_poses - 1, c_valid]),
        l_pos=np.zeros((1, 3), np.float32), n_landmarks=np.int32(0),
        o_i=np.zeros(1, np.int32), o_l=np.zeros(1, np.int32),
        o_z=np.zeros((1, 3), np.float32),
        o_info=np.zeros((1, 3), np.float32), o_valid=np.zeros(1, bool))
    return g, true_t


def test_edge_jacobian_matches_jax_jacfwd():
    rng = np.random.default_rng(1)
    E = 40
    def poses():
        q = rng.normal(size=(E, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return q.astype(np.float32), rng.normal(0, 5, (E, 3)).astype(
            np.float32)
    (qi, ti), (qj, tj) = poses(), poses()
    mq, mt = _rel(qi, ti, qj, tj)
    mq = mq + rng.normal(0, 0.02, mq.shape).astype(np.float32)
    mq /= np.linalg.norm(mq, axis=1, keepdims=True)
    mt = mt + rng.normal(0, 0.1, mt.shape).astype(np.float32)
    mq[:5], mt[:5] = _rel(qi[:5], ti[:5], qj[:5], tj[:5])   # exact edges
    # Large residual rotations (0.4 to 2.8 rad) on edges 5..14.
    ax = rng.normal(size=(10, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = np.linspace(0.4, 2.8, 10)
    dq = np.concatenate([np.cos(ang / 2)[:, None],
                         np.sin(ang / 2)[:, None] * ax], 1)
    mq[5:15] = n(jse3.quat_mul(jnp.asarray(mq[5:15]),
                               jnp.asarray(dq.astype(np.float32))))
    r_j, J_j = jax.vmap(jopt._edge_r_and_J)(
        *(jnp.asarray(x) for x in (qi, ti, qj, tj, mq, mt)))
    r_t, J_t = optimize.edge_r_and_J(*(t(x) for x in (qi, ti, qj, tj, mq,
                                                       mt)))
    assert tuple(J_t.shape) == (E, 6, 12)
    np.testing.assert_allclose(n(r_t), n(r_j), atol=1e-5)
    np.testing.assert_allclose(n(J_t), n(J_j), atol=1e-5)


@pytest.mark.parametrize("K,n_poses", [(24, 20), (16, 16)])
def test_solve_matches_jax(K, n_poses):
    g, true_t = loop_graph(K, n_poses)
    want, wstats = jopt.solve(JGraph(**{k: jnp.asarray(v)
                                        for k, v in g.items()}),
                              max_poses=K, iterations=6)
    got, stats = optimize.solve(GraphArrays(**{k: t(v) for k, v in
                                               g.items()}),
                                max_poses=K, iterations=6)
    np.testing.assert_allclose(n(got.t), n(want.t), atol=2e-3)
    np.testing.assert_allclose(n(got.q), n(want.q), atol=1e-4)
    np.testing.assert_array_equal(n(got.t)[n_poses:], g["t"][n_poses:])
    for a, b in ((stats.initial_cost, wstats.initial_cost),
                 (stats.final_cost, wstats.final_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-2)
    assert float(stats.final_cost) < 1e-3 * float(stats.initial_cost)
    # Both close the loop: anchored at keyframe 0, the drift is gone.
    err = np.linalg.norm(n(got.t)[:n_poses] - true_t[:n_poses], axis=1)
    assert err.max() < 0.2 and np.abs(g["t"][:n_poses] - true_t[:n_poses]
                                      ).max() > 4.0


def test_solve_auto_is_dense_up_to_the_bound_and_raises_above():
    g, _ = loop_graph(16, 16)
    tg = GraphArrays(**{k: t(v) for k, v in g.items()})
    a, _ = pcg.solve_auto(tg, max_poses=16, iterations=2)
    b, _ = optimize.solve(tg, max_poses=16, iterations=2)
    assert torch.equal(a.t, b.t)
    assert pcg.DENSE_MAX_POSES == jpcg.DENSE_MAX_POSES
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pcg.solve_auto(tg, max_poses=pcg.DENSE_MAX_POSES + 1)


def test_non_positive_definite_solve_gives_nan_poses():
    """JAX's Cholesky of an indefinite matrix yields NaN; the port's
    cholesky_ex info gate gives NaN poses too (the caller then keeps the
    uncorrected poses)."""
    g, _ = loop_graph(16, 16)
    g["e_info"] = -g["e_info"]
    got, _ = optimize.solve(GraphArrays(**{k: t(v) for k, v in g.items()}),
                            max_poses=16, iterations=1)
    want, _ = jopt.solve(JGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
                         max_poses=16, iterations=1)
    assert not np.isfinite(n(want.t)).all()
    assert not np.isfinite(n(got.t)).all()


# --- landmarks ---------------------------------------------------------------

def test_obs_jacobian_matches_jax_jacfwd():
    rng = np.random.default_rng(2)
    O = 50
    q = rng.normal(size=(O, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ti = rng.normal(0, 10, (O, 3))
    lpos = ti + rng.normal(0, 15, (O, 3))
    z = rng.normal(0, 15, (O, 3))
    args = [a.astype(np.float32) for a in (q, ti, lpos, z)]
    r_j, Jp_j, Jl_j = jax.vmap(jopt._obs_r_and_J)(
        *(jnp.asarray(a) for a in args))
    r_t, Jp_t, Jl_t = optimize.obs_r_and_J(*(t(a) for a in args))
    assert tuple(Jp_t.shape) == (O, 3, 6) and tuple(Jl_t.shape) == (O, 3, 3)
    np.testing.assert_allclose(n(r_t), n(r_j), atol=1e-5)
    np.testing.assert_allclose(n(Jp_t), n(Jp_j), atol=1e-5)
    np.testing.assert_allclose(n(Jl_t), n(Jl_j), atol=1e-5)


def landmark_graph(seed=0, K=32, n_poses=28, M=16, n_landmarks=14,
                   n_obs=100):
    """The JAX package's host PoseGraph of a drifted loop (loop_graph's
    edges) plus posts seen ~7 times each: measurements from the true
    poses with 5 cm noise and four 0.8-2 m outliers (beyond the 0.5 m
    Huber delta), landmark estimates 0.3 m off."""
    from veloslam_tpu.graph.posegraph import PoseGraph as JPoseGraph
    g, true_t = loop_graph(K, n_poses, seed)
    rng = np.random.default_rng(seed + 1)
    ang = 2 * np.pi * np.arange(K) / n_poses
    true_q = _yaw_q(ang)
    jg = JPoseGraph(max_poses=K, max_edges=len(g["e_i"]), max_landmarks=M,
                    max_obs=128)
    for k in range(n_poses):
        jg.add_pose(g["q"][k], g["t"][k])
    for e in np.flatnonzero(g["e_valid"]):
        jg.add_edge(int(g["e_i"][e]), int(g["e_j"][e]), g["e_q"][e],
                    g["e_t"][e], info=g["e_info"][e])
    posts = true_t[:n_poses][rng.integers(0, n_poses, n_landmarks)] \
        + rng.normal(0, 6, (n_landmarks, 3)) * [1, 1, 0.2]
    for m in range(n_landmarks):
        jg.add_landmark(posts[m] + rng.normal(0, 0.3, 3))
    for o in range(n_obs):
        m = o % n_landmarks
        k = int(rng.integers(0, n_poses))
        z = n(jse3.apply(jse3.inverse(jse3.Pose(jnp.asarray(true_q[k]),
                                                jnp.asarray(true_t[k]))),
                         jnp.asarray(posts[m].astype(np.float32))))
        z = z + rng.normal(0, 0.05, 3)
        if o % 25 == 3:
            z = z + rng.uniform(0.8, 2.0, 3) * rng.choice([-1, 1], 3)
        jg.add_observation(k, m, z, info=(8.0,) * 3)
    return jg, posts


def _solve_both(jg, K, M, iterations=6):
    leaves = jg.arrays()
    want, wstats = jopt.solve_with_landmarks(
        JGraph(*(jnp.asarray(x) for x in leaves)), max_poses=K,
        max_landmarks=M, iterations=iterations)
    got, stats = pcg.solve_auto_landmarks(
        convert.graph_arrays_from_numpy(leaves, "cpu"), max_poses=K,
        max_landmarks=M, iterations=iterations)
    return want, wstats, got, stats


def test_solve_with_landmarks_matches_jax(tmp_path):
    """Poses and landmarks within 1e-4 of the JAX solve, before and after
    the residual trim (the trim masks equal); the costs agree and fall;
    padding rows stay put."""
    jg, posts = landmark_graph()
    K, M = jg.K, jg.M
    want, wstats, got, stats = _solve_both(jg, K, M)
    for k in ("q", "t", "l_pos"):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(want, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(n(got.t)[jg.n_poses:],
                                  jg.t[jg.n_poses:])
    np.testing.assert_array_equal(n(got.l_pos)[jg.n_landmarks:],
                                  jg.l_pos[jg.n_landmarks:])
    for a, b in ((stats.initial_cost, wstats.initial_cost),
                 (stats.final_cost, wstats.final_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-2)
    assert float(stats.final_cost) < 0.1 * float(stats.initial_cost)
    # Residual trim, both packages' host graphs from the same solve.
    jg.save(tmp_path / "graph.npz")
    pg = convert.posegraph_from_numpy(dict(np.load(tmp_path / "graph.npz")))
    for graph in (jg, pg):
        graph.update_from(n(want.q)[:jg.n_poses], n(want.t)[:jg.n_poses],
                          n(want.l_pos)[:jg.n_landmarks])
    dropped = jg.trim_observations(1.0)
    assert pg.trim_observations(1.0) == dropped >= 2
    np.testing.assert_array_equal(pg.o_ok, jg.o_ok)
    want, _, got, _ = _solve_both(jg, K, M)
    for k in ("q", "t", "l_pos"):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(want, k)),
                                   atol=1e-4, err_msg=f"trimmed {k}")
    err = np.linalg.norm(n(got.l_pos)[:jg.n_landmarks] - posts, axis=1)
    assert err.max() < 0.2


def test_posegraph_matches_jax_builder(tmp_path):
    """The port's PoseGraph, loaded from the JAX graph's save, gives the
    same arrays (as tensors), poses and residual norms, and grows and
    saves as the original does."""
    jg, _ = landmark_graph(seed=3)
    jg.save(tmp_path / "j.npz")
    pg = convert.posegraph_from_numpy(np.load(tmp_path / "j.npz"))
    ja, pa = jg.arrays(), pg.arrays("cpu")
    for f in JGraph._fields:
        np.testing.assert_array_equal(n(getattr(pa, f)), getattr(ja, f),
                                      err_msg=f)
    np.testing.assert_array_equal(pg.obs_residual_norms(),
                                  jg.obs_residual_norms())
    for graph in (jg, pg):          # past every capacity: geometric growth
        for _ in range(40):
            graph.add_pose([1, 0, 0, 0], [1, 2, 3])
            graph.add_edge(0, 1, [1, 0, 0, 0], [0, 0, 1])
            graph.add_landmark([4, 5, 6])
            graph.add_observation(1, 2, [0, 1, 0])
    assert (pg.K, pg.E, pg.M, pg.O) == (jg.K, jg.E, jg.M, jg.O)
    pg.save(tmp_path / "p.npz")
    PoseGraph.load(tmp_path / "p.npz").save(tmp_path / "p2.npz")
    jg.save(tmp_path / "j.npz")
    j, p = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p2.npz")
    assert p.files == j.files
    for f in j.files:
        np.testing.assert_array_equal(p[f], j[f], err_msg=f)


def test_solve_auto_landmarks_raises_above_the_dense_bound():
    jg, _ = landmark_graph()
    g = convert.graph_arrays_from_numpy(jg.arrays(), "cpu")
    with pytest.raises(NotImplementedError, match="solve_pcg_landmarks"):
        pcg.solve_auto_landmarks(g, max_poses=pcg.DENSE_MAX_POSES + 1,
                                 max_landmarks=16)
