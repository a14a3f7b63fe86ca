"""Parity of the port's matrix-free PCG pose-graph solvers with the JAX
package (veloslam_tpu/graph/pcg.py), on the CPU, where the chain
preconditioner takes its plain version (graph/chain.py).

* Each piece against the JAX package's private function on the same
  numpy inputs: the edge terms, the right-hand side and block diagonal,
  H·v, the chain couplings, the chain factorisation and solve, the
  observation terms and the landmark elimination.  float32 sums in
  another order: 1e-5 relative to the largest entry (the gauge puts 1e6
  on pose 0), the chain within 1e-4 relative (a 64-step recurrence).
* solve_pcg with both preconditioners on the drifted 48-pose ring of
  tests/test_graph.py::test_pcg_matches_dense_solver, and
  solve_pcg_landmarks on ::test_pcg_landmarks_matches_dense_schur's
  12-pose graph, at the production cg_iters: poses (and landmarks)
  within 1e-3 m of JAX's, costs within 1e-3 relative; with landmarks
  also within 5 mm of the dense Schur solve, as there.
* The goldens of chip_smoke.py's phases `pcg` and `long_drive` against
  their generators' configurations.
* The 2 s test drive through both packages' SlamPipeline with a 64-row
  keyframe ring and DENSE_MAX_POSES patched down to 32 in both pcg
  modules, so the device finalize and the landmark solves take PCG on
  both sides: the same frames, keyframes, closures and landmarks, the
  trajectory within 1 cm.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_pipeline_drive
from test_graph import _noisy_circle_graph
from torch_helpers import n, port_pose, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.graph import pcg as jpcg
from veloslam_tpu.graph.posegraph import GraphArrays as JGraph
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.graph import chain, optimize, pcg
from veloslam_tpu_torch.graph.posegraph import relative_pose_measurement

PIPELINE_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                               "pipeline_golden_seed3.npz")
DAMPING, PRIOR = 1e-4, 1e6


def ring_graph():
    """The drifted 48-pose ring with a 47 → 0 closure in 64 pose rows."""
    rng = np.random.default_rng(7)
    g, true = _noisy_circle_graph(rng, n=48, drift=0.03, yaw_drift=0.01,
                                  max_poses=64, max_edges=128)
    rel_q, rel_t = relative_pose_measurement(port_pose(true[47]),
                                             port_pose(true[0]))
    g.add_edge(47, 0, rel_q, rel_t, info=(1000.0,) * 6)
    return g


def landmark_graph():
    """The 12-pose drifted ring with 8 landmarks seen within 40 m."""
    rng = np.random.default_rng(7)
    nk = 12
    g, true = _noisy_circle_graph(rng, n=nk, drift=0.02, yaw_drift=0.005,
                                  max_poses=16, max_edges=32)
    true_lm = rng.uniform(-30, 30, (8, 3)).astype(np.float32)
    true_lm[:, 2] = rng.uniform(0, 5, 8)
    for m in range(8):
        g.add_landmark(true_lm[m] + rng.normal(0, 0.3, 3))
    for k in range(nk):
        for m in range(8):
            z = np.asarray(jse3.apply(jse3.inverse(true[k]),
                                      jnp.asarray(true_lm[m])))
            if np.linalg.norm(z) < 40:
                g.add_observation(k, m, z + rng.normal(0, 0.01, 3),
                                  info=(100.0,) * 3)
    return g


def both(jg):
    """A JAX PoseGraph as JAX GraphArrays and the port's CPU tensors."""
    leaves = jg.arrays()
    return (JGraph(*(jnp.asarray(x) for x in leaves)),
            convert.graph_arrays_from_numpy(leaves, "cpu"))


def close(got, want, rel=1e-5, err_msg=""):
    """|got − want| ≤ rel · max|want| (+ 1e-6), elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-6,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def ring():
    jg = ring_graph()
    ja, ta = both(jg)
    K = jg.K
    jr, jJ, jw = jpcg._edge_terms(ja)
    tr, tJ, tw = pcg._edge_terms(ta)
    return jg, ja, ta, pcg._segments(ta, K), K, (jr, jJ, jw), (tr, tJ, tw)


def test_edge_terms_match_jax(ring):
    *_, want, got = ring
    for name, a, b in zip(("r", "J", "w"), got, want):
        close(a, b, err_msg=name)


def test_rhs_and_diagonal_match_jax(ring):
    _, ja, ta, seg, K, (jr, jJ, jw), (tr, tJ, tw) = ring
    want = jpcg._assemble_rhs_diag(ja, jr, jJ, jw, K, DAMPING, PRIOR)
    got = pcg._assemble_rhs_diag(seg, tr, tJ, tw, DAMPING, PRIOR)
    for name, a, b in zip(("b", "D", "cost"), got, want):
        close(a, b, err_msg=name)
    assert n(got[1])[0, 0, 0] > PRIOR               # the gauge on pose 0


def test_hv_matches_jax(ring):
    _, ja, ta, seg, K, (jr, jJ, jw), (tr, tJ, tw) = ring
    v = np.random.default_rng(0).normal(size=(K, 6)).astype(np.float32)
    want = jpcg._make_hv(ja, jJ, jw, K, DAMPING, PRIOR)(jnp.asarray(v))
    got = pcg._make_hv(ta, seg, tJ, tw, DAMPING, PRIOR)(t(v))
    close(got, want)


def test_chain_terms_match_jax(ring):
    jg, ja, ta, seg, K, (jr, jJ, jw), (tr, tJ, tw) = ring
    want = jpcg._chain_terms(ja, jJ, jw, K)
    got = pcg._chain_terms(seg, tJ, tw)
    assert tuple(got.shape) == (K, 6, 6)
    close(got, want)
    # Only consecutive edges couple: the 47 → 0 closure and the padding
    # rows past the last pose add nothing.
    assert not n(got)[jg.n_poses - 1:].any()


def test_chain_factor_and_solve_match_jax(ring):
    """The plain chain recurrences against JAX's scans on the solver's own
    D (with the 2% floor) and B, and M z = r checked against the dense
    block-tridiagonal M in float64."""
    _, ja, ta, seg, K, (jr, jJ, jw), (tr, tJ, tw) = ring
    _, D, _ = pcg._assemble_rhs_diag(seg, tr, tJ, tw, DAMPING, PRIOR)
    D = pcg._chain_floor(D)
    B = pcg._chain_terms(seg, tJ, tw)
    r = np.random.default_rng(1).normal(size=(K, 6)).astype(np.float32)
    jU, jL = jpcg._chain_precond(jnp.asarray(n(D)), jnp.asarray(n(B)), K)
    U, L = chain.chain_factor(D, B)
    close(U, jU, rel=1e-4, err_msg="Uinv")
    close(L, jL, rel=1e-4, err_msg="L")
    assert not n(L)[0].any()
    want = jpcg._chain_solve(jU, jL, jnp.asarray(n(B)), jnp.asarray(r))
    z = chain.chain_solve(U, L, B, t(r))
    close(z, want, rel=1e-4)
    M = np.zeros((6 * K, 6 * K))
    for k in range(K):
        M[6 * k:6 * k + 6, 6 * k:6 * k + 6] = n(D)[k]
        if k + 1 < K:
            M[6 * k:6 * k + 6, 6 * k + 6:6 * k + 12] = n(B)[k]
            M[6 * k + 6:6 * k + 12, 6 * k:6 * k + 6] = n(B)[k].T
    z64 = chain.chain_solve_plain(*chain.chain_factor_plain(
        D.double(), B.double()), B.double(), t(r).double())
    np.testing.assert_allclose(M @ n(z64).ravel(), r.ravel(), atol=1e-9)


def test_chain_wrappers_take_the_plain_path_on_cpu_and_check_inputs():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    D = t(A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32))
    B = t(0.1 * rng.normal(size=(5, 6, 6)).astype(np.float32))
    r = t(rng.normal(size=(5, 6)).astype(np.float32))
    before = dict(chain.LAUNCHES)
    U, L = chain.chain_factor(D, B)
    z = chain.chain_solve(U, L, B, r)
    assert chain.LAUNCHES == before
    for got, want in zip((U, L, z), (*chain.chain_factor_plain(D, B),
                                     chain.chain_solve_plain(U, L, B, r))):
        assert torch.equal(got, want)
    with pytest.raises(TypeError):
        chain.chain_factor(D.double(), B.double())
    with pytest.raises(ValueError):
        chain.chain_factor(D[:, :5], B[:, :5])
    with pytest.raises(ValueError):
        chain.chain_solve(U, L, B, r[:4])
    with pytest.raises(ValueError):
        chain.chain_solve(U, L, B.transpose(1, 2), r)
    e = torch.empty((0, 6, 6))
    assert chain.chain_factor(e, e)[0].shape == (0, 6, 6)
    assert chain.chain_solve(e, e, e, torch.empty((0, 6))).shape == (0, 6)


def test_planned_segment_sums_match_segment_sum():
    """core.segment's planned sums (the PCG solvers' fixed-order segment
    sums) equal segment_sum with the invalid rows zeroed, bitwise on the
    CPU (both add each segment's rows in row order), with empty segments
    0 and the invalid rows (70 on one id) split into trash segments of
    at most 32."""
    from veloslam_tpu_torch.core.segment import (segment_plan, segment_sum,
                                                 segment_sum_planned)
    rng = np.random.default_rng(4)
    ids = np.concatenate([rng.integers(0, 9, 50), np.zeros(70, int)])
    valid = np.concatenate([rng.random(50) < 0.8, np.zeros(70, bool)])
    data = t(rng.normal(size=(120, 6, 6)).astype(np.float32))
    plan = segment_plan(t(ids.astype(np.int32)), 10, t(valid))
    assert n(plan.lengths)[:10].sum() == valid.sum()
    left_out = int((~valid).sum())                 # 70 + ~10
    assert n(plan.lengths)[10:].tolist() == [32, 32, left_out - 64, 0]
    got = segment_sum_planned(data, plan)
    want = segment_sum(data * t(valid)[:, None, None], t(ids), 10)
    assert got.shape == (10, 6, 6) and torch.equal(got, want)
    assert not n(got)[9].any()                      # id 9 never occurs


@pytest.fixture(scope="module")
def lm():
    jg = landmark_graph()
    ja, ta = both(jg)
    return jg, ja, ta


def test_obs_terms_and_landmark_elimination_match_jax(lm):
    jg, ja, ta = lm
    K, M = jg.K, jg.M
    want_o = jpcg._obs_terms(ja)
    got_o = pcg._obs_terms(ta)
    for name, a, b in zip(("r", "Jp", "Jl", "w"), got_o, want_o):
        close(a, b, err_msg=name)
    want = jpcg._landmark_elimination(ja, *want_o, K, M, DAMPING)
    got = pcg._landmark_elimination(ta, pcg._segments(ta, K, M), *got_o,
                                    DAMPING)
    for name, i in (("b_p", 0), ("D_o", 1), ("All_inv", 2), ("b_l", 3),
                    ("cost", 7)):
        close(got[i], want[i], err_msg=name)
    assert not n(got[2])[jg.n_landmarks:].any()     # masked landmark rows
    rng = np.random.default_rng(3)
    v = rng.normal(size=(K, 6)).astype(np.float32)
    y = rng.normal(size=(M, 3)).astype(np.float32)
    close(got[4](t(v)), want[4](jnp.asarray(v)), err_msg="T")
    close(got[5](t(y)), want[5](jnp.asarray(y)), err_msg="Tt")
    close(got[6](t(v)), want[6](jnp.asarray(v)), err_msg="schur_apply")


@pytest.mark.parametrize("precond", ["chain", "jacobi"])
def test_solve_pcg_matches_jax(ring, precond):
    """On the 48-pose ring at the production cg_iters: poses within
    1e-3 m / 1e-4 of JAX's PCG, costs within 1e-3 relative, padding rows
    unchanged, the cost down a hundredfold."""
    jg, ja, ta, _, K, _, _ = ring
    kw = dict(max_poses=K, iterations=6, cg_iters=96, precond=precond)
    want, wstats = jpcg.solve_pcg(ja, **kw)
    got, stats = pcg.solve_pcg(ta, **kw)
    np.testing.assert_allclose(n(got.t), n(want.t), atol=1e-3)
    np.testing.assert_allclose(n(got.q), n(want.q), atol=1e-4)
    np.testing.assert_array_equal(n(got.t)[jg.n_poses:], jg.t[jg.n_poses:])
    for a, b in ((stats.initial_cost, wstats.initial_cost),
                 (stats.final_cost, wstats.final_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-3)
    assert stats.iterations == 6
    assert float(stats.final_cost) < 1e-2 * float(stats.initial_cost)


def test_solve_pcg_rejects_an_unknown_preconditioner(ring):
    with pytest.raises(ValueError, match="precond"):
        pcg.solve_pcg(ring[2], max_poses=ring[4], iterations=1,
                      precond="ilu")


def test_solve_pcg_landmarks_matches_jax(lm):
    """On the 12-pose landmark graph: poses and landmarks within 1e-3 m of
    JAX's, costs within 1e-3 relative, padding rows unchanged, and within
    5 mm of the dense Schur solve (as in tests/test_graph.py)."""
    jg, ja, ta = lm
    kw = dict(max_poses=jg.K, max_landmarks=jg.M, iterations=8,
              cg_iters=96)
    want, wstats = jpcg.solve_pcg_landmarks(ja, **kw)
    got, stats = pcg.solve_pcg_landmarks(ta, **kw)
    for k in ("t", "l_pos"):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(want, k)),
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(n(got.q), n(want.q), atol=1e-4)
    np.testing.assert_array_equal(n(got.l_pos)[jg.n_landmarks:],
                                  jg.l_pos[jg.n_landmarks:])
    for a, b in ((stats.initial_cost, wstats.initial_cost),
                 (stats.final_cost, wstats.final_cost)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-3)
    dense, ds = optimize.solve_with_landmarks(
        ta, max_poses=jg.K, max_landmarks=jg.M, iterations=8)
    nk, nl = jg.n_poses, jg.n_landmarks
    np.testing.assert_allclose(n(got.t)[:nk], n(dense.t)[:nk], atol=5e-3)
    np.testing.assert_allclose(n(got.l_pos)[:nl], n(dense.l_pos)[:nl],
                               atol=5e-3)
    assert float(stats.final_cost) < 1.01 * float(ds.final_cost) + 1e-6


@pytest.fixture(scope="module")
def forced_pcg_drive(tmp_path_factory):
    """The 2 s test drive (pipeline_golden_seed3.npz's "small") through
    the JAX SlamPipeline and the port's on the CPU, with a 64-row ring and
    DENSE_MAX_POSES = 32 in both pcg modules: every graph solve of the
    session takes PCG.  The PCG entry points are wrapped to count their
    calls (the JAX ones count traces: its solves run under jit, retraced
    after the caches are cleared)."""
    from fixtures.gen_torch_pipeline_golden import jax_slam_config
    from veloslam_tpu.runtime.pipeline import SlamPipeline as JSlamPipeline
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    cfg = json.loads(str(np.load(PIPELINE_GOLDEN)["config"]))
    drive = copy.deepcopy({d["name"]: d for d in cfg["drives"]}["small"])
    drive["slam"]["graph"]["max_keyframes"] = 64
    calls = {}
    mp = pytest.MonkeyPatch()
    for side, mod in (("port", pcg), ("jax", jpcg)):
        mp.setattr(mod, "DENSE_MAX_POSES", 32)
        for name in ("solve_pcg", "solve_pcg_landmarks"):
            def counted(*a, _f=getattr(mod, name), _k=(side, name), **kw):
                calls[_k] = calls.get(_k, 0) + 1
                return _f(*a, **kw)
            mp.setattr(mod, name, counted)
    jax.clear_caches()
    try:
        paths, seq = write_pipeline_drive(
            drive, cfg["model"], str(tmp_path_factory.mktemp("pcg_drive")))
        out = {}
        for side, make in (
                ("jax", lambda: JSlamPipeline(jax_slam_config(drive["slam"]))),
                ("port", lambda: SlamPipeline(
                    SlamConfig.from_dict(drive["slam"]), device="cpu"))):
            pipe = make()
            pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                     batch=drive["batch"], defer_map=True)
            out[side] = (pipe, pipe.finalize())
    finally:
        mp.undo()
        jax.clear_caches()
    return out, calls, seq


def test_forced_pcg_drive_matches_jax(forced_pcg_drive):
    out, calls, seq = forced_pcg_drive
    (jp, want), (pp, got) = out["jax"], out["port"]
    # PCG on both sides: the device finalize's pose-only solve, and the
    # landmark solve before and after the residual trim.
    for side in ("jax", "port"):
        assert calls.get((side, "solve_pcg"), 0) >= 1, calls
        assert calls.get((side, "solve_pcg_landmarks"), 0) >= 1, calls
    trimmed = not pp.graph.o_ok[:pp.graph.n_obs].all()
    assert calls[("port", "solve_pcg")] == 1
    assert calls[("port", "solve_pcg_landmarks")] == 1 + trimmed
    assert got["n_frames"] == want["n_frames"]
    np.testing.assert_array_equal(got["times_us"], want["times_us"])
    assert got["n_keyframes"] == want["n_keyframes"] > 0
    np.testing.assert_array_equal(got["keyframe_times_us"],
                                  want["keyframe_times_us"])
    assert sorted(pp.closures) == sorted(jp.closures) and pp.closures
    assert got["n_landmarks"] == want["n_landmarks"] >= 2
    assert got["n_landmark_obs"] == want["n_landmark_obs"]
    np.testing.assert_array_equal(pp.graph.o_ok[:pp.graph.n_obs],
                                  jp.graph.o_ok[:jp.graph.n_obs])
    np.testing.assert_allclose(got["positions"], want["positions"],
                               atol=0.01)
    np.testing.assert_allclose(got["keyframe_positions"],
                               want["keyframe_positions"], atol=0.01)
    np.testing.assert_allclose(pp.graph.l_pos[:pp.graph.n_landmarks],
                               jp.graph.l_pos[:jp.graph.n_landmarks],
                               atol=0.01)
    assert np.isfinite(got["positions"]).all()


def test_pcg_goldens_match_their_generators():
    """chip_smoke's PCG golden was made from today's PCG_GRAPHS and solve
    counts; the long-drive golden's drive and SlamConfig are its
    generator's and tests/test_fullslam.py::
    test_unbounded_session_end_to_end's (the JAX package's SlamConfig
    with the same overrides)."""
    import dataclasses

    from chip_smoke import (LONG_DRIVE_GOLDEN, PCG_CG_ITERS, PCG_GOLDEN,
                            PCG_GRAPHS, PCG_ITERATIONS)
    from fixtures.gen_torch_long_drive_golden import golden_config
    from veloslam_tpu.config import (GraphConfig, RegistrationConfig,
                                     SensorConfig, SlamConfig)
    cfg = json.loads(str(np.load(PCG_GOLDEN)["config"]))
    assert cfg == json.loads(json.dumps({"graphs": PCG_GRAPHS,
                                         "iterations": PCG_ITERATIONS,
                                         "cg_iters": PCG_CG_ITERS}))
    long = json.loads(str(np.load(LONG_DRIVE_GOLDEN)["config"]))
    assert long == golden_config()
    want = dataclasses.asdict(SlamConfig(
        sensor=SensorConfig(rpm=3600.0),
        registration=RegistrationConfig(max_points=2048, max_iterations=4),
        graph=GraphConfig(keyframe_translation_m=0.05,
                          loop_closure_min_gap=600)))
    want.pop("mesh")
    assert long["drive"]["slam"] == json.loads(json.dumps(want))
    gold = np.load(LONG_DRIVE_GOLDEN)
    assert int(gold["n_keyframes"]) > pcg.DENSE_MAX_POSES
