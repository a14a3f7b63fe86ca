"""The port on a CUDA card: the hand-written normal-equations and gather
kernels against their plain versions, the wrappers' input checks, and
the odometry slice on the card against the same slice on the CPU.
Marked `cuda`; each test skips where
torch.cuda.is_available() is false.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \
        tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax, which that machine
need not have; this module imports no jax.)
"""

import numpy as np
import pytest
import torch

from torch_helpers import normal_equation_slots, port_args, with_edge_slots
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.registration import gather as ga
from veloslam_tpu_torch.registration import normal_equations as ne
from veloslam_tpu_torch.runtime import odometry as odo

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("F,P", [(96, 16384), (3, 1000), (1, 1), (5, 0)])
def test_kernel_matches_plain_on_card(card, F, P):
    """|Δ| ≤ 1e-4·max|ref| + 1e-3 on H and b, 1e-4 relative on the sums,
    n_hit exact, two launches bitwise equal; LAUNCHES counts each."""
    args = [a.to(card) for a in
            port_args(*normal_equation_slots(F, P, seed=F + P))]
    before = ne.LAUNCHES
    got = ne.fused_normal_equations(*args)
    again = ne.fused_normal_equations(*args)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 2
    ref = ne.normal_equations_plain(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for x, r in zip(got[:2], ref[:2]):
        lim = 1e-4 * (r.abs().max().item() if r.numel() else 0) + 1e-3
        assert (x - r).abs().max().item() <= lim
    for x, r in zip(got[2:4], ref[2:4]):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-6)
    assert torch.equal(got[4], ref[4])


def _nan_equal_close(x, r, lim):
    """NaN entries equal, the rest within `lim`."""
    nan = torch.isnan(r)
    assert torch.equal(torch.isnan(x), nan)
    assert ((x - r).abs()[~nan] <= lim).all()


@pytest.mark.parametrize("F,P", [(96, 16384), (128, 8192), (3, 1000),
                                 (3, 1001), (1, 1), (5, 0)])
def test_gn_iteration_matches_plain_on_card(card, F, P):
    """The fused step against gn_iteration_plain (P = 1001 and 1 take the
    kernel's scalar-load instance), with the edge slots of
    with_edge_slots (rejected for few hits, clamped, NaN): decisions and
    n_hit exact; H, b at the NE tolerance with NaNs equal; the pose within
    1e-5 m / 1e-6 of the plain step on the kernel's own H, b (the same
    float32 6×6 system, another Cholesky); a rejected pose unchanged; two
    calls bitwise equal, one launch counted each."""
    slots = normal_equation_slots(F, P, seed=F + P)
    if F >= 3 and P:
        slots = with_edge_slots(*slots)
    pts, q, t, mu, n, hit = [a.to(card) for a in port_args(*slots)]
    pose = se3.Pose(q, t)
    before = ne.LAUNCHES
    got = ne.gn_iteration(pts, pose, mu, n, hit)
    again = ne.gn_iteration(pts, pose, mu, n, hit)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 2
    ref = ne.gn_iteration_plain(pts, pose, mu, n, hit)
    own = ne._gn_step(pose, got.H, got.b, got.n_hit, 1e-6)
    for a, b in zip((*got.pose, *got[1:]), (*again.pose, *again[1:])):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert torch.equal(got.step, ref.step)
    assert torch.equal(got.n_hit, ref.n_hit)
    if F >= 3 and P:
        assert got.step[:3].tolist() == [0, 2, 0]
    else:
        assert got.step.tolist() == [0] * F
    for x, r in ((got.H, ref.H), (got.b, ref.b)):
        finite = r[~torch.isnan(r)]
        _nan_equal_close(x, r, 1e-4 * (finite.abs().max().item()
                                       if finite.numel() else 0) + 1e-3)
    kept = got.step == 0
    assert torch.equal(got.pose.q[kept], q[kept])
    assert torch.equal(got.pose.t[kept], t[kept])
    assert (got.pose.t - own.t).abs().max().item() <= 1e-5
    assert (got.pose.q - own.q).abs().max().item() <= 1e-6


def test_normal_equations_reject_misaligned_on_card(card):
    """The kernel loads 16-byte vectors: a contiguous view that starts
    4 bytes into its storage is refused, not read misaligned."""
    pts, q, t, mu, n, hit = [a.to(card) for a in
                             port_args(*normal_equation_slots(2, 64, seed=9))]
    shifted = torch.empty(pts.numel() + 1, device=card)[1:].view(pts.shape)
    shifted.copy_(pts)
    with pytest.raises(ValueError, match="aligned"):
        ne.fused_normal_equations(shifted, q, t, mu, n, hit)
    with pytest.raises(ValueError, match="aligned"):
        ne.gn_iteration(shifted, se3.Pose(q, t), mu, n, hit)


def test_odometry_on_card_matches_cpu(card):
    world = sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24)
    seq = sim.generate_sequence(duration_s=0.8, model="hdl32", seed=23,
                                world=world)
    track = sim.truth_track(seq, drift_rate=0.3)
    kw = dict(voxel_size=0.5, reg_points=2048, reg_iterations=16,
              map_capacity=16384, reassociate_every=8)
    out = {}
    for dev in ("cpu", card):
        o = odo.StreamingOdometry(DeviceCalib.from_host(cal.hdl32(),
                                                        device=dev), **kw)
        before = ne.LAUNCHES
        out[str(dev)] = o.run(seq["packets"], seq["pkt_times_us"], track,
                              batch=256)
        launches = ne.LAUNCHES - before
        assert launches == (16 * o.batches_fed if dev == card else 0)
    a, b = out["cpu"], out[str(card)]
    assert a["n_frames"] == b["n_frames"] >= 5
    np.testing.assert_array_equal(a["times_us"], b["times_us"])
    assert np.abs(a["positions"] - b["positions"]).max() < 0.01


@pytest.mark.parametrize("name,N,M", [
    ("gather_i32", 1 << 21, 1), ("gather_i32", 1 << 21, 1000),
    ("gather_i32", 65536, 4097), ("gather_i32", 7, 0),
    ("gather_i32", 1 << 21, 1572867),
    ("gather_rows8", 32768, 1), ("gather_rows8", 32768, 1000),
    ("gather_rows8", 1000, 4097), ("gather_rows8", 3, 0)])
def test_gather_kernels_match_plain_on_card(card, name, N, M):
    """Bitwise equal to table[idx] at sizes that are no multiple of a
    block (M = 1572867: the bulk path's M + 3, a scalar tail); LAUNCHES
    counts each launch (an empty gather launches none)."""
    rng = np.random.default_rng(N + M)
    if name == "gather_i32":
        table = rng.integers(-1, 32768, N).astype(np.int32)
    else:
        table = rng.standard_normal((N, 8)).astype(np.float32)
    table = torch.as_tensor(table, device=card)
    idx = torch.as_tensor(rng.integers(0, N, M).astype(np.int32),
                          device=card)
    before = ga.LAUNCHES[name]
    got = getattr(ga, name)(table, idx)
    torch.cuda.synchronize()
    assert ga.LAUNCHES[name] == before + (1 if M else 0)
    ref = getattr(ga, f"{name}_plain")(table, idx)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_gather_wrappers_check_inputs_on_card(card):
    rows = torch.zeros((17, 8), device=card)
    idx = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        ga.gather_rows8(rows.reshape(-1)[1:129].reshape(16, 8), idx)
    with pytest.raises(ValueError):
        ga.gather_i32(torch.zeros(8, dtype=torch.int32, device=card),
                      idx.cpu())
    with pytest.raises(TypeError):
        ga.gather_i32(torch.zeros(8, dtype=torch.int32, device=card),
                      idx.long())
    with pytest.raises(ValueError):
        ga.gather_rows8(rows, idx[::2])
    with pytest.raises(ValueError, match="aligned"):
        ga.gather_i32(torch.zeros(8, dtype=torch.int32, device=card), idx[1:])


def test_small_fullslam_on_card_matches_jax_golden(card):
    """The CPU end-to-end drive of test_torch_fullslam on the card:
    counts and times exact, candidate and accepted pairs equal as sets
    (near-tied values may permute slots on the card), trajectory within
    1 cm in 3-D, as on the CPU; every kernel launched."""
    import json
    import os

    from veloslam_tpu_torch.runtime.fullslam import FullSlam
    gold = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "fullslam_golden_seed3.npz"))
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["small"]
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=cfg["model"],
        seed=drive["seed"], world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    eng = FullSlam(DeviceCalib.from_host(cal.hdl32(), device=card),
                   model=cfg["model"], **drive["engine"])
    before = (ne.LAUNCHES, dict(ga.LAUNCHES))
    eng.run_device(seq["packets"], seq["pkt_times_us"],
                   sim.truth_track(seq, drift_rate=drive["drift_rate"]),
                   batch=drive["batch"])
    out = eng.finalize_device(max_candidates=drive["max_candidates"],
                              **drive["finalize"])
    h = {k: v.cpu().numpy() for k, v in out.items()
         if isinstance(v, torch.Tensor)}
    assert ne.LAUNCHES > before[0]
    assert all(ga.LAUNCHES[k] > before[1][k] for k in ga.LAUNCHES)
    nf = int(h["n_frames"])
    assert nf == int(gold["small_n_frames"])
    assert int(h["kf_n"]) == int(gold["small_kf_n"])
    for flag in ("cand_valid", "accept"):
        def pairs(i, j, f):
            return sorted(zip(i[f].tolist(), j[f].tolist()))
        assert pairs(h["cand_i"], h["cand_j"], h[flag]) == pairs(
            gold["small_cand_i"], gold["small_cand_j"], gold[f"small_{flag}"])
    d = np.linalg.norm(h["traj_t"][:nf] - gold["small_positions"], axis=1)
    assert d.max() < 0.01


def _landmark_graph(K=24, n_landmarks=12, n_obs=90, seed=0):
    """A drifted 8 m loop of K keyframes (odometry edges from the true
    motion, one loop closure) with posts seen from ~7 keyframes each
    (5 cm noise), landmark estimates 0.3 m off: the port's PoseGraph."""
    from veloslam_tpu_torch.graph.posegraph import PoseGraph
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(K) / K
    true = se3.Pose(
        torch.as_tensor(np.stack([np.cos(ang / 2), 0 * ang, 0 * ang,
                                  np.sin(ang / 2)], -1), dtype=torch.float32),
        torch.as_tensor(np.stack([8 * np.sin(ang), 8 * (1 - np.cos(ang)),
                                  0 * ang], -1), dtype=torch.float32))
    g = PoseGraph(max_poses=32, max_edges=64, max_landmarks=16, max_obs=128)
    drift = np.stack([rng.normal(0, 0.02, K), 0.2 * np.arange(K),
                      np.zeros(K)], -1)
    for k in range(K):
        g.add_pose(true.q[k].numpy(), true.t[k].numpy() + drift[k])
    info = (1e4,) * 3 + (100.0,) * 3
    for i, j in [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]:
        rel = se3.relative(se3.Pose(true.q[i], true.t[i]),
                           se3.Pose(true.q[j], true.t[j]))
        g.add_edge(i, j, rel.q.numpy(), rel.t.numpy(), info=info)
    posts = np.concatenate([rng.uniform(-4, 12, (n_landmarks, 2)) * [1, 1],
                            rng.uniform(0, 2, (n_landmarks, 1))], -1)
    for m in range(n_landmarks):
        g.add_landmark(posts[m] + rng.normal(0, 0.3, 3))
    for o in range(n_obs):
        m, k = o % n_landmarks, int(rng.integers(0, K))
        z = se3.apply(se3.inverse(se3.Pose(true.q[k], true.t[k])),
                      torch.as_tensor(posts[m], dtype=torch.float32))
        g.add_observation(k, m, z.numpy() + rng.normal(0, 0.05, 3),
                          info=(8.0,) * 3)
    return g


def test_solve_with_landmarks_on_card_matches_cpu(card):
    """The Schur-complement landmark solve on the card against the same
    solve on the CPU: poses and landmarks within 1e-4 (float32 Cholesky
    and accumulating scatters in another order)."""
    from veloslam_tpu_torch.graph import pcg
    g = _landmark_graph()
    out = {}
    for dev in (card, torch.device("cpu")):
        res, stats = pcg.solve_auto_landmarks(
            g.arrays(dev), max_poses=g.K, max_landmarks=g.M, iterations=6)
        assert float(stats.final_cost) < float(stats.initial_cost)
        out[dev.type] = {k: getattr(res, k).cpu().numpy()
                         for k in ("q", "t", "l_pos")}
    for k in ("q", "t", "l_pos"):
        assert np.isfinite(out["cuda"][k]).all()
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], atol=1e-4,
                                   err_msg=k)


def test_integrate_scans_batch_on_card_matches_cpu(card):
    """The tiled map built on the card (batched transform + voxelize)
    against the same build on the CPU: tiles, voxel coordinates and counts
    equal, moments within 1e-4 of the largest magnitude."""
    from torch_helpers import map_scans
    from veloslam_tpu_torch.config import MapConfig
    from veloslam_tpu_torch.map.voxelmap import VoxelMap
    pts, msk, q, t = map_scans()
    maps = [VoxelMap(MapConfig(), device=dev)
            for dev in (card, torch.device("cpu"))]
    for m in maps:
        m.integrate_scans_batch(pts, msk, q, t)
    a, b = (dict(m._patches) for m in maps)
    assert sorted(a) == sorted(b) and len(b) >= 4
    for k in b:
        np.testing.assert_array_equal(a[k].coords, b[k].coords)
        np.testing.assert_array_equal(a[k].count, b[k].count)
        for f in ("s1", "s2"):
            want = getattr(b[k], f)
            np.testing.assert_allclose(
                getattr(a[k], f), want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=f)
