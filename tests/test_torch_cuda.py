"""The port on a CUDA card: the hand-written normal-equations, gather and
chain kernels against their plain versions (at the bulk step's slot
counts of the HDL-32, HDL-64 and VLP-16 among other shapes, and on the
HDL-64's and VLP-16's own bulk-step inputs), the wrappers' input checks,
the odometry slice (batched, fused and chained), frame assembly, the
dense nearest-mean lookup and the shared-target binary search, D2D and
NDT registration, the per-frame pipeline and the graph solves (dense and
PCG) on the card against the same on the CPU.
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

from torch_helpers import (normal_equation_slots, port_args, with_edge_slots,
                           with_nan_slots)
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


# (F, P, hit rate, NaN slots): the bulk step's slot counts, the per-frame
# path's (1, 8), ragged P, sparse and half hits, and with_nan_slots.
NE_CASES = [(96, 16384, 0.8, False), (50, 16384, 0.8, False),
            (222, 16384, 0.8, False), (1, 16384, 0.8, False),
            (8, 16384, 0.8, True), (96, 16384, 0.01, True),
            (96, 16384, 0.56, False), (3, 1000, 0.8, False),
            (1, 1, 0.8, False), (5, 0, 0.8, False)]


def _slots(F, P, rate, nan):
    slots = normal_equation_slots(F, P, seed=F + P, hit_rate=rate)
    return with_nan_slots(*slots) if nan else slots


def _nan_equal_close(x, r, lim):
    """NaN entries equal, the rest within `lim`."""
    nan = torch.isnan(r)
    assert torch.equal(torch.isnan(x), nan)
    assert ((x - r).abs()[~nan] <= lim).all()


def _ne_limit(r):
    """1e-4·max|ref| + 1e-3 over the entries that are not NaN."""
    finite = r[~torch.isnan(r)]
    return 1e-4 * (finite.abs().max().item() if finite.numel() else 0) + 1e-3


@pytest.mark.parametrize("F,P,rate,nan", NE_CASES)
def test_kernel_matches_plain_on_card(card, F, P, rate, nan):
    """Against the plain version evaluated in float64 on the same inputs:
    |Δ| ≤ 1e-4·max|ref| + 1e-3 on H and b, 1e-4 relative on the sums,
    NaN entries equal (with_nan_slots), n_hit exact, two launches bitwise
    equal; LAUNCHES counts each."""
    args = [a.to(card) for a in port_args(*_slots(F, P, rate, nan))]
    before = ne.LAUNCHES
    got = ne.fused_normal_equations(*args)
    again = ne.fused_normal_equations(*args)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 2
    ref = ne.normal_equations_plain(
        *(a.double() if a.is_floating_point() else a for a in args))
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for x, r in zip(got[:2], ref[:2]):
        _nan_equal_close(x.double(), r, _ne_limit(r))
    for x, r in zip(got[2:4], ref[2:4]):
        torch.testing.assert_close(x, r.float(), rtol=1e-4, atol=1e-6,
                                   equal_nan=True)
    assert torch.equal(got[4], ref[4])
    if nan:                              # H, b, err_sum of slots 3, 4
        assert all(torch.isnan(x[f]).any() for x in got[:3] for f in (3, 4))


@pytest.mark.parametrize("F,P,rate,nan",
                         NE_CASES[:-3] + [(128, 8192, 0.8, False),
                                          (3, 1000, 0.8, False),
                                          (3, 1001, 0.8, False),
                                          (1, 1, 0.8, False),
                                          (5, 0, 0.8, False)])
def test_gn_iteration_matches_plain_on_card(card, F, P, rate, nan):
    """The fused step against gn_iteration_plain evaluated in float64 on
    the same inputs (P = 1001 and 1 take the kernel's scalar-load
    instance), with the edge slots of with_edge_slots (rejected for few
    hits, clamped, NaN) and of with_nan_slots (rejected): decisions and
    n_hit exact; H, b at the NE tolerance with NaNs equal; the pose within
    1e-5 m / 1e-6 of the plain float64 step on the kernel's own H, b (the
    same 6×6 system); a rejected pose unchanged, but for a NaN q, which
    comes out all NaN; two calls bitwise equal, one launch counted
    each."""
    slots = normal_equation_slots(F, P, seed=F + P, hit_rate=rate)
    if F >= 3 and P:
        slots = with_edge_slots(*slots)
    if nan:
        slots = with_nan_slots(*slots)
    pts, q, t, mu, n, hit = [a.to(card) for a in port_args(*slots)]
    pose = se3.Pose(q, t)
    before = ne.LAUNCHES
    got = ne.gn_iteration(pts, pose, mu, n, hit)
    again = ne.gn_iteration(pts, pose, mu, n, hit)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 2
    pose64 = se3.Pose(q.double(), t.double())
    ref = ne.gn_iteration_plain(pts.double(), pose64, mu.double(),
                                n.double(), hit)
    own = ne._gn_step(pose64, got.H.double(), got.b.double(), got.n_hit,
                      1e-6)
    for a, b in zip((*got.pose, *got[1:]), (*again.pose, *again[1:])):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert torch.equal(got.step, ref.step)
    assert torch.equal(got.n_hit, ref.n_hit)
    if F >= 3 and P:
        want = [0, 2, 0] + ([0, 0] if nan else [])
        assert got.step[:len(want)].tolist() == want
    elif P == 0 or F < 3 and P < 11:
        assert got.step.tolist() == [0] * F
    for x, r in ((got.H, ref.H), (got.b, ref.b)):
        _nan_equal_close(x.double(), r, _ne_limit(r))
    kept = got.step == 0
    finite = torch.isfinite(q).all(dim=1)
    # A NaN in q spreads through exp(0) ∘ q; t stays.
    assert torch.equal(got.pose.q[kept & finite], q[kept & finite])
    assert torch.equal(got.pose.t[kept], t[kept])
    assert torch.isnan(got.pose.q[~finite]).all()
    _nan_equal_close(got.pose.t.double(), own.t, 1e-5)
    _nan_equal_close(got.pose.q.double(), own.q, 1e-6)


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
                                                        device=dev),
                                  batched=True, use_dense=True, **kw)
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
    ("gather_i32", 1 << 21, 50 * 16384), ("gather_i32", 1 << 21, 222 * 16384),
    ("gather_rows8", 65536, 50 * 16384), ("gather_rows8", 65536, 222 * 16384),
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


@pytest.mark.parametrize("model,slots", [("hdl64", 50), ("vlp16", 222)])
def test_bulk_step_at_a_sensor_familys_width_on_card(card, model, slots):
    """One warm odometry_step_batched at bench.py's width for the model
    (16384 of its packets, the production registration config): the
    batch has slots_for_batch frame slots, the GN step sees (slots,
    16384), one step launches 16 GN steps and 2 of each gather, and each
    kernel equals its plain version on that step's own inputs
    (chip_smoke.check_captured: the NE tolerances, gathers bitwise)."""
    import json

    import chip_smoke as cs
    assert odo.slots_for_batch(model, cs.MODELS_BULK_PACKETS) == slots
    reg = json.loads(str(np.load(cs.GOLDEN)["config"]))["odometry"]
    launches, errs = cs._models_bulk(card, "card test", model,
                                     cal.default_for(model), reg)
    assert launches["fused_normal_equations"] == reg["reg_iterations"]
    assert launches["gather_i32"] == launches["gather_rows8"] == 2
    assert all(v is not None for v in errs.values())


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
                   model=cfg["model"], use_dense=True, **drive["engine"])
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


def test_dense_solves_repeat_to_the_bit_on_card(card):
    """The dense pose-only and landmark-Schur solves twice on the card
    give the same bits: index_put_(accumulate=True) sorts its indices and
    adds each one's values in that order, and the landmark blocks sum on
    a plan (optimize._assemble_landmark_terms)."""
    from veloslam_tpu_torch.graph import pcg
    g = _landmark_graph()
    for solve, kw in ((pcg.solve_auto, {}),
                      (pcg.solve_auto_landmarks, {"max_landmarks": g.M})):
        runs = [solve(g.arrays(card), max_poses=g.K, iterations=6, **kw)[0]
                for _ in range(2)]
        for k in ("q", "t", "l_pos"):
            a, b = (getattr(r, k) for r in runs)
            assert torch.isfinite(a).all()
            assert torch.equal(_bits(a), _bits(b)), (solve.__name__, k)


def test_voxel_grids_repeat_to_the_bit_on_card(card):
    """build_grid (4 stacked scans of 16384 points, 10% invalid, more
    voxels than capacity) and merge_stats twice on the card give the same
    bits (their segment sums run in key order), and the build agrees with
    the CPU's: keys and counts exact, moments within float32 rounding."""
    from veloslam_tpu_torch.registration import voxel as vx
    rng = np.random.default_rng(12)
    pts = rng.normal(0, 6, (4, 16384, 3)).astype(np.float32)
    mask = rng.random((4, 16384)) < 0.9
    origin = rng.normal(0, 1, (4, 3)).astype(np.float32)
    vs = np.full(4, 0.5, np.float32)

    def build(dev):
        return vx.build_grid(*(torch.as_tensor(a, device=dev)
                               for a in (pts, mask, origin, vs)),
                             capacity=4096)
    a, b = build(card), build(card)
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))
    ref = build("cpu")
    np.testing.assert_array_equal(a.keys.cpu().numpy(), ref.keys.numpy())
    np.testing.assert_array_equal(a.count.cpu().numpy(), ref.count.numpy())
    for k in ("mean", "cov"):
        np.testing.assert_allclose(getattr(a, k).cpu().numpy(),
                                   getattr(ref, k).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    g0, g1 = (vx.VoxelGrid(*(x[f] for x in a)) for f in (0, 1))
    m1 = vx.merge_stats(g0, g1._replace(origin=g0.origin,
                                        voxel_size=g0.voxel_size),
                        capacity=4096)
    m2 = vx.merge_stats(g0, g1._replace(origin=g0.origin,
                                        voxel_size=g0.voxel_size),
                        capacity=4096)
    for x, y in zip(m1, m2):
        assert torch.equal(_bits(x), _bits(y))


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


def test_device_transform_equals_host_transform_on_card(card):
    """The map's one device step on the card: the 70 rotated scans over
    several tiles, then the first 10 downdated (a 64-scan chunk and a
    short one), transformed on the card in one integrate_scans_batch
    call, against each scan transformed on the host (se3.apply on the
    CPU) and integrated alone through integrate_points on the card: the
    same tiles, coords, counts and moment sums to the bit."""
    from torch_helpers import map_scans
    from veloslam_tpu_torch.config import MapConfig
    from veloslam_tpu_torch.map.voxelmap import VoxelMap
    pts, msk, q, t = map_scans()
    idx = np.concatenate([np.arange(len(pts)), np.arange(10)])
    signs = np.where(np.arange(len(idx)) < len(pts), 1.0, -1.0)
    batch = VoxelMap(MapConfig(), device=card)
    batch.integrate_scans_batch(pts[idx], msk[idx], q[idx], t[idx],
                                signs=signs)
    each = VoxelMap(MapConfig(), device=card)
    for i, sign in zip(idx, signs):
        world = se3.apply(se3.Pose(torch.as_tensor(q[i]),
                                   torch.as_tensor(t[i])),
                          torch.as_tensor(pts[i])).numpy()
        each.integrate_points(world, msk[i], t[i], sign=sign)
    a, b = (dict(m._patches) for m in (batch, each))
    assert sorted(a) == sorted(b) and len(b) >= 4
    for k in b:
        for f in ("coords", "count", "s1", "s2"):
            assert getattr(a[k], f).tobytes() == getattr(b[k], f).tobytes(), \
                (k, f)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("K", [1, 31, 32, 33, 63, 64, 65, 4096, 4097,
                               16384])
def test_chain_kernel_matches_plain_on_card(card, K):
    """chain_factor and chain_solve on the card against their plain
    versions on the solver's own blocks (chip_smoke.chain_inputs: a
    drifted chain, the 1e6 gauge, the 2% floor): |Δ| ≤ 1e-4·max|ref| +
    1e-6, at one step, both sides of the 32- and 64-step staging chunks,
    the long drive's 4096-row ring and the ring's cap; LAUNCHES counts
    one launch per call; a second call gives the same bits."""
    from chip_smoke import chain_inputs
    from veloslam_tpu_torch.graph import chain
    D, B, r = chain_inputs(K, card)
    before = dict(chain.LAUNCHES)
    U, L = chain.chain_factor(D, B)
    Up, Lp = chain.chain_factor_plain(D, B)
    z = chain.chain_solve(Up, Lp, B, r)
    zp = chain.chain_solve_plain(Up, Lp, B, r)
    torch.cuda.synchronize()
    assert chain.LAUNCHES == {"chain_factor": before["chain_factor"] + 1,
                              "chain_solve": before["chain_solve"] + 1}
    for name, x, ref in (("Uinv", U, Up), ("L", L, Lp), ("z", z, zp)):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(x.cpu().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6,
                                   err_msg=name)
    again = (*chain.chain_factor(D, B), chain.chain_solve(Up, Lp, B, r))
    for x, y in zip((U, L, z), again):
        assert torch.equal(_bits(x), _bits(y))


def _pivot_swaps(a: np.ndarray) -> list:
    """The pivot rows Gauss-Jordan with partial pivoting picks for `a`
    (6, 6), the rule of csrc/chain.cu: a strict > scan down from the
    diagonal.  Returns, per column, whether a row swap was taken."""
    m = np.concatenate([a.astype(np.float64), np.eye(6)], axis=1)
    swaps = []
    for c in range(6):
        p = c
        for r in range(c + 1, 6):
            if abs(m[r, c]) > abs(m[p, c]):
                p = r
        swaps.append(p != c)
        m[[c, p]] = m[[p, c]]
        m[c] /= m[c, c]
        for r in range(6):
            if r != c:
                m[r] -= m[r, c] * m[c]
    return swaps


def test_chain_factor_swaps_rows_at_every_pivot_on_card(card):
    """Blocks built so that Gauss-Jordan swaps rows at every pivot column
    but the last (a cyclic shift, each row's large entry one column to
    its right, plus 1% noise; B = 0 so U_k = D_k): the kernel's inverses
    against the plain version (torch.linalg.inv_ex) at the chain's
    tolerance, and two calls equal to the bit."""
    from veloslam_tpu_torch.graph import chain
    K = 70
    rng = np.random.default_rng(4)
    shift = np.roll(np.eye(6), 1, axis=1)
    D = (shift[None] * rng.uniform(1.0, 3.0, (K, 6, 1))
         + 0.01 * rng.normal(size=(K, 6, 6))).astype(np.float32)
    for k in range(K):
        assert _pivot_swaps(D[k]) == [True] * 5 + [False]
    Dt = torch.as_tensor(D, device=card)
    B = torch.zeros_like(Dt)
    U, L = chain.chain_factor(Dt, B)
    U2, L2 = chain.chain_factor(Dt, B)
    Up, Lp = chain.chain_factor_plain(Dt, B)
    torch.cuda.synchronize()
    assert torch.equal(L, torch.zeros_like(L))
    ref = Up.cpu().numpy()
    np.testing.assert_allclose(U.cpu().numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max() + 1e-6)
    assert torch.equal(_bits(U), _bits(U2)) and torch.equal(L, L2)


def test_chain_factor_singular_block_gives_nan_on_card(card):
    """A singular block gives a non-finite inverse (its pivot is 0 and
    1 / 0 is inf), as jnp.linalg.inv does, and the blocks before it stay
    finite."""
    from veloslam_tpu_torch.graph import chain
    D = torch.eye(6, device=card).repeat(5, 1, 1) * 2.0
    D[3, 2] = D[3, 1]                     # rows 1 and 2 of block 3 equal
    U, _ = chain.chain_factor(D, torch.zeros_like(D))
    torch.cuda.synchronize()
    assert torch.isfinite(U[:3]).all()
    assert not torch.isfinite(U[3]).all()


def test_chain_wrappers_check_inputs_on_card(card):
    from veloslam_tpu_torch.graph import chain
    D = torch.eye(6, device=card).repeat(8, 1, 1)
    r = torch.ones(49, device=card)[1:].reshape(8, 6)   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        chain.chain_solve(D, D, D, r)
    with pytest.raises(ValueError, match="tensors on"):
        chain.chain_factor(D, D.cpu())
    with pytest.raises(TypeError):
        chain.chain_factor(D.half(), D.half())


def test_solve_pcg_on_card_matches_cpu(card):
    """solve_pcg (chain preconditioner) on a 600-pose drifted chain with
    closures in 1024 pose rows, on the card against the same solve on the
    CPU: positions within 1e-3 m (products and the chain's sums in
    another order), two GN iterations of 32 CG steps; the chain kernel
    launched once per factor and once per preconditioner application; a
    second solve on the card equal to the bit (fixed-order segment sums)."""
    from chip_smoke import PCG_GRAPHS, pcg_graph
    from veloslam_tpu_torch.graph import chain, pcg
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    p = dict(PCG_GRAPHS["chain"], n=600, K=1024, E=2048, lap=100)
    f, _ = pcg_graph(p)
    out = {}
    for dev in (card, torch.device("cpu")):
        before = dict(chain.LAUNCHES)
        g = GraphArrays(**{k: torch.as_tensor(v, device=dev)
                           for k, v in f.items()})
        res, stats = pcg.solve_pcg(g, max_poses=1024, iterations=2,
                                   cg_iters=32)
        assert float(stats.final_cost) < float(stats.initial_cost)
        out[dev.type] = res.t[:600].cpu().numpy()
        launched = {k: chain.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"chain_factor": 2, "chain_solve": 66}
                            if dev.type == "cuda"
                            else {"chain_factor": 0, "chain_solve": 0})
    assert np.isfinite(out["cuda"]).all()
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-3)
    g = GraphArrays(**{k: torch.as_tensor(v, device=card)
                       for k, v in f.items()})
    again, _ = pcg.solve_pcg(g, max_poses=1024, iterations=2, cg_iters=32)
    assert np.array_equal(again.t[:600].cpu().numpy(), out["cuda"])


def test_assemble_frames_on_card_equals_cpu(card):
    """Frame assembly over three batches with the carry, the same decoded
    and compensated batches (made on the CPU) assembled on each device:
    the card's frames, counts, starts and carry equal the CPU's to the
    bit (the scatter writes each cell once, its last write)."""
    from veloslam_tpu_torch.decode import frames as fr
    from veloslam_tpu_torch.decode.decode import compensate, decode_packets
    seq = sim.generate_sequence(duration_s=0.3, model="hdl32", seed=5,
                                world=sim.World.demo(6))
    track = sim.truth_track(seq, drift_rate=0.3)
    calib = DeviceCalib.from_host(cal.hdl32(), device="cpu")
    batches, open_abs = [], None
    carry = fr.AssemblyCarry.init(32, device="cpu")
    for b in range(3):
        pk = seq["packets"][b * 160:(b + 1) * 160]
        times = seq["pkt_times_us"][b * 160:(b + 1) * 160]
        anchor = int(times[0])
        w = track.window(anchor, int(times[-1]), anchor_us=anchor)
        rel = torch.as_tensor(((times - anchor) * 1e-6).astype(np.float32))
        d = decode_packets(torch.as_tensor(pk), calib, model="hdl32")
        xyz, _ = compensate(d, rel, *(torch.as_tensor(w[k])
                                      for k in ("rel_s", "q", "t", "v")))
        cs = torch.full((), 0.0 if open_abs is None
                        else (open_abs - anchor) * 1e-6)
        batches.append((d, xyz, rel, cs))
        *_, carry, open_start = fr.assemble_frames(
            d, xyz, rel, carry, cs, model="hdl32", n_beams=32)
        open_abs = anchor + float(open_start) * 1e6
    outs = {}
    for dev in ("cpu", card):
        carry = fr.AssemblyCarry.init(32, device=dev)
        got = []
        for d, xyz, rel, cs in batches:
            d = type(d)(*(x.to(dev) for x in d))
            fb, n_done, starts, carry, open_start = fr.assemble_frames(
                d, xyz.to(dev), rel.to(dev), carry, cs.to(dev),
                model="hdl32", n_beams=32)
            got.append([x.cpu() for x in (*fb, n_done, starts, *carry,
                                          open_start)])
        outs[str(dev)] = got
    assert sum(int(b[6]) for b in outs["cpu"]) >= 2      # n_done
    for a, b in zip(outs["cpu"], outs[str(card)]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_lookup_nearest_dense_on_card_equals_cpu(card):
    """The dense nearest-mean lookup on the card (its 7·P table reads one
    gather_i32 launch) chooses the CPU's rows, exactly."""
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import voxel as vx
    rng = np.random.default_rng(3)
    centers = rng.uniform(-30, 30, (200, 3))
    pts = (centers[rng.integers(0, 200, 30000)]
           + rng.normal(0, 0.4, (30000, 3))).astype(np.float32)
    q = (pts[:16384] + rng.normal(0, 0.3, (16384, 3))).astype(np.float32)
    m = rng.random(16384) < 0.95
    rows = {}
    for dev in ("cpu", card):
        g = vx.build_grid(torch.as_tensor(pts, device=dev),
                          torch.ones(30000, dtype=torch.bool, device=dev),
                          torch.zeros(3, device=dev),
                          torch.tensor(1.0, device=dev), capacity=16384)
        usable = gicp.plane_grid_from(g).usable
        dense = vx.build_dense_index(g)
        before = ga.LAUNCHES["gather_i32"]
        rows[str(dev)] = [vx.lookup_nearest_dense(
            g, dense, torch.as_tensor(q, device=dev),
            torch.as_tensor(m, device=dev), usable,
            approx_centers=a).cpu() for a in (False, True)]
        assert ga.LAUNCHES["gather_i32"] - before == (2 if dev == card
                                                      else 0)
    for a, b in zip(rows["cpu"], rows[str(card)]):
        assert torch.equal(a, b)
    assert (rows["cpu"][0] >= 0).sum() > 3000


def test_small_per_frame_pipeline_on_card_matches_jax_golden(card):
    """slam_run's default mode on the card: the small drive of
    perframe_golden_seed3.npz through SlamPipeline(device=card).
    run_offline + finalize, with chip_smoke's gates against the JAX
    golden; the three registration kernels launched, the chain kernel
    not."""
    import json
    import os
    import tempfile

    import chip_smoke as cs
    gold = np.load(cs.PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["small"]
    with tempfile.TemporaryDirectory() as tmp:
        paths, seq = cs.write_pipeline_drive(drive, cfg["model"], tmp)
        cs._reset_launches()
        pipe, res, mid, _ = cs.run_perframe(paths, drive, card)
        launches = cs._launches()
        cs.check_perframe(pipe, res, mid, seq, gold, "small")
        assert os.path.isdir(tmp)
    assert all(launches[k] > 0 for k in cs.REG_KERNELS), launches
    assert launches["chain_factor"] == launches["chain_solve"] == 0


def test_shared_target_binary_search_on_card_equals_cpu(card):
    """gicp.associate against one shared target with no index (the fused
    and `--fast` odometry): all F·P points in one binary-search lookup
    (one gather_i32 launch) and one row gather, on the card the CPU's
    planes and hits exactly, from the same target (built on the card,
    copied to the CPU), at a frame slot pair of 16384 points against a
    32768-row map."""
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import voxel as vx
    rng = np.random.default_rng(4)
    centers = rng.uniform(-40, 40, (400, 3))
    pts = (centers[rng.integers(0, 400, 60000)]
           + rng.normal(0, 0.5, (60000, 3))).astype(np.float32)
    q = (pts[:2 * 16384] + rng.normal(0, 0.3, (2 * 16384, 3))
         ).astype(np.float32).reshape(2, 16384, 3)
    m = rng.random((2, 16384)) < 0.95
    g = vx.build_grid(torch.as_tensor(pts, device=card),
                      torch.ones(60000, dtype=torch.bool, device=card),
                      torch.zeros(3, device=card),
                      torch.tensor(1.0, device=card), capacity=32768)
    on_card = gicp.plane_grid_from(g)
    out = {}
    for dev in ("cpu", card):
        target = gicp.PlaneGrid(
            grid=vx.VoxelGrid(*(x.to(dev) for x in on_card.grid)),
            normal=on_card.normal.to(dev), usable=on_card.usable.to(dev),
            rows=on_card.rows.to(dev))
        pose = se3.Pose.identity((2,), device=dev)
        before = dict(ga.LAUNCHES)
        out[str(dev)] = [x.cpu() for x in gicp.associate(
            torch.as_tensor(q, device=dev), torch.as_tensor(m, device=dev),
            pose, target, None)]
        got = {k: ga.LAUNCHES[k] - before[k] for k in before}
        assert got == ({"gather_i32": 1, "gather_rows8": 1} if dev == card
                       else {"gather_i32": 0, "gather_rows8": 0})
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b)
    assert out["cpu"][2].sum() > 10000


@pytest.mark.parametrize("method", ["d2d", "ndt"])
def test_d2d_and_ndt_on_card_match_cpu(card, method):
    """D2D (8192-voxel scan grid) and NDT (16384 points) against a
    16384-voxel target on the card: each GN iteration's search one
    gather_i32 launch; the pose within 1e-4 m / 1e-5 of the CPU's, the
    match count equal."""
    from veloslam_tpu_torch.registration import d2d, ndt
    from veloslam_tpu_torch.registration import voxel as vx
    rng = np.random.default_rng(5)
    planes = rng.normal(size=(300, 3))
    planes /= np.linalg.norm(planes, axis=1, keepdims=True)
    c = rng.uniform(-40, 40, (300, 3))
    u = rng.uniform(-3, 3, (300, 80, 2))
    e1 = np.cross(planes, [0, 0, 1.0]) + 1e-3
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(planes, e1)
    surf = (c[:, None] + u[..., :1] * e1[:, None]
            + u[..., 1:] * e2[:, None]).reshape(-1, 3)
    tgt = (surf + rng.normal(0, 0.01, surf.shape)).astype(np.float32)
    src = (surf[rng.permutation(len(surf))[:16384]]
           + rng.normal(0, 0.01, (16384, 3))).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        def T(a):
            return torch.as_tensor(a, device=dev)
        one = torch.tensor(1.0, device=dev)
        origin = torch.zeros(3, device=dev)
        roi = vx.build_grid(T(tgt), torch.ones(len(tgt), dtype=torch.bool,
                                               device=dev), origin, one,
                            capacity=16384)
        m = torch.ones(16384, dtype=torch.bool, device=dev)
        prior = se3.Pose(T(np.array([0.9998, 0.0, 0.0, 0.02], np.float32)
                           / np.float32(1.0002)),
                         T(np.array([0.2, -0.1, 0.05], np.float32)))
        before = ga.LAUNCHES["gather_i32"]
        if method == "d2d":
            scan = vx.build_grid(T(src), m, origin, one, capacity=8192)
            r = d2d.register_d2d(scan, roi, d2d.usable_mask(roi), prior)
        else:
            r = ndt.register(T(src), m, ndt.build_ndt_grid(roi), prior)
        assert ga.LAUNCHES["gather_i32"] - before == (16 if dev == card
                                                      else 0)
        res[str(dev)] = [x.cpu() for x in (r.pose.q, r.pose.t,
                                           r.n_matched)]
    a, b = res["cpu"], res[str(card)]
    assert int(a[2]) == int(b[2]) > 500
    torch.testing.assert_close(b[0], a[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(b[1], a[1], rtol=0, atol=1e-4)


def test_fused_and_chained_odometry_on_card_match_cpu(card):
    """StreamingOdometry with the JAX defaults (fused, exact search) on
    the card against the same on the CPU, 8 GN iterations a frame (one
    NE launch and one search each); the chained path equal to the fused
    one to the bit on the card."""
    world = sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24)
    seq = sim.generate_sequence(duration_s=0.8, model="hdl32", seed=23,
                                world=world)
    track = sim.truth_track(seq, drift_rate=0.3)
    kw = dict(reg_points=4096, map_capacity=16384)
    out = {}
    for dev, fused in (("cpu", True), (card, True), (card, False)):
        o = odo.StreamingOdometry(DeviceCalib.from_host(cal.hdl32(),
                                                        device=dev),
                                  fused=fused, **kw)
        before = (ne.LAUNCHES, ga.LAUNCHES["gather_i32"])
        r = o.run(seq["packets"], seq["pkt_times_us"], track, batch=512)
        got = (ne.LAUNCHES - before[0],
               ga.LAUNCHES["gather_i32"] - before[1])
        want = 8 * r["n_frames"] if dev == card else 0
        assert got == (want, want)
        out[(str(dev), fused)] = r
    a, b = out[("cpu", True)], out[(str(card), True)]
    assert a["n_frames"] == b["n_frames"] >= 5
    np.testing.assert_array_equal(a["times_us"], b["times_us"])
    assert np.abs(a["positions"] - b["positions"]).max() < 0.01
    c = out[(str(card), False)]
    for k in ("times_us", "positions", "quaternions"):
        np.testing.assert_array_equal(b[k], c[k])
