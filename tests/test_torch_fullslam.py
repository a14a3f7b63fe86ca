"""Parity of the port's device full-SLAM path with the JAX package.

* The slice end to end: FullSlam.run_device + finalize_device on a short
  loop drive (2 s on a 4 m circle, INS drifting 1 m/s, 8192 points, 8192
  map rows, a 32-keyframe ring, 8 candidates) against the JAX package's
  run of the same drive, kept in tests/fixtures/fullslam_golden_seed3.npz
  (gen_torch_fullslam_golden.py).  Frame and keyframe counts, times,
  candidate pairs and accept flags exact; trajectories within 1 cm
  (measured ~2e-5 m: float32 sums in another order).
* Each finalize stage on that drive's keyframe ring, the JAX function and
  the port's on the same numpy inputs: candidates exact; verification
  poses within 1e-4 and accept flags exact; the graph solve and the
  corrected trajectory within 2e-3 m (float32 Cholesky with 1e6 weights,
  see test_torch_graph).
* Keyframe admission on hand-made slots that fill and overflow a ring.
* The closure budget (`sweep_budget`) against SlamPipeline._sweep_budget
  on the same recording lengths.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core.timeline import PoseTrack as JPoseTrack
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode.decode import DeviceCalib as JCalib
from veloslam_tpu.runtime import devfinalize as jdv
from veloslam_tpu.runtime import fullslam as jfs
from veloslam_tpu.runtime import odometry as jodo
from veloslam_tpu.runtime.pipeline import SlamPipeline
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime import devfinalize as dv
from veloslam_tpu_torch.runtime import fullslam as fs
from veloslam_tpu_torch.runtime import odometry as odo
from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
from veloslam_tpu_torch.runtime.pipeline import sweep_budget

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "fullslam_golden_seed3.npz")


def _drive(name):
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    return gold, cfg, drive


@pytest.fixture(scope="module")
def small():
    """The port's run of the small drive, finalize read back."""
    gold, cfg, drive = _drive("small")
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=cfg["model"],
        seed=drive["seed"], world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    eng = fs.FullSlam(DeviceCalib.from_host(cal.hdl32(), device="cpu"),
                      model=cfg["model"], **drive["engine"])
    eng.run_device(seq["packets"], seq["pkt_times_us"],
                   sim.truth_track(seq, drift_rate=drive["drift_rate"]),
                   batch=drive["batch"])
    out = eng.finalize_device(max_candidates=drive["max_candidates"],
                              **drive["finalize"])
    host = {k: n(v) for k, v in out.items() if isinstance(v, torch.Tensor)}
    return eng, host, seq, drive, gold


def test_small_drive_matches_jax(small):
    eng, host, seq, drive, gold = small

    def g(k):
        return gold[f"small_{k}"]

    nf = int(host["n_frames"])
    assert nf == int(g("n_frames")) and eng.ring.capacity == 32
    times = (host["traj_time"][:nf].astype(np.float64) * 1e6
             + eng._stream_t0_us).astype(np.int64)
    np.testing.assert_array_equal(times, g("times_us"))
    assert int(host["kf_n"]) == int(g("kf_n"))
    for k in ("cand_i", "cand_j", "cand_valid", "accept"):
        np.testing.assert_array_equal(host[k], g(k), err_msg=k)
    assert int(host["n_accepted"]) == int(g("accept").sum()) >= 2
    np.testing.assert_allclose(host["traj_t"][:nf], g("positions"), atol=0.01)
    np.testing.assert_allclose(n(eng.state.traj_t)[:nf],
                               g("odometry_positions"), atol=0.01)
    truth = interpolate_positions(times, seq["ins_t_us"], seq["ins_pos"])
    rmse = ate(host["traj_t"][:nf, :2], truth[:, :2], align=False)["rmse"]
    assert rmse <= float(g("ate")) + 0.005
    assert rmse < 0.1 * float(g("ate_raw_ins"))
    kf = eng.keyframes()
    assert kf["n"] == int(g("kf_n")) and not kf["ring_full"]
    assert kf["pts"].shape == (kf["n"], drive["engine"]["reg_points"], 3)


def _jring(eng):
    return jfs.KeyframeRing(*(jnp.asarray(x) for x in
                              convert.ring_to_numpy(eng.ring)))


def _jcand(c):
    return jdv.Candidates(*(jnp.asarray(n(x)) for x in c))


def test_propose_closures_matches_jax(small):
    eng, _, _, drive, _ = small
    f = drive["finalize"]
    kw = dict(min_score=f["min_score"], radius=f["radius"],
              min_gap=f["min_gap"], max_candidates=8)
    r, jr = eng.ring, _jring(eng)
    got = dv.propose_closures(r.desc[:-1], r.q[:-1], r.t[:-1], r.n, **kw)
    want = jdv.propose_closures(jr.desc, jr.q, jr.t, jr.n, **kw)
    for k in ("i", "j", "valid"):
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      n(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(n(got.prior_q), n(want.prior_q), atol=1e-5)
    np.testing.assert_allclose(n(got.prior_t), n(want.prior_t), atol=1e-5)


@pytest.mark.parametrize("use_sc", [True, False])
def test_propose_closures_breaks_ties_like_lax_top_k(use_sc):
    """Every keyframe at one spot with one descriptor: all pairs tie in
    both channels, so the order rests on lax.top_k's lower-index-first
    rule (a stable descending sort in the port); the per-keyframe caps
    and the pool overlap (every pair is in both pools) decide the rest."""
    K = 16
    rng = np.random.default_rng(3)
    desc = np.tile(rng.random((1, 16, 60)).astype(np.float32), (K, 1, 1))
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    tr = np.zeros((K, 3), np.float32)
    kw = dict(min_score=0.5, radius=15.0, min_gap=3, max_candidates=12,
              use_scan_context=use_sc)
    got = dv.propose_closures(t(desc), t(q), t(tr), t(np.int32(13)), **kw)
    want = jdv.propose_closures(jnp.asarray(desc), jnp.asarray(q),
                                jnp.asarray(tr), jnp.int32(13), **kw)
    for k in ("i", "j", "valid"):
        np.testing.assert_array_equal(n(getattr(got, k)),
                                      n(getattr(want, k)), err_msg=k)
    assert int(n(got.valid).sum()) >= 6


def test_verify_closures_device_matches_jax(small):
    eng, host, _, drive, _ = small
    r, jr = eng.ring, _jring(eng)
    K = r.capacity
    cand = dv.Candidates(t(host["cand_i"]), t(host["cand_j"]),
                         t(host["cand_valid"]),
                         *dv.propose_closures(
                             r.desc[:K], r.q[:K], r.t[:K], r.n,
                             min_score=0.55, radius=15.0, min_gap=8,
                             max_candidates=8)[3:])
    kw = dict(voxel_size=1.0, capacity=8192, reassociate_every=4)
    gq, gt, ga = dv.verify_closures_device(r.pts[:K], r.msk[:K], cand, **kw)
    wq, wt, wa = jdv.verify_closures_device(jr.pts, jr.msk, _jcand(cand),
                                            **kw)
    np.testing.assert_array_equal(n(ga), n(wa))
    np.testing.assert_allclose(n(gq), n(wq), atol=1e-4)
    np.testing.assert_allclose(n(gt), n(wt), atol=1e-4)
    assert n(ga).sum() >= 2


def test_solve_and_correct_matches_jax(small):
    eng, host, _, drive, _ = small
    f = drive["finalize"]
    r, jr = eng.ring, _jring(eng)
    K = r.capacity
    st = eng.state
    C = len(host["cand_i"])
    rng = np.random.default_rng(5)
    cand = dv.Candidates(t(host["cand_i"]), t(host["cand_j"]),
                         t(host["cand_valid"]),
                         t(np.tile([1.0, 0, 0, 0], (C, 1)).astype(np.float32)),
                         t(np.zeros((C, 3), np.float32)))
    meas_t = host["meas_t"] + rng.normal(0, 0.05, (C, 3)).astype(np.float32)
    args = dict(meas_q=host["meas_q"], meas_t=meas_t,
                accept=host["accept"],
                odom_info=np.asarray(f["odom_info"], np.float32),
                closure_info=np.asarray(f["closure_info"], np.float32))
    got = dv.solve_and_correct(
        r.q[:K], r.t[:K], r.time_rel_s[:K], r.n, cand,
        *(t(v) for v in args.values()), st.traj_q, st.traj_t,
        st.traj_time, st.n_frames, gn_iterations=f["gn_iterations"])
    want = jdv.solve_and_correct(
        jr.q, jr.t, jr.time_rel_s, jr.n, _jcand(cand),
        *(jnp.asarray(v) for v in args.values()),
        *(jnp.asarray(n(x)) for x in (st.traj_q, st.traj_t, st.traj_time,
                                      st.n_frames)),
        gn_iterations=f["gn_iterations"])
    nk, nf = int(r.n), int(st.n_frames)
    np.testing.assert_allclose(n(got[1])[:nk], n(want[1])[:nk], atol=2e-3)
    np.testing.assert_allclose(n(got[0])[:nk], n(want[0])[:nk], atol=1e-4)
    np.testing.assert_allclose(n(got[3])[:nf], n(want[3])[:nf], atol=2e-3)
    np.testing.assert_allclose(n(got[2])[:nf], n(want[2])[:nf], atol=1e-4)
    np.testing.assert_array_equal(n(got[3])[nf:], n(want[3])[nf:])
    assert int(got[4]) == int(want[4]) == int(host["accept"].sum())
    np.testing.assert_allclose(n(got[7]), n(want[7]), atol=1e-5)
    np.testing.assert_allclose(float(got[5].final_cost),
                               float(want[5].final_cost), rtol=1e-2,
                               atol=1e-2)
    # The closures moved the keyframes: a real correction, not identity.
    assert np.abs(n(got[1])[:nk] - n(r.t)[:nk]).max() > 0.01


def _slots(seed, F=7, P=96):
    """Hand-made frame slots: a path with small steps (no keyframe), long
    steps, a 15 degree turn, an undone slot."""
    rng = np.random.default_rng(seed)
    steps = np.array([[0, 0, 0], [0.5, 0, 0], [3, 0, 0], [3.2, 0.1, 0],
                      [3.3, 0.1, 0], [6.5, 0, 0], [9.9, 0.2, 0]])[:F]
    yaw = np.deg2rad([0, 1, 2, 2, 17, 17, 18])[:F]
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    pts = rng.uniform(-30, 30, (F, P, 3))
    pts[..., 2] = rng.uniform(-2.5, 3, (F, P))
    return dict(done=np.array([1, 1, 0, 1, 1, 1, 1], bool)[:F],
                est_q=q.astype(np.float32), est_t=steps.astype(np.float32),
                start_rel_s=(0.1 * np.arange(F)).astype(np.float32),
                pts_local=pts.astype(np.float32),
                msk=rng.random((F, P)) < 0.9,
                n_matched=np.full(F, 900, np.int32))


def test_admit_keyframes_matches_jax():
    """A 4-row ring fed twice: fills, then drops to the trash row; the
    last-keyframe pose keeps following admissions past the cap."""
    K, scan = 4, 64
    jring = jfs.KeyframeRing.init(K, scan)
    ring = fs.KeyframeRing.init(K, scan, device="cpu")
    kw = dict(scan_points=scan, kf_dist_m=2.0, kf_rot_rad=np.deg2rad(10.0))
    for k, b0 in enumerate((0.0, 1.5)):
        s = _slots(k)
        if k:
            s["est_t"] = s["est_t"] + 20.0
        jring = jfs._admit_keyframes(
            jring, jodo.SlotResults(**{f: jnp.asarray(v) for f, v in
                                       s.items()}), jnp.float32(b0), **kw)
        ring = fs._admit_keyframes(
            ring, odo.SlotResults(**{f: t(v) for f, v in s.items()}),
            t(np.float32(b0)), **kw)
        got = convert.ring_to_numpy(ring)
        for f in fs.KeyframeRing._fields:
            a, b = getattr(got, f), n(getattr(jring, f))
            if f == "desc":     # cell edges: see test_torch_scancontext
                assert (a != b).sum() <= 3
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ring.n) == K


@pytest.mark.parametrize("n_packets", [0, 3616, 12659, 180000])
def test_sweep_budget_matches_jax(n_packets):
    """The repaired frame estimate: the port's budget equals the JAX
    package's for the same recording (0 packets: both fall back to the
    ring capacity).  feed is stubbed: the budget depends only on the
    recording's length."""
    t0 = 1_700_000_000_000_000
    times = t0 + np.arange(n_packets, dtype=np.int64) * 553
    pkts = np.zeros((n_packets, 1206), np.uint8)
    track_j, track_t = JPoseTrack(), sim.PoseTrack()
    for tr in (track_j, track_t):
        for tu in (t0, t0 + 553 * max(n_packets, 1)):
            tr.add(tu, q=[1, 0, 0, 0], t=[0, 0, 0], v=[0, 0, 0])
    jeng = jfs.FullSlam(JCalib.from_host(jcal.hdl32()), kf_capacity=64,
                        kf_scan_points=16)
    peng = fs.FullSlam(DeviceCalib.from_host(cal.hdl32(), device="cpu"),
                       kf_capacity=64, kf_scan_points=16, reg_points=16)
    for eng, track in ((jeng, track_j), (peng, track_t)):
        eng.feed = lambda *a, **k: None
        eng.run_device(pkts, times, track, batch=4096)
    assert peng.ring.capacity == jeng.ring.capacity
    assert sweep_budget(peng, 8) == SlamPipeline._sweep_budget(jeng, 8)
    assert (peng._est_frames is None) == (n_packets == 0)


def test_ensure_kf_capacity_and_ring_round_trip():
    eng = fs.FullSlam(DeviceCalib.from_host(cal.hdl32(), device="cpu"),
                      kf_capacity=8, kf_scan_points=4, reg_points=4)
    eng.ring.pts[:8] = torch.arange(96, dtype=torch.float32).reshape(8, 4, 3)
    eng.ensure_kf_capacity(20)
    assert eng.ring.capacity == 32 and eng.ring.q.shape[0] == 33
    assert torch.equal(eng.ring.pts[:8].reshape(-1),
                       torch.arange(96, dtype=torch.float32))
    assert not eng.ring.pts[8:].any() and torch.all(eng.ring.q[8:, 0] == 1)
    eng.ensure_kf_capacity(10**6)
    assert eng.ring.capacity == fs.FullSlam.MAX_KF_CAPACITY
    ring = fs.KeyframeRing.init(5, 4, device="cpu")
    back = convert.ring_from_numpy(convert.ring_to_numpy(ring), "cpu")
    assert back.capacity == 5
    for a, b in zip(convert.ring_to_numpy(ring), convert.ring_to_numpy(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jring = jfs.KeyframeRing.init(5, 4)
    for a, b in zip(convert.ring_to_numpy(ring), jring):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    # A whole SlamState through numpy and back.
    st = fs.SlamState(odom=odo.init_state(device="cpu", map_capacity=16,
                                          max_frames=4), kf=ring)
    back = convert.slam_state_from_numpy(convert.slam_state_to_numpy(st),
                                         "cpu")
    assert back.kf.capacity == 5
    for a, b in zip(torch.utils._pytree.tree_leaves(
            convert.slam_state_to_numpy(st)), torch.utils._pytree.tree_leaves(
            convert.slam_state_to_numpy(back))):
        np.testing.assert_array_equal(a, b)


def test_golden_config_is_the_production_config():
    """chip_smoke.py and these tests take the drives' engine and finalize
    parameters from the golden file; they must still be what the
    generator derives from config.py and bench.py today."""
    from fixtures.gen_torch_fullslam_golden import golden_config
    assert json.loads(str(np.load(GOLDEN)["config"])) == golden_config()
