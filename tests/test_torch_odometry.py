"""Parity of the port's bulk-odometry slice with the JAX package.

* One `odometry_step_batched` from a SHARED mid-drive state: the JAX
  state after three batches, carried into the port with `convert`.
* The whole slice through both packages' StreamingOdometry(batched=True).
* The port on the CPU against the committed JAX golden trajectory that
  chip_smoke.py holds the card to.

The drives use a dense world and a drifting INS (0.3 m/s), so the
registration output is accepted and corrects the prior (with the sparse
demo world at 0.5 m voxels the lateral-observability gate stays shut for
the whole 1.2 s and every pose is the INS prior).  Tolerance: positions
within 1 cm (measured ~1e-6 m; float32 sums in another order), times and
frame counts exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.core.timeline import PoseTrack as JPoseTrack
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode.decode import DeviceCalib as JCalib
from veloslam_tpu.runtime.odometry import StreamingOdometry as JOdometry
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime import odometry as odo
from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "odometry_golden_seed23.npz")
DRIFT = 0.3
KW = dict(voxel_size=0.5, reg_points=2048, reg_iterations=16,
          map_capacity=16384, reassociate_every=8)
BATCH = 256


@pytest.fixture(scope="module")
def drive():
    world = sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24)
    return sim.generate_sequence(duration_s=1.2, model="hdl32", seed=23,
                                 world=world)


def _jtrack(seq):
    track = JPoseTrack()
    t0 = seq["ins_t_us"][0]
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        q = jse3.euler_deg_to_quat_np(0.0, 0.0, np.rad2deg(yaw))
        dp = np.array([0.0, DRIFT * (t_us - t0) * 1e-6, 0.0])
        track.add(int(t_us), q=q, t=np.asarray(p) + dp, v=v)
    return track


def _jodometry():
    return JOdometry(JCalib.from_host(jcal.hdl32()), batched=True,
                     use_dense=True, **KW)


def _port():
    return odo.StreamingOdometry(
        DeviceCalib.from_host(cal.hdl32(), device="cpu"), batched=True,
        use_dense=True, **KW)


def _batch(seq, track, i):
    s = slice(i * BATCH, (i + 1) * BATCH)
    pkts, times = seq["packets"][s], seq["pkt_times_us"][s]
    w = track.window(int(times[0]), int(times[-1]), anchor_us=int(times[0]))
    return pkts, times, w


def test_step_from_shared_mid_drive_state(drive):
    jtrack = _jtrack(drive)
    jo = _jodometry()
    jo.MAX_FRAMES_BATCH = odo.slots_for_batch("hdl32", BATCH)
    for i in range(3):
        pkts, times, w = _batch(drive, jtrack, i)
        jo.feed(jnp.asarray(pkts), times, w)
    assert int(jo.state.n_frames) >= 3 and bool(jo.state.have_map)

    leaves = type(jo.state)(*(
        type(x)(*(np.asarray(y) for y in x)) if isinstance(x, tuple)
        else np.asarray(x) for x in jo.state))
    po = _port()
    po.MAX_FRAMES_BATCH = jo.MAX_FRAMES_BATCH
    po.state = convert.odometry_state_from_numpy(leaves, "cpu")
    po._stream_t0_us = jo._stream_t0_us
    po._open_anchor = jo._open_anchor
    po._open_start_dev = t(np.asarray(jo._open_start_dev))

    pkts, times, w = _batch(drive, jtrack, 3)
    jo.feed(jnp.asarray(pkts), times, w)
    po.feed(pkts, times, w)
    js, ps = jo.state, convert.odometry_state_to_numpy(po.state)
    nf = int(js.n_frames)
    assert int(ps.n_frames) == nf and nf > 3
    np.testing.assert_array_equal(ps.traj_time, n(js.traj_time))
    np.testing.assert_allclose(ps.traj_t[:nf], n(js.traj_t)[:nf], atol=1e-4)
    np.testing.assert_allclose(ps.traj_q[:nf], n(js.traj_q)[:nf], atol=1e-5)
    np.testing.assert_allclose(ps.corr_t, n(js.corr_t), atol=1e-4)
    np.testing.assert_allclose(ps.corr_q, n(js.corr_q), atol=1e-5)
    np.testing.assert_array_equal(ps.map_grid.keys, n(js.map_grid.keys))
    np.testing.assert_allclose(ps.map_grid.count, n(js.map_grid.count),
                               rtol=1e-5)
    # The carried open-frame points are each package's own compensated
    # decode output (ulps apart, as in test_torch_decode); the rest exact.
    np.testing.assert_allclose(ps.carry.xyz, n(js.carry.xyz), atol=1e-4)
    for f in ("valid", "laser", "n_blocks", "last_azimuth"):
        np.testing.assert_array_equal(getattr(ps.carry, f),
                                      n(getattr(js.carry, f)), err_msg=f)


def test_streaming_slice_matches_jax(drive):
    jres = _jodometry().run(drive["packets"], drive["pkt_times_us"],
                            _jtrack(drive), batch=BATCH)
    po = _port()
    pres = po.run(drive["packets"], drive["pkt_times_us"],
                  sim.truth_track(drive, drift_rate=DRIFT), batch=BATCH)
    assert pres["n_frames"] == jres["n_frames"] >= 8
    np.testing.assert_array_equal(pres["times_us"], jres["times_us"])
    d = np.linalg.norm(pres["positions"] - jres["positions"], axis=1)
    assert d.max() < 0.01, d
    ref = interpolate_positions(pres["times_us"], drive["ins_t_us"],
                                drive["ins_pos"])
    # Registration corrects the drift: far below the raw INS error.
    t_rel = (pres["times_us"] - drive["ins_t_us"][0]) * 1e-6
    ins_err = np.sqrt(np.mean((DRIFT * t_rel) ** 2))
    assert ate(pres["positions"], ref, align=False)["rmse"] < 0.7 * ins_err
    assert po.batches_fed == -(-len(drive["packets"]) // BATCH)


@pytest.mark.parametrize("name", ["demo6", "dense8_drift"])
def test_port_on_cpu_matches_golden_trajectory(name):
    """The card's golden check, run here: production registration config,
    16384 points, 65536 map rows, batch 256."""
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    seq = sim.generate_sequence(duration_s=cfg["duration_s"],
                                model=cfg["model"], seed=cfg["seed"],
                                world=sim.World.demo(**drive["world"]))
    po = odo.StreamingOdometry(
        DeviceCalib.from_host(cal.default_for(cfg["model"]), device="cpu"),
        model=cfg["model"], batched=True, use_dense=True, **cfg["odometry"])
    res = po.run(seq["packets"], seq["pkt_times_us"],
                 sim.truth_track(seq, drift_rate=drive["drift_rate"]),
                 batch=cfg["batch"])
    assert res["n_frames"] == int(gold[f"{name}_n_frames"])
    np.testing.assert_array_equal(res["times_us"], gold[f"{name}_times_us"])
    d = np.linalg.norm(res["positions"] - gold[f"{name}_positions"], axis=1)
    assert d.max() < 0.05, d


def test_convert_round_trip():
    st = odo.init_state(device="cpu", map_capacity=64, max_frames=8,
                        sample_assembly=True)
    back = convert.odometry_state_to_numpy(
        convert.odometry_state_from_numpy(
            convert.odometry_state_to_numpy(st), "cpu"))
    for a, b in zip(convert.odometry_state_to_numpy(st), back):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ([a], [b]))):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    calib = JCalib.from_host(jcal.hdl64())
    ported = convert.calib_from_numpy(
        type(calib)(*(np.asarray(x) for x in calib)), "cpu")
    direct = DeviceCalib.from_host(cal.hdl64(), device="cpu")
    for x, y in zip(ported, direct):
        np.testing.assert_array_equal(n(x), n(y))


def test_pad_window_matches_jax():
    L = odo.StreamingOdometry.WINDOW_LEN
    for m in (450, 10):
        w = {"rel_s": np.linspace(0.0, 4.5, m).astype(np.float32),
             "q": np.tile(np.array([1, 0, 0, 0], np.float32), (m, 1)),
             "t": np.linspace([0, 0, 0], [22.5, 0, 0], m).astype(np.float32),
             "v": np.tile(np.array([5, 0, 0], np.float32), (m, 1))}
        a = _port()._pad_window(w)
        b = _jodometry()._pad_window(w)
        for k in w:
            assert len(a[k]) == L
            np.testing.assert_array_equal(a[k], b[k])


def test_empty_recording_returns_empty_trajectory():
    res = _port().run(np.zeros((0, 1206), np.uint8), np.zeros(0, np.int64),
                      None)
    assert res["n_frames"] == 0 and res["positions"].shape == (0, 3)
