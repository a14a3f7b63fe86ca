"""The port's jax-free host copies stay equal to the JAX package's
originals, and the port imports no jax.

The port carries its own numpy copies of the simulator and its pcap / INS
writers, the packet encoders and position-packet parsers, the pcap
readers, calibration tables and the XML loader, PoseTrack, geodesy, the
hour-stamp resolution, the numpy pose helpers, the trajectory metrics
and the SlamConfig tree, because the originals' package __init__s import
jax, which the card's machine does not have.  These tests hold the copies
byte- and value-equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu import constants as jconst
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.core.timeline import PoseTrack as JPoseTrack
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.io import packets as jpk
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu.runtime import evaluate as jev
from veloslam_tpu_torch import config as cfgmod
from veloslam_tpu_torch import constants as const
from veloslam_tpu_torch.core import geodesy, se3, timesync
from veloslam_tpu_torch.core.timeline import PoseTrack
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.io import packets as pk
from veloslam_tpu_torch.io import pcap
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime import evaluate as ev
from veloslam_tpu_torch.utils.profiling import StageTimers


GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "odometry_golden_seed23.npz")


@pytest.fixture(scope="module")
def seqs():
    kw = dict(duration_s=0.3, model="hdl32", seed=23)
    return (sim.generate_sequence(world=sim.World.demo(6), **kw),
            jsim.generate_sequence(world=jsim.World.demo(6), **kw))


def test_generate_sequence_is_byte_identical(seqs):
    ours, ref = seqs
    assert set(ours) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        else:
            assert ours[k] == ref[k], k


@pytest.mark.parametrize("model", ["hdl32", "vlp16", "hdl64"])
def test_other_models_and_noise_are_byte_identical(model):
    kw = dict(duration_s=0.05, model=model, seed=4, noise_std=0.02,
              trajectory=None)
    ours = sim.generate_sequence(
        world=sim.World.demo(2, n_posts=5, n_walls=2), **kw)
    ref = jsim.generate_sequence(
        world=jsim.World.demo(2, n_posts=5, n_walls=2), **kw)
    np.testing.assert_array_equal(ours["packets"], ref["packets"])
    np.testing.assert_array_equal(ours["pkt_times_us"], ref["pkt_times_us"])


@pytest.mark.parametrize("name", ["circle_trajectory", "figure8_trajectory",
                                  "straight_trajectory"])
def test_trajectories_are_byte_identical(name):
    world = dict(seed=2, n_posts=5, n_walls=2)
    ours = sim.generate_sequence(duration_s=0.05, seed=5,
                                 world=sim.World.demo(**world),
                                 trajectory=getattr(sim, name)())
    ref = jsim.generate_sequence(duration_s=0.05, seed=5,
                                 world=jsim.World.demo(**world),
                                 trajectory=getattr(jsim, name)())
    for k in ("packets", "ins_pos", "ins_yaw", "ins_vel"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["hdl32", "vlp16", "hdl64"])
def test_calibration_tables_equal(name):
    ours, ref = getattr(cal, name)(), getattr(jcal, name)()
    assert ours._fields == ref._fields
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.sin_vert, ref.sin_vert)
    np.testing.assert_array_equal(ours.cos_vert, ref.cos_vert)
    np.testing.assert_array_equal(ours.beam_order(), ref.beam_order())
    np.testing.assert_array_equal(cal.default_for(name).vert_correction_deg,
                                  jcal.default_for(name).vert_correction_deg)


def test_constants_equal():
    names = [k for k in vars(const) if k.isupper()]
    assert len(names) == 20
    for k in names:
        assert getattr(const, k) == getattr(jconst, k), k


def test_golden_config_is_the_production_config():
    """chip_smoke.py takes the production registration config from the
    golden file; it must still be what the generator derives from
    RegistrationConfig today."""
    from fixtures.gen_torch_odometry_golden import golden_config
    assert json.loads(str(np.load(GOLDEN)["config"])) == golden_config()


def test_idle_packets_equal(seqs):
    ours, _ = seqs
    np.testing.assert_array_equal(
        pk.idle_lidar_packets(ours["packets"][-1], 7),
        jpk.idle_lidar_packets(ours["packets"][-1], 7))


def test_pose_track_window_equal(seqs):
    seq, _ = seqs
    ours = sim.truth_track(seq, drift_rate=0.2)
    ref = JPoseTrack()
    t0 = seq["ins_t_us"][0]
    for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                               seq["ins_yaw"], seq["ins_vel"]):
        q = jse3.euler_deg_to_quat_np(0.0, 0.0, np.rad2deg(yaw))
        dp = np.array([0.0, 0.2 * (t_us - t0) * 1e-6, 0.0])
        ref.add(int(t_us), q=q, t=np.asarray(p) + dp, v=v)
    assert len(ours) == len(ref)
    mid = int(seq["pkt_times_us"][len(seq["pkt_times_us"]) // 2])
    for t0_us, t1_us in ((int(seq["pkt_times_us"][0]), mid),
                         (mid, int(seq["pkt_times_us"][-1]) + 50_000)):
        a = ours.window(t0_us, t1_us, anchor_us=t0_us)
        b = ref.window(t0_us, t1_us, anchor_us=t0_us)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pose_track_out_of_order_and_empty():
    ours, ref = PoseTrack(), JPoseTrack()
    for tr in (ours, ref):
        for t_us, x in ((30, 3.0), (10, 1.0), (20, 2.0), (20, 2.5)):
            tr.add(t_us, q=[1, 0, 0, 0], t=[x, 0, 0])
    a, b = ours.window(0, 40, anchor_us=0), ref.window(0, 40, anchor_us=0)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        PoseTrack().window(0, 1, anchor_us=0)


def test_ate_and_interpolate_positions_equal(seqs):
    seq, _ = seqs
    rng = np.random.default_rng(0)
    tq = np.sort(rng.integers(seq["ins_t_us"][0], seq["ins_t_us"][-1], 40))
    ref_pos = ev.interpolate_positions(tq, seq["ins_t_us"], seq["ins_pos"])
    np.testing.assert_array_equal(
        ref_pos, jev.interpolate_positions(tq, seq["ins_t_us"],
                                           seq["ins_pos"]))
    est = ref_pos + rng.normal(0, 0.05, ref_pos.shape)
    for align in (True, False):
        assert ev.ate(est, ref_pos, align=align) == jev.ate(est, ref_pos,
                                                            align=align)


def test_port_imports_no_jax():
    """Importing every module of the port loads nothing of jax and nothing
    of the JAX package."""
    code = (
        "import sys, pkgutil, importlib, veloslam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "top = ('jax', 'jaxlib', 'veloslam_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in top)\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_never_import_jax():
    import pathlib

    import veloslam_tpu_torch
    root = pathlib.Path(veloslam_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "jaxlib")), (
                f"{path}: {line}")


def test_write_sequence_is_byte_identical(seqs, tmp_path):
    """The pcap (LiDAR + position packets, canned headers) is byte-equal
    to the JAX package's; the INS log is the same text."""
    seq, _ = seqs
    ours = sim.write_sequence(seq, str(tmp_path / "ours"), name="d")
    ref = jsim.write_sequence(seq, str(tmp_path / "ref"), name="d")
    for k in ("pcap", "ins"):
        with open(ours[k], "rb") as a, open(ref[k], "rb") as b:
            assert a.read() == b.read(), k


def test_pcap_readers_equal(seqs, tmp_path):
    from veloslam_tpu.io import pcap as jpcap
    seq, _ = seqs
    path = sim.write_sequence(seq, str(tmp_path), name="d")["pcap"]
    for mp in (None, 100):
        for a, b in zip(pcap.read_lidar_packets(path, mp),
                        jpcap.read_lidar_packets(path, mp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pos = pcap.read_position_packets(path)
    for a, b in zip(pos, jpcap.read_position_packets(path)):
        np.testing.assert_array_equal(a, b)
    assert len(pos[0]) == 1          # one position packet per second
    assert jpk.unpack_position_packet(pos[0][0].tobytes()) == \
        pk.unpack_position_packet(pos[0][0].tobytes())


def test_position_packets_and_nmea_equal():
    utc = 1_700_000_123_456_789
    for lat, lon in ((31.0, 121.0), (-33.9, -70.6)):
        assert pk.make_gprmc(utc, lat, lon) == jpk.make_gprmc(utc, lat, lon)
        raw = pk.pack_position_packet(utc % 3_600_000_000, utc, lat, lon)
        assert raw == jpk.pack_position_packet(utc % 3_600_000_000, utc,
                                               lat, lon)
        info = pk.unpack_position_packet(raw)
        assert info == jpk.unpack_position_packet(raw)
        assert info["rmc"]["valid"] and info["pps_status_str"] == "locked"
    assert pk.parse_gprmc(pk.make_gprmc(utc, 1.0, 2.0, valid=False)) == \
        jpk.parse_gprmc(jpk.make_gprmc(utc, 1.0, 2.0, valid=False))


def test_ins_txt_round_trip_equal(seqs, tmp_path):
    seq, _ = seqs
    args = (seq["ins_t_us"], seq["ins_pos"][:, :2] + 0.3, seq["ins_yaw"])
    pk.write_ins_txt(str(tmp_path / "a.txt"), *args, speed=np.ones(
        len(args[0])))
    jpk.write_ins_txt(str(tmp_path / "b.txt"), *args, speed=np.ones(
        len(args[0])))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt"
                                                ).read_text()
    ours, ref = pk.read_ins_txt(str(tmp_path / "a.txt")), jpk.read_ins_txt(
        str(tmp_path / "a.txt"))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_slam_config_defaults_equal():
    """The port's SlamConfig tree equals the JAX package's, field for
    field, but for the multi-device layout (`mesh`), not ported yet."""
    import dataclasses

    from veloslam_tpu import config as jcfg
    want = dataclasses.asdict(jcfg.SlamConfig())
    want.pop("mesh")
    assert dataclasses.asdict(cfgmod.SlamConfig()) == want
    sc = cfgmod.SensorConfig(laser_mask=(0, 3, 5))
    np.testing.assert_array_equal(
        sc.enabled_lasers(),
        jcfg.SensorConfig(laser_mask=(0, 3, 5)).enabled_lasers())
    assert cfgmod.SensorConfig().enabled_lasers() is None
    assert cfgmod.SlamConfig.from_dict(want) == cfgmod.SlamConfig()


def test_geodesy_timesync_and_pose_helpers_equal():
    from veloslam_tpu.core import geodesy as jgeo
    from veloslam_tpu.core import timesync as jts
    rng = np.random.default_rng(3)
    org = jgeo.llh2xyz_np(np.asarray([0.54, 2.11, 10.0]))
    enu = rng.normal(0, 500, (20, 3))
    np.testing.assert_array_equal(geodesy.llh2xyz_np(np.asarray(
        [0.54, 2.11, 10.0])), org)
    np.testing.assert_array_equal(geodesy.enu2llh_np(enu, org),
                                  jgeo.enu2llh_np(enu, org))
    np.testing.assert_array_equal(geodesy.xyz2llh_np(org),
                                  jgeo.xyz2llh_np(org))
    us = np.concatenate([np.arange(3_599_000_000, 3_600_000_000, 97_000),
                         np.arange(0, 500_000, 97_000)])
    for ref_us in (None, 1_700_000_000_000_000, 1_700_000_900_000_000):
        np.testing.assert_array_equal(
            timesync.resolve_hour_stamps(us, 1_699_999_000_000_000, ref_us),
            jts.resolve_hour_stamps(us, 1_699_999_000_000_000, ref_us))
    q = rng.normal(size=(9, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t3 = rng.normal(size=(9, 3))
    for a, b in zip(se3.inverse_np(q, t3), jse3.inverse_np(q, t3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(se3.compose_np(q, t3, q[::-1], t3[::-1]),
                    jse3.compose_np(q, t3, q[::-1], t3[::-1])):
        np.testing.assert_array_equal(a, b)


def test_rpe_and_calibration_xml_equal(tmp_path):
    rng = np.random.default_rng(4)
    est, ref = rng.normal(size=(30, 2)), rng.normal(size=(30, 2))
    for d in (1, 3):
        assert ev.rpe(est, ref, delta=d) == jev.rpe(est, ref, delta=d)
    calib = jcal.hdl32()._replace(
        rot_correction_deg=rng.normal(0, 2, 32),
        dist_correction_m=rng.normal(0, 0.01, 32))
    jcal.to_xml(calib, str(tmp_path / "c.xml"))
    ours, want = cal.from_xml(str(tmp_path / "c.xml")), jcal.from_xml(
        str(tmp_path / "c.xml"))
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a, b)


def test_stage_timers_sync_at_stage_end():
    calls = []
    timers = StageTimers(sync=lambda: calls.append(1))
    for _ in range(3):
        with timers.stage("a"):
            pass
    s = timers.summary()
    assert calls == [1, 1, 1] and s["a"]["count"] == 3
    assert set(s["a"]) == {"total_s", "count", "mean_ms"}
    assert "a" in timers.report()
