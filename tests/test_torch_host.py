"""The port's jax-free host copies stay equal to the JAX package's
originals, and the port imports no jax.

The port carries its own numpy copies of the simulator and its pcap / INS
writers, the packet encoders and position-packet parsers, the pcap
readers (bulk and per record), calibration tables and the XML loader,
Timeline and PoseTrack (queries and npz files), geodesy, the hour-stamp
resolution, the numpy pose helpers, the trajectory metrics and the
SlamConfig tree, because the originals' package __init__s import jax,
which the card's machine does not have.  These tests hold the copies
byte- and value-equal (the FrameStore copy: tests/test_torch_framestore.py)."""

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
    assert len(names) == 24
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
    """Importing every module of the port (the registration methods, live
    mode's UDP, INS and packet-pump modules, the tools, the multi-device
    package and the scaling bench among them) loads nothing of jax and
    nothing of the JAX package."""
    code = (
        "import sys, pkgutil, importlib, veloslam_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "want = {'veloslam_tpu_torch.' + m for m in (\n"
        "    'registration.d2d', 'registration.ndt', 'registration.gicp',\n"
        "    'registration.voxel', 'io.udp', 'io.ins', 'io.native',\n"
        "    'apps.replay', 'apps.inspect', 'apps.slam_run',\n"
        "    'utils.viewer', 'utils.dumps', 'map.landmarks',\n"
        "    'parallel.mesh', 'parallel.dist', 'parallel.sharded',\n"
        "    'parallel.halo', 'parallel.session', 'apps.scaling_bench')}\n"
        "assert want <= names, sorted(want - names)\n"
        "top = ('jax', 'jaxlib', 'veloslam_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in top)\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_the_port_from_another_directory(tmp_path):
    """chip_smoke.py's module body puts its own directory first on
    sys.path, so `python3 chip_smoke.py` imports the port wherever it is
    started from, even under `python -P` (no script directory on
    sys.path): from an empty directory under -P, the port does not import
    before the body runs and does after it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "chip_smoke.py")
    code = ("import runpy, sys\n"
            "try:\n"
            "    import veloslam_tpu_torch\n"
            "    sys.exit('imported before the module body ran')\n"
            "except ModuleNotFoundError:\n"
            "    pass\n"
            "runpy.run_path(sys.argv[1], run_name='not_main')\n"
            "import veloslam_tpu_torch\n"
            "print(veloslam_tpu_torch.__file__)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-P", "-c", code, script],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == os.path.join(repo, "veloslam_tpu_torch",
                                              "__init__.py")


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
    field, the multi-device layout (`mesh`) included."""
    import dataclasses

    from veloslam_tpu import config as jcfg
    want = dataclasses.asdict(jcfg.SlamConfig())
    assert dataclasses.asdict(cfgmod.SlamConfig()) == want
    mc = cfgmod.MeshConfig(data_axis=2, map_axis=4)
    assert dataclasses.asdict(mc) == dataclasses.asdict(
        jcfg.MeshConfig(data_axis=2, map_axis=4))
    assert mc.n_devices == jcfg.MeshConfig(data_axis=2,
                                           map_axis=4).n_devices == 8
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
    assert set(s["a"]) == {"total_s", "count", "mean_ms", "self_s"}
    assert "a" in timers.report()


def test_timeline_queries_equal():
    """nearest / bracket / range_between on both Timelines, scalar and
    batched queries, the ends and ties included."""
    from veloslam_tpu.core.timeline import Timeline as JTimeline

    from veloslam_tpu_torch.core.timeline import Timeline
    rng = np.random.default_rng(5)
    times = np.unique(rng.integers(0, 10_000, 60))
    ours, ref = Timeline(("v",)), JTimeline(("v",))
    for tl in (ours, ref):
        for t_us in times[::-1]:             # out of order: a re-sort
            tl.add(int(t_us), v=np.float64(t_us) * 0.5)
    q = np.concatenate([rng.integers(-100, 10_100, 50), times[:5],
                        (times[:-1] + times[1:]) // 2])
    np.testing.assert_array_equal(ours.nearest(q), ref.nearest(q))
    assert ours.nearest(int(q[0])) == ref.nearest(int(q[0]))
    for a, b in zip(ours.bracket(q), ref.bracket(q)):
        np.testing.assert_array_equal(a, b)
    for t0, t1 in ((0, 10_000), (int(times[3]), int(times[9])), (50, 40)):
        assert ours.range_between(t0, t1) == ref.range_between(t0, t1)


def test_timeline_and_pose_track_files_interchange(tmp_path):
    """Timeline / PoseTrack npz files: the port writes the JAX package's
    bytes, and each package loads the other's."""
    from veloslam_tpu.core.timeline import Timeline as JTimeline
    from veloslam_tpu_torch.core.timeline import Timeline
    ours, ref = Timeline(("a", "b")), JTimeline(("a", "b"))
    for tl in (ours, ref):
        for k in range(5):
            tl.add(100 * k, a=np.arange(3) * k, b=float(k))
    ours.save(str(tmp_path / "o.npz"))
    ref.save(str(tmp_path / "r.npz"))
    assert (tmp_path / "o.npz").read_bytes() == \
        (tmp_path / "r.npz").read_bytes()
    for cls, path in ((Timeline, "r.npz"), (JTimeline, "o.npz")):
        back = cls.load(str(tmp_path / path))
        ta, va = back.arrays()
        tb, vb = ref.arrays()
        np.testing.assert_array_equal(ta, tb)
        for k in vb:
            np.testing.assert_array_equal(va[k], vb[k])
    track, jtrack = PoseTrack(), JPoseTrack()
    for tr in (track, jtrack):
        for k in range(4):
            tr.add(1000 * k, q=[1, 0, 0, 0], t=[k, 2.0 * k, 0], v=[1, 0, 0])
    track.save(str(tmp_path / "pt.npz"))
    back = JPoseTrack.load(str(tmp_path / "pt.npz"))
    mine = PoseTrack.load(str(tmp_path / "pt.npz"))
    for a, b in ((back, jtrack), (mine, jtrack)):
        wa = a.window(0, 3000, anchor_us=0)
        wb = b.window(0, 3000, anchor_us=0)
        for k in wb:
            np.testing.assert_array_equal(wa[k], wb[k])


def test_pcap_reader_records_equal(seqs, tmp_path):
    """PcapReader yields the JAX reader's (payload, time, offset) records,
    from the start and after a seek to a record offset."""
    from veloslam_tpu.io import pcap as jpcap
    seq, _ = seqs
    path = sim.write_sequence(seq, str(tmp_path), name="d")["pcap"]
    _, _, offs = pcap.read_lidar_packets(path)
    for start in (None, int(offs[17])):
        with pcap.PcapReader(path) as a, jpcap.PcapReader(path) as b:
            if start is not None:
                a.seek(start)
                b.seek(start)
            got, want = list(a), list(b)
            assert a.tell() == b.tell()
        assert len(got) == len(want) > 10
        assert got == want


@pytest.mark.parametrize("name", ["hdl32", "vlp16", "hdl64"])
def test_to_xml_round_trips_through_both_packages(name, tmp_path):
    """A calibration with every term perturbed, written by the port's
    to_xml: both packages' from_xml read back the same float64 values,
    and the file is byte-equal to the JAX package's to_xml's."""
    rng = np.random.default_rng(len(name))
    base = cal.default_for(name)
    k = base.n_lasers
    calib = base._replace(
        rot_correction_deg=rng.normal(0, 2, k),
        vert_correction_deg=base.vert_correction_deg + rng.normal(0, 0.1, k),
        dist_correction_m=rng.normal(0, 0.01, k),
        vert_offset_m=rng.normal(0, 0.02, k),
        horiz_offset_m=rng.normal(0, 0.02, k))
    ours, ref = str(tmp_path / "ours.xml"), str(tmp_path / "jax.xml")
    cal.to_xml(calib, ours)
    jcal.to_xml(jcal.LaserCalib(*calib), ref)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for back in (cal.from_xml(ours), jcal.from_xml(ours)):
        assert back.n_lasers == k
        # centimetre fields pass through ×100 then ÷100: equal to 1 ulp
        for a, b in zip(back[:2], calib[:2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(back[2:], calib[2:]):
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)
    for a, b in zip(cal.from_xml(ours), jcal.from_xml(ours)):
        np.testing.assert_array_equal(a, b)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace(log_dir) records the region into log_dir as a Chrome
    trace (on the CPU: CPU activity); device_trace(None) records
    nothing."""
    import torch

    from veloslam_tpu_torch.utils.profiling import device_trace
    with device_trace(None):
        torch.ones(3).sum()
    assert not any(tmp_path.iterdir())
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        torch.mm(torch.ones(64, 64), torch.ones(64, 64)).sum()
    files = list(log_dir.iterdir())
    assert [f.name for f in files] == ["trace.json"]
    trace = json.loads(files[0].read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in nm for nm in names), sorted(names)[:20]
