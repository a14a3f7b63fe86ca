"""The torch drive generator against the port's numpy simulator, and its
files against the port's writers, on 0.5 s HDL-32 and HDL-64 drives.

The torch code repeats the simulator's float64 operations in its order,
so the two agree byte for byte but for one tolerance: torch's and
numpy's float64 sine, cosine and square root may round the last bit
differently (torch's vectorised kernels, and on the card CUDA's), which
moves a return whose range lies on a half 2 mm unit to the next code, or
a ray that grazes an edge to a hit or a miss.  So every field but the
returns is equal, and at most 1 in 10^4 returns (distance code and
intensity) differ, none by more than one distance unit unless the hit
changed."""

import filecmp

import numpy as np
import pytest

from slambench.gen import drive, files, scene
from slambench.gen import sensor as S
from slambench.lib import drives, registry

sim = pytest.importorskip("veloslam_tpu_torch.io.simulate")
from veloslam_tpu_torch.decode import calibration  # noqa: E402
from veloslam_tpu_torch.io import packets as pkmod  # noqa: E402

WORLDS = {"hdl32": (3, 40.0, 40, 16, 8.0, 8.0),
          "hdl64": (3, 80.0, 24, 8, 30.0, 10.0)}


@pytest.mark.parametrize("model", ["hdl32", "hdl64"])
def test_packets_and_ins_equal_the_port_simulator(model):
    seed, extent, n_posts, n_walls, radius, speed = WORLDS[model]
    calib = S.unit_calib(model, 64, 2.0, 0.05) if model == "hdl64" else None
    got = drive.generate(0.5, model, scene.World.demo(
        seed, extent=extent, n_posts=n_posts, n_walls=n_walls),
        scene.Circle(radius, speed), calib=calib)
    port_calib = None
    if calib is not None:
        port_calib = calibration.default_for(model)._replace(
            rot_correction_deg=calib.rot_deg,
            vert_correction_deg=calib.vert_deg)
    want = sim.generate_sequence(
        0.5, model=model, world=sim.World.demo(
            seed, extent=extent, n_posts=n_posts, n_walls=n_walls),
        trajectory=sim.circle_trajectory(radius=radius, speed=speed),
        calib=port_calib)
    a = pkmod.decode_lidar_packets_np(got.packets)
    b = pkmod.decode_lidar_packets_np(want["packets"])
    for key in ("block_id", "az_ticks", "gps_us"):
        np.testing.assert_array_equal(a[key], b[key])
    diff = (a["dist_raw"] != b["dist_raw"]) | (a["intensity"]
                                              != b["intensity"])
    assert diff.mean() <= 1e-4
    same_hit = a["intensity"] == b["intensity"]
    step = np.abs(a["dist_raw"].astype(np.int64) - b["dist_raw"])
    assert np.all(step[same_hit] <= 1)
    np.testing.assert_array_equal(got.pkt_times_us, want["pkt_times_us"])
    np.testing.assert_array_equal(got.ins_t_us, want["ins_t_us"])
    np.testing.assert_array_equal(got.ins_pos, want["ins_pos"])
    np.testing.assert_array_equal(got.ins_yaw, want["ins_yaw"])


def test_files_equal_the_port_writers(tmp_path):
    """pcap (with its position packets) and INS log as write_sequence
    and write_ins_txt write them for bench.py's drifting drive, given
    the same packets."""
    got = drive.generate(1.5, "hdl32", scene.World.demo(
        3, extent=40.0, n_posts=40, n_walls=16), scene.Circle(8.0, 8.0))
    seq = sim.generate_sequence(
        1.5, model="hdl32", world=sim.World.demo(
            3, extent=40.0, n_posts=40, n_walls=16),
        trajectory=sim.circle_trajectory(radius=8.0, speed=8.0))
    got.packets = seq["packets"]
    (tmp_path / "a").mkdir()
    paths, ins = files.write_drive(got, str(tmp_path / "a"), 1.0)
    ref = sim.write_sequence(seq, str(tmp_path), name="ref")
    r = pkmod.read_ins_txt(ref["ins"])
    ts = (r["t_us"] - r["t_us"][0]) * 1e-6
    pkmod.write_ins_txt(ref["ins"], r["t_us"], r["pos_xy"] + np.stack(
        [np.zeros_like(ts), ts], -1), np.deg2rad(r["yaw_deg"]),
        speed=r["speed"])
    assert filecmp.cmp(paths["pcap"], ref["pcap"], shallow=False)
    assert filecmp.cmp(paths["ins"], ref["ins"], shallow=False)


def test_calibration_file_reads_back():
    calib = S.unit_calib("hdl64", 7, 2.0, 0.05)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        S.write_db_xml(calib, f"{d}/db.xml")
        back = calibration.from_xml(f"{d}/db.xml")
    np.testing.assert_array_equal(back.rot_correction_deg, calib.rot_deg)
    np.testing.assert_array_equal(back.vert_correction_deg, calib.vert_deg)


def _config(model):
    cfg = registry.config("hdl32e_vehicle")
    if model == "hdl64":
        cfg["sensor"].update(model="hdl64", lasers=64, unit_calibration={
            "rot_sd_deg": 2.0, "vert_sd_deg": 0.05})
    return cfg


@pytest.mark.parametrize("model", ["hdl32", "hdl64"])
def test_same_seed_same_files(tmp_path, model):
    cfg = _config(model)
    out = []
    for k, seed in enumerate((2**31 + 17, 2**31 + 17, 5)):
        d = tmp_path / str(k)
        d.mkdir()
        f = drives.make(cfg, 0.5, seed, "cpu", str(d))
        out.append(f.paths)
    for key in out[0]:
        assert filecmp.cmp(out[0][key], out[1][key], shallow=False)
    assert not filecmp.cmp(out[0]["pcap"], out[2]["pcap"], shallow=False)
