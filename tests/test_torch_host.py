"""The port's jax-free host copies stay equal to the JAX package's
originals, and the port imports no jax.

The port carries its own numpy copies of the simulator, packet encoders,
calibration tables, PoseTrack and the trajectory metrics because the
originals' package __init__s import jax, which the card's machine does
not have.  These tests hold the copies byte- and value-equal."""

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
from veloslam_tpu_torch import constants as const
from veloslam_tpu_torch.core.timeline import PoseTrack
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.io import packets as pk
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime import evaluate as ev


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
    assert len(names) == 16
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
