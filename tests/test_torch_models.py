"""Parity of the port with the JAX package on the two sensor families
besides the HDL-32: the HDL-64, with a per-unit calibration file (db.xml,
the built-in profile with seeded rotational and vertical corrections,
written by the port's to_xml and read through
SensorConfig.calibration_path), and the VLP-16.

Against tests/fixtures/models_golden_seed3.npz
(gen_torch_models_golden.py), on the CPU:

* Each model's small drive (HDL-64: 2 s on a 4 m circle; VLP-16: 2.2 s on
  a 2 m circle; INS drifting 1 m/s, 8192 points, a 32-keyframe graph)
  from pcap through run_offline + finalize() and through
  run_offline_batched + finalize(), with chip_smoke.py's per_frame and
  pipeline gates (frames and times, keyframes, the closures, at least
  one of them accepted mid-session, landmark counts, trajectory within
  5 cm in x, y, ATE at most the golden's + 0.02 m), and tighter here:
  positions within 5 mm (measured: per frame ≤ 2e-5 m, batched ≤ 1.3
  mm), the registered flags equal.
* StreamingOdometry on odometry_golden_seed23.npz's drifting 1.2 s drive
  for each model: the fused path (the JAX defaults) and the batched bulk
  step (dilated index, frame sampling): frames and times exact,
  positions within 1 cm.
* The CLI, `slam_run --model M [--calibration db.xml] --device cpu` on
  the small drive's pcap, against the JAX app's run: trajectory times
  equal, positions within 5 mm, frame and keyframe counts equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_helpers import small_threads  # noqa: F401

MODELS = ("hdl64", "vlp16")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=MODELS)
def drive(request, tmp_path_factory):
    """A model's small drive written to disk: (golden, config, drive with
    its SlamConfig reading the calibration file, paths, sequence)."""
    gold, cfg, drives = cs.models_drives("small")
    d = drives[request.param]
    paths, seq, slam = cs.write_models_drive(
        d, str(tmp_path_factory.mktemp(request.param)))
    return gold, cfg, dict(d, slam=slam), paths, seq


def test_per_frame_small_drive_matches_jax_golden(drive):
    gold, cfg, d, paths, seq = drive
    key = f"{d['name']}_per_frame"
    pipe, res, mid, _ = cs.run_perframe(paths, d, CPU)
    cs.check_perframe(pipe, res, mid, seq, gold, key, min_closures=1)
    assert len(mid) >= 1            # the graph solve and downdate ran
    assert res["timing"]["map_downdate"]["count"] >= 2
    np.testing.assert_array_equal([f.registered for f in pipe.trajectory],
                                  gold[f"{key}_registered"])
    np.testing.assert_allclose(res["positions"], gold[f"{key}_positions"],
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(res["keyframe_positions"],
                               gold[f"{key}_keyframe_positions"],
                               atol=5e-3, rtol=0)
    # The pipeline decoded with the unit's own table, not the built-in.
    spec = cfg["calibration"]
    want = (cs.unit_calibration(spec) if d["model"] == spec["model"]
            else None)
    if want is not None:
        assert d["slam"]["sensor"]["calibration_path"] == paths[
            "calibration"]
        for a, b in zip(pipe.calib, want):
            np.testing.assert_array_equal(a, b)
    assert pipe.calib.n_lasers == pipe.cfg.sensor.n_lasers


def test_batched_small_drive_matches_jax_golden(drive):
    gold, _, d, paths, seq = drive
    key = f"{d['name']}_batched"
    pipe, res, _ = cs.run_pipeline(paths, d, CPU)
    cs._check_pipeline(pipe, res, seq, gold, key, cs._launches(), None, CPU,
                       max_ate=np.inf)
    np.testing.assert_allclose(res["positions"], gold[f"{key}_positions"],
                               atol=5e-3, rtol=0)
    for k in ("n_landmarks", "n_landmark_obs"):
        assert res[k] == int(gold[f"{key}_{k}"]), k


@pytest.mark.parametrize("part", ["fused", "batched"])
@pytest.mark.parametrize("model", MODELS)
def test_streaming_odometry_matches_jax_golden(model, part):
    from fixtures.gen_torch_models_golden import odometry_drive
    from veloslam_tpu_torch.io import simulate as sim
    gold, cfg, _ = cs.models_drives("small")
    oc = cfg["odometry"]
    seq, calib = odometry_drive(cfg, model)
    track = sim.truth_track(seq, drift_rate=oc["drive"]["drift_rate"])
    flags = (dict(n_beams=calib.n_lasers) if part == "fused" else
             dict(n_beams=calib.n_lasers, batched=True, use_dense=True,
                  sample_assembly=True, **oc["config"]))
    res, _, _ = cs.run_odometry(seq, track, CPU, model,
                                oc[f"{part}_batch"], calib=calib, **flags)
    key = f"{model}_odometry_{part}"
    assert res["n_frames"] >= 10
    cs._check_odometry(f"models {key}", res, gold, key)


def test_slam_run_cli_matches_the_jax_app(drive, tmp_path):
    """slam_run's default mode (run_offline, no finalize) with --model
    and, for the HDL-64, --calibration: the port's CLI against the JAX
    app's trajectory.txt and metrics.json on the same files."""
    from veloslam_tpu_torch.apps import slam_run
    gold, _, d, paths, _ = drive
    key = f"{d['name']}_cli"
    args = ["--pcap", paths["pcap"], "--ins", paths["ins"], "--model",
            d["model"], "--device", "cpu", "--out-dir", str(tmp_path)]
    if "calibration" in paths:
        args += ["--calibration", paths["calibration"]]
    assert slam_run.main(args) == 0
    got = np.loadtxt(tmp_path / "trajectory.txt", ndmin=2)
    want = gold[f"{key}_trajectory"]
    assert got.shape == want.shape and len(got) > 10
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.abs(got[:, 1:4] - want[:, 1:4]).max() <= 5e-3
    with open(tmp_path / "metrics.json") as f:
        metrics = json.load(f)
    ref = json.loads(str(gold[f"{key}_metrics"]))
    for k in ("n_frames", "n_keyframes", "n_closures", "map_patches"):
        assert metrics[k] == ref[k], k


def test_golden_config_is_the_generators():
    """The golden's drives are what its generator derives from the other
    goldens' configs (the production SlamConfig, bench.py's drives)."""
    from fixtures.gen_torch_models_golden import golden_config
    gold = np.load(cs.MODELS_GOLDEN)
    assert json.loads(str(gold["config"])) == golden_config()
    assert os.path.basename(cs.MODELS_GOLDEN) == "models_golden_seed3.npz"
