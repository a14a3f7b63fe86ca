"""bench_torch.py, the port's benchmark entry point, against bench.py and
the JAX package on the same seeded inputs.

* bench_torch loads neither jax nor veloslam_tpu (a subprocess's
  sys.modules).
* Its constants and config signature equal bench.py's; its bulk inputs,
  calibration, full-SLAM drive files and SlamConfig equal bench.py's to
  the byte; its roofline counts bench.py's bytes, and its floors follow
  the rates it is given.
* The bulk step with bench.py's keyword set, at a reduced size (2048
  packets, 8 slots, 2048 points, 4 GN iterations, 8192 map rows), from
  one warm state carried across packages, against the JAX
  odometry_step_batched: test_torch_odometry.py's tolerance (positions
  1e-4 m, quaternions 1e-5, map keys exact, counts 1e-5 relative, times
  and frame counts exact).
* run_full_slam on a 1 s drive on the CPU: bench.py's keys, and one frame
  per revolution the drive completes.
* main(): the headline line first, the extended line last, exit 1 when a
  stage raised, 0 when a stage was skipped for the budget; it raises
  without a card.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.io import packets as pkmod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONSTANTS = ("BATCH_PACKETS", "MAX_FRAMES_BATCH", "HDL32_PACKETS_PER_SECOND",
             "FRAMES_PER_BATCH", "REG_POINTS", "REG_ITERATIONS",
             "MAP_CAPACITY", "VOXEL_SIZE", "REASSOCIATE_EVERY",
             "SAMPLE_ASSEMBLY", "REFERENCE_CPU_CONFIG")
RESULT_KEYS = {"frames_per_s", "wall_s", "n_frames", "n_keyframes",
               "n_closures", "map_patches", "ate_rmse_m", "x_realtime",
               "stage_s"}
SMALL = dict(max_frames_batch=8, reg_points=2048, reg_iterations=4,
             map_capacity=8192)


def test_bench_torch_loads_no_jax():
    code = (
        "import sys, bench_torch as b\n"
        "b._host_inputs(batch_packets=64); b._slam_cfg()\n"
        "b.run_roofline(1e4, {k: {'gb_per_s': 1.0} for k in ('stream', "
        "'sort', 'segment_sum', 'gather_rows8', 'gather_i32')})\n"
        "import veloslam_tpu_torch.runtime.pipeline, "
        "veloslam_tpu_torch.apps.replay\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'veloslam_tpu'))\n"
        "assert not bad, bad\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal_bench(name):
    assert getattr(bench_torch, name) == getattr(bench, name)


def test_config_signature_equals_bench():
    assert bench_torch.config_signature() == bench.config_signature()
    assert bench_torch.config_signature() == bench_torch.REFERENCE_CPU_CONFIG


def test_build_inputs_byte_equal_to_bench():
    jin = bench._build_inputs(batch_packets=2048)
    pin = bench_torch._build_inputs(batch_packets=2048, device="cpu")
    assert len(jin) == len(pin) == 7
    for k, (j, p) in enumerate(zip(jin, pin)):
        if k == 1:
            continue
        j = np.asarray(j)
        assert p.numpy().dtype == j.dtype and p.shape == j.shape, k
        assert p.numpy().tobytes() == j.tobytes(), k
    jcal, pcal = jin[1], pin[1]
    assert type(jcal)._fields == type(pcal)._fields
    for f in type(pcal)._fields:
        j = np.asarray(getattr(jcal, f))
        p = getattr(pcal, f).numpy()
        assert p.dtype == j.dtype and p.tobytes() == j.tobytes(), f
    # chip_smoke's bulk inputs are these arrays.
    for a, b in zip(bench_torch._host_inputs(batch_packets=2048),
                    (x for k, x in enumerate(pin) if k != 1)):
        assert a.tobytes() == b.numpy().tobytes()


def test_make_drive_byte_equal_to_bench():
    jpaths, jseq = bench._make_drive(1.0)
    ppaths, pseq = bench_torch._make_drive(1.0)
    try:
        for key in ("pcap", "ins"):
            with open(jpaths[key], "rb") as f, open(ppaths[key], "rb") as g:
                assert f.read() == g.read(), key
        for key in ("packets", "pkt_times_us", "ins_t_us", "ins_pos"):
            np.testing.assert_array_equal(pseq[key], jseq[key], err_msg=key)
    finally:
        for paths in (jpaths, ppaths):
            shutil.rmtree(os.path.dirname(paths["pcap"]))


def test_slam_cfg_equals_bench():
    assert dataclasses.asdict(bench_torch._slam_cfg()) == \
        dataclasses.asdict(bench._slam_cfg())


def _rates(scale=1.0):
    return {"stream": {"gb_per_s": 2000.0 * scale},
            "sort": {"gb_per_s": 30.0 * scale},
            "segment_sum": {"gb_per_s": 100.0 * scale},
            "gather_rows8": {"gb_per_s": 1500.0 * scale},
            "gather_i32": {"gb_per_s": 500.0 * scale}}


def test_roofline_counts_bench_bytes_and_follows_rates():
    r = bench_torch.run_roofline(50.0, _rates())
    assert r["bytes_per_batch_MB"] == bench.run_roofline(50.0)[
        "bytes_per_batch_MB"]
    for k in ("measured_bulk_ms", "bytes_per_batch_MB", "hbm_floor_ms",
              "primitive_floor_ms", "fraction_of_primitive_floor",
              "fraction_of_hbm_floor", "conclusion"):
        assert k in r, k
    total = r["bytes_per_batch_MB"] * 1e6
    assert r["hbm_floor_ms"] == pytest.approx(total / 3.35e12 * 1e3,
                                              abs=1e-3)
    # Each term is its bytes over its rate: twice the rates, half the
    # floor; the HBM floor does not move.
    r2 = bench_torch.run_roofline(50.0, _rates(2.0))
    assert r2["primitive_floor_ms"] == pytest.approx(
        r["primitive_floor_ms"] / 2, abs=2e-3)
    assert r2["hbm_floor_ms"] == r["hbm_floor_ms"]
    for k, v in r["primitive_floor_terms_ms"].items():
        assert r2["primitive_floor_terms_ms"][k] == pytest.approx(v / 2,
                                                                  abs=1e-3)
    assert r["primitive_floor_ms"] == pytest.approx(
        sum(r["primitive_floor_terms_ms"].values()), abs=5e-3)
    assert "Pallas" not in r["conclusion"] and "v5e" not in r["conclusion"]


def test_roofline_raises_on_a_floor_beaten():
    r = bench_torch.run_roofline(50.0, _rates())
    with pytest.raises(AssertionError, match="counting error"):
        bench_torch.run_roofline(r["primitive_floor_ms"] / 1.1, _rates())


def test_primitive_rates_at_a_small_size_on_the_cpu():
    rates = bench_torch.primitive_rates("cpu", runs=2, n_sort=4096,
                                        n_rows=4096, copy_bytes=1 << 20)
    assert set(rates) == {"sort", "segment_sum", "gather_rows8",
                          "gather_i32", "stream"}
    for v in rates.values():
        assert math.isfinite(v["gb_per_s"]) and v["gb_per_s"] > 0
        assert v["ms"] > 0 and v["payload_MB"] > 0


def test_bulk_step_matches_jax_from_a_warm_state(small_threads):
    from veloslam_tpu.runtime import odometry as jodo

    jin = bench._build_inputs(batch_packets=2048)
    (pkts, calib, rel_s, track_rel, track_q, track_t, track_v) = jin
    zero = jnp.asarray(0.0, jnp.float32)

    def jstep(state):
        return jodo.odometry_step_batched(
            state, pkts, calib, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, model="hdl32", n_beams=32,
            reg_points=SMALL["reg_points"],
            reg_iterations=SMALL["reg_iterations"],
            max_frames_batch=SMALL["max_frames_batch"], use_pallas=False,
            use_dense=True, reassociate_every=bench.REASSOCIATE_EVERY,
            sample_assembly=bench.SAMPLE_ASSEMBLY)

    fresh = jodo.init_state(32, map_capacity=SMALL["map_capacity"],
                            voxel_size=bench.VOXEL_SIZE,
                            sample_assembly=bench.SAMPLE_ASSEMBLY)
    warm, _ = jstep(fresh)
    assert bool(warm.have_map) and int(warm.n_frames) > 0
    js, jopen = jstep(warm)

    leaves = type(warm)(*(
        type(x)(*(np.asarray(y) for y in x)) if isinstance(x, tuple)
        else np.asarray(x) for x in warm))
    once, _ = bench_torch._bulk_step(
        bench_torch._build_inputs(batch_packets=2048, device="cpu"),
        **SMALL)
    ps, popen = once(convert.odometry_state_from_numpy(leaves, "cpu"))
    ps = convert.odometry_state_to_numpy(ps)

    nf = int(js.n_frames)
    assert int(ps.n_frames) == nf and nf > int(warm.n_frames)
    n = np.asarray
    np.testing.assert_array_equal(ps.traj_time, n(js.traj_time))
    np.testing.assert_allclose(ps.traj_t[:nf], n(js.traj_t)[:nf], atol=1e-4)
    np.testing.assert_allclose(ps.traj_q[:nf], n(js.traj_q)[:nf], atol=1e-5)
    np.testing.assert_allclose(ps.corr_t, n(js.corr_t), atol=1e-4)
    np.testing.assert_allclose(ps.corr_q, n(js.corr_q), atol=1e-5)
    np.testing.assert_array_equal(ps.map_grid.keys, n(js.map_grid.keys))
    np.testing.assert_allclose(ps.map_grid.count, n(js.map_grid.count),
                               rtol=1e-5)
    assert float(popen) == float(jopen)


def test_run_bulk_times_the_warm_map_and_the_empty_map_in_turns():
    r = bench_torch.run_bulk(iters=3, batch_packets=1024,
                             max_frames_batch=4, reg_points=512,
                             reg_iterations=2, map_capacity=4096,
                             device="cpu", empty_map_too=True)
    assert r["steps"] == 1 + 2 * 1 + 2 * 3
    assert len(r["ms_runs"]) == 3 and r["ms"] == np.median(r["ms_runs"])
    assert r["ms_spread"] == [min(r["ms_runs"]), max(r["ms_runs"])]
    assert r["frames_per_s"] == pytest.approx(
        1024 / bench.HDL32_PACKETS_PER_SECOND * 10.0 / (r["ms"] * 1e-3))
    lo, hi = r["ms_from_empty_map_spread"]
    assert 0 < lo <= r["ms_from_empty_map"] <= hi


def _revolutions(pcap_path: str) -> int:
    """Revolutions the drive completes: azimuth wraps of its LiDAR
    packets' firing blocks."""
    from veloslam_tpu_torch.io.pcap import read_lidar_packets
    pkts, _, _ = read_lidar_packets(pcap_path)
    az = pkmod.decode_lidar_packets_np(pkts)["az_ticks"].reshape(-1)
    return int((np.diff(az.astype(np.int64)) < 0).sum())


def test_run_full_slam_on_the_cpu(small_threads, monkeypatch):
    seen = {}
    make = bench_torch._make_drive

    def recording(duration_s, **kw):
        paths, seq = make(duration_s, **kw)
        seen["revolutions"] = _revolutions(paths["pcap"])
        return paths, seq

    monkeypatch.setattr(bench_torch, "_make_drive", recording)
    r = bench_torch.run_full_slam(
        duration_s=1.0, warm_s=0, device="cpu",
        check=lambda pipe, res, seq: seen.update(res=res))
    assert set(r) == RESULT_KEYS
    assert r["n_frames"] == seen["res"]["n_frames"] == seen["revolutions"]
    assert r["wall_s"] > 0 and math.isfinite(r["ate_rmse_m"])
    assert np.isfinite(seen["res"]["positions"]).all()


def _fake_stages(monkeypatch, full_slam):
    monkeypatch.setattr(bench_torch, "device_info",
                        lambda device: {"name": "test", "power_limit": None})
    monkeypatch.setattr(bench_torch, "_build_inputs", lambda **kw: ())
    monkeypatch.setattr(bench_torch, "run_bulk", lambda **kw: {
        "frames_per_s": 1000.0, "ms": 50.0, "ms_spread": [49.0, 51.0],
        "ms_runs": [50.0] * 7, "steps": 17, "ms_from_empty_map": 40.0,
        "ms_from_empty_map_spread": [39.0, 41.0]})
    monkeypatch.setattr(bench_torch, "primitive_rates",
                        lambda device: _rates())
    monkeypatch.setattr(bench_torch, "run_full_slam", full_slam)
    monkeypatch.setattr(bench_torch, "run_live_sweep",
                        lambda budget, device: [{"rate_x_sensor": 1.0}])


def _lines(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_main_records_a_stage_that_raises_and_exits_1(monkeypatch, capsys):
    def boom(**kw):
        raise RuntimeError("no drive")

    _fake_stages(monkeypatch, boom)
    assert bench_torch.main([], device="cpu") == 1
    out = capsys.readouterr().out.splitlines()
    first, last = json.loads(out[0]), json.loads(out[-1])
    assert first["metric"] == last["metric"] == \
        "hdl32_bulk_odometry_frames_per_s_per_chip"
    assert first["value"] == last["value"] == 1000.0
    assert "full_slam" not in first["extra"]
    assert last["extra"]["full_slam"].startswith("error: no drive")
    assert last["extra"]["live"] == [{"rate_x_sensor": 1.0}]
    for k in ("device", "bulk_ms_spread", "rates", "roofline",
              "bulk_ms_from_empty_map"):
        assert k in first["extra"], k


def test_main_skips_a_stage_for_the_budget_and_exits_0(monkeypatch, capsys):
    _fake_stages(monkeypatch, lambda **kw: {"frames_per_s": 1.0})
    assert bench_torch.main(["--full-budget-s", "0"], device="cpu") == 0
    lines = _lines(capsys)
    assert lines[-1]["extra"]["full_slam"] == "skipped: budget spent"
    assert lines[-1]["extra"]["live"] == "skipped: budget spent"


def test_headline_parses_with_a_finite_value(monkeypatch):
    rec = json.loads(json.dumps(bench_torch.headline(1234.5678, {})))
    assert rec["metric"] == "hdl32_bulk_odometry_frames_per_s_per_chip"
    assert math.isfinite(rec["value"]) and rec["unit"] == "frames/s"
    monkeypatch.setattr(bench_torch, "REFERENCE_CPU_FPS", 10.0)
    assert bench_torch.headline(100.0, {})["vs_baseline"] == 10.0
    monkeypatch.setattr(bench_torch, "REFERENCE_CPU_CONFIG", "other")
    assert bench_torch.headline(100.0, {})["vs_baseline"] is None


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_torch.main([])
