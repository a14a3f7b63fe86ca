"""Generate models_golden_seed3.npz: the JAX package on the two sensor
families besides the HDL-32, the HDL-64 and the VLP-16, through every
single-card entry point, for the port to be held to.

Each model's drives are written by chip_smoke.write_models_drive: the
drive simulated for that sensor, its pcap (position packets every 1 s)
and an INS text log drifting 1.0 m/s in +y, as bench.py::_make_drive
writes it.  The HDL-64 runs with a per-unit calibration file, as every
real HDL-64 ships one (db.xml): the built-in profile with seeded
perturbations of the two terms the simulator encodes, each laser's
rotational (sd 2°) and vertical (sd 0.05°) correction
(chip_smoke.unit_calibration, CALIBRATION below).  The simulator
generates the drive with it, the port's to_xml writes it, and the JAX
pipeline reads it through SensorConfig.calibration_path, as
`slam_run --model hdl64 --calibration db.xml` does.  The JAX package
runs on the CPU:

  * "<model>_full": bench.py's full-SLAM drive (7 s, seed 3,
    World.demo(3, extent=40, n_posts=40, n_walls=16), an 8 m circle at
    8 m/s) at the production SlamConfig of perframe_golden_seed3.npz's
    "full" drive with sensor.model set.  Nothing is cut.  Recorded:
    run_offline + finalize ("per_frame", slam_run's default mode, 512-
    packet batches), run_offline_batched(batch=4096, defer_map=True) +
    finalize ("batched"), FullSlam.run_device + finalize_device at the
    engine of fullslam_golden_seed3.npz's "full" drive with the model's
    beams ("fullslam"), and slam_run --fast ("fast": the JAX app's
    trajectory.txt, --batch 8192, its default).
  * "<model>_small": the CPU tests' drive, the same parts at
    pipeline_golden_seed3.npz's and fullslam_golden_seed3.npz's "small"
    sizes (1024-packet batches, 8 closure candidates; `--fast` with
    --batch 1024).  It must accept a closure mid-session, so the graph
    solve and the map downdate run: the HDL-64 takes the 2 s drive on a
    4 m circle of perframe_golden_seed3.npz's "small" (8192 points, a
    32-keyframe graph, closure min_gap 8), which accepts three at its
    sweep of keyframe 10.  The VLP-16's sparser scans verify none of
    that sweep's candidates, a quarter turn apart (the forward match is
    tight, the reverse one fails the cycle gate; on a 3.5 s full turn
    the sweep of keyframe 30 still accepts none), so its small drive is
    VLP16_SMALL: 2.2 s on a 2 m circle at 8 m/s, where keyframes 0 and 10
    lie 3.6 m apart and the sweep of keyframe 10 accepts two closures,
    that of keyframe 20 a third.  Recorded
    besides: `slam_run --model <m> [--calibration db.xml]`'s default
    mode on its pcap ("cli": trajectory.txt, metrics.json).
  * "<model>_odometry": odometry_golden_seed23.npz's "dense8_drift"
    drive (1.2 s, seed 23, the INS drifting 0.3 m/s) for the model,
    through StreamingOdometry with the JAX defaults (fused, 512-packet
    batches, "fused") and the batched bulk step at the production
    registration config (dilated index, frame sampling, 256-packet
    batches, "batched").
  * "hdl64_<size>_live_<mode>": each HDL-64 drive as a live session
    (SlamPipeline.run_online through chip_smoke.ScriptedUdp,
    gen_torch_live_golden.record_session), per frame and fast, each +
    finalize.

Per-frame and live records are gen_torch_perframe_golden.record's,
batched ones gen_torch_pipeline_golden.record's, each with
"assoc_margin" (chip_smoke.assoc_margin over finalize's landmark
clustering); FullSlam's are gen_torch_fullslam_golden.record's.  The npz
keeps results only, under "<drive>_<part>_<field>", and the drives with
their SlamConfigs as JSON under "config", so the port rebuilds them from
this one file and needs no jax.

Run from the repository root (JAX on the CPU, ~12 minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_models_golden.py
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "models_golden_seed3.npz")
MODELS = ("hdl64", "vlp16")
CALIBRATION = {"model": "hdl64", "seed": 64, "rot_sd_deg": 2.0,
               "vert_sd_deg": 0.05}
VLP16_SMALL = {"duration_s": 2.2, "circle": {"radius": 2.0, "speed": 8.0}}
FAST_BATCH = {"full": 8192, "small": 1024}
FUSED_BATCH = 512
ORIGIN = (31.0, 121.5, 0.0)


def golden_config() -> dict:
    """Each model's drives, their SlamConfigs and engines, as plain JSON
    values."""
    for path in (REPO, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from gen_torch_fullslam_golden import golden_config as fullslam
    from gen_torch_perframe_golden import golden_config as per_frame
    from gen_torch_pipeline_golden import golden_config as batched
    frame = {d["name"]: d for d in per_frame()["drives"]}
    batch = {d["name"]: d["batch"] for d in batched()["drives"]}
    fs = fullslam()
    engine = {d["name"]: d for d in fs["drives"]}
    odo = json.loads(str(np.load(os.path.join(
        HERE, "odometry_golden_seed23.npz"))["config"]))
    drives = []
    for model in MODELS:
        n_beams = {"hdl64": 64, "vlp16": 16}[model]
        calib = CALIBRATION if model == CALIBRATION["model"] else None
        for size in ("full", "small"):
            d = json.loads(json.dumps(frame[size]))
            e = engine[size]
            d.update(name=f"{model}_{size}", model=model,
                     calibration=calib, batch=batch[size],
                     engine=dict(e["engine"], n_beams=n_beams),
                     finalize=e["finalize"],
                     max_candidates=e["max_candidates"],
                     budget_floor=fs["budget_floor"],
                     fast_batch=FAST_BATCH[size],
                     live_modes=(["per_frame", "fast"]
                                 if model == "hdl64" else []))
            d["slam"]["sensor"]["model"] = model
            if model == "vlp16" and size == "small":
                d.update(VLP16_SMALL)
            drives.append(d)
    dense = {d["name"]: d for d in odo["drives"]}["dense8_drift"]
    return {"models": list(MODELS), "calibration": CALIBRATION,
            "origin": list(ORIGIN), "drives": drives,
            "odometry": {"duration_s": odo["duration_s"],
                         "seed": odo["seed"], "drive": dense,
                         "batched_batch": odo["batch"],
                         "fused_batch": FUSED_BATCH,
                         "config": odo["odometry"]}}


def odometry_drive(cfg: dict, model: str):
    """The odometry part's sequence for `model` and the calibration it
    was simulated with (the port's LaserCalib: the per-unit table for the
    HDL-64, else the built-in one)."""
    import chip_smoke as cs
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.io import simulate as sim
    oc = cfg["odometry"]
    spec = cfg["calibration"]
    calib = (cs.unit_calibration(spec) if model == spec["model"]
             else calibration.default_for(model))
    seq = sim.generate_sequence(duration_s=oc["duration_s"], model=model,
                                seed=oc["seed"],
                                world=sim.World.demo(**oc["drive"]["world"]),
                                calib=calib)
    return seq, calib


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from gen_torch_fullslam_golden import ins_track
    from gen_torch_fullslam_golden import record as fullslam_record
    from gen_torch_live_golden import measure_margins, record_session
    from gen_torch_perframe_golden import record as frame_record
    from gen_torch_pipeline_golden import jax_slam_config
    from gen_torch_pipeline_golden import record as batched_record
    from veloslam_tpu.apps import slam_run
    from veloslam_tpu.apps.replay import replay_ins_txt
    from veloslam_tpu.decode import calibration
    from veloslam_tpu.decode.decode import DeviceCalib
    from veloslam_tpu.io import udp
    from veloslam_tpu.runtime.fullslam import FullSlam
    from veloslam_tpu.runtime.odometry import StreamingOdometry
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    margins = measure_margins()

    cfg = golden_config()
    out = {"config": json.dumps(cfg)}

    def keep(key, r):
        for k, v in r.items():
            out[f"{key}_{k}"] = v

    for drive in cfg["drives"]:
        name = drive["name"]
        with tempfile.TemporaryDirectory() as d:
            paths, seq, slam = cs.write_models_drive(drive, d)
            calib = (calibration.from_xml(paths["calibration"])
                     if "calibration" in paths
                     else calibration.default_for(drive["model"]))
            margins.clear()
            pipe = SlamPipeline(jax_slam_config(slam))
            pipe.run_offline(paths["pcap"], paths["ins"])
            mid = list(pipe.closures)
            res = pipe.finalize()
            r = frame_record(pipe, res, mid, seq, drive)
            r["assoc_margin"] = min(margins, default=np.inf)
            keep(f"{name}_per_frame", r)
            print(f"{name} per_frame: {r['n_frames']} frames "
                  f"({int(r['registered'].sum())} registered), "
                  f"{r['n_keyframes']} keyframes, closures mid-session "
                  f"{mid}, in all {pipe.closures}, {r['n_landmarks']} "
                  f"landmarks; ATE {r['ate']:.4f} m (raw INS "
                  f"{r['ate_raw_ins']:.3f}); margin {r['assoc_margin']:.2e}",
                  flush=True)

            margins.clear()
            pipe = SlamPipeline(jax_slam_config(slam))
            pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                     batch=drive["batch"], defer_map=True)
            res = pipe.finalize()
            r = batched_record(pipe, res, seq, drive)
            r["assoc_margin"] = min(margins, default=np.inf)
            keep(f"{name}_batched", r)
            print(f"{name} batched: {r['n_frames']} frames, "
                  f"{r['n_keyframes']} keyframes, closures "
                  f"{pipe.closures}, {r['n_landmarks']} landmarks / "
                  f"{r['n_landmark_obs']} obs; ATE {r['ate']:.4f} m",
                  flush=True)

            calib_args = (["--calibration", paths["calibration"]]
                          if "calibration" in paths else [])
            args = ["--pcap", paths["pcap"], "--ins", paths["ins"],
                    "--model", drive["model"], *calib_args,
                    "--platform", "cpu"]
            app = os.path.join(d, "fast")
            if slam_run.main([*args, "--fast", "--batch",
                              str(drive["fast_batch"]), "--out-dir",
                              app]) != 0:
                raise AssertionError(f"{name}: slam_run --fast failed")
            traj = np.loadtxt(os.path.join(app, "trajectory.txt"), ndmin=2)
            keep(f"{name}_fast", {"trajectory": traj})
            print(f"{name} fast: {len(traj)} frames", flush=True)
            if name.endswith("_small"):
                app = os.path.join(d, "cli")
                if slam_run.main([*args, "--out-dir", app]) != 0:
                    raise AssertionError(f"{name}: slam_run failed")
                traj = np.loadtxt(os.path.join(app, "trajectory.txt"),
                                  ndmin=2)
                with open(os.path.join(app, "metrics.json")) as f:
                    metrics = json.load(f)
                keep(f"{name}_cli", {"trajectory": traj,
                                     "metrics": json.dumps(metrics)})
                print(f"{name} cli: {len(traj)} frames, "
                      f"{metrics['n_keyframes']} keyframes", flush=True)

            eng = FullSlam(DeviceCalib.from_host(calib),
                           model=drive["model"], use_dense=True,
                           **drive["engine"])
            eng.run_device(seq["packets"], seq["pkt_times_us"],
                           ins_track(seq, drive["drift_rate"]),
                           batch=drive["batch"])
            budget = drive["max_candidates"] or SlamPipeline._sweep_budget(
                eng, drive["budget_floor"])
            dev = eng.finalize_device(max_candidates=budget,
                                      **drive["finalize"])
            fsr = fullslam_record(eng, dev, seq, drive, budget)
            keep(f"{name}_fullslam", fsr)
            print(f"{name} fullslam: {fsr['n_frames']} frames, "
                  f"{fsr['kf_n']} keyframes, "
                  f"{int(fsr['cand_valid'].sum())} candidates of {budget}, "
                  f"{int(fsr['accept'].sum())} accepted; ATE "
                  f"{fsr['ate']:.4f} m", flush=True)

            if drive["live_modes"]:
                live = dict(drive, ins=True, position=False)
                origin = tuple(cfg["origin"])
                ins = cs.ins_payloads(replay_ins_txt, udp, paths["ins"],
                                      origin)
                streams = cs.live_streams(live, paths, ins)
                out[f"{name}_live_ins_payloads"] = np.frombuffer(
                    b"".join(ins), np.uint8).reshape(len(ins), 104)
                for mode in drive["live_modes"]:
                    pipe = SlamPipeline(jax_slam_config(slam))
                    r, mid, counts = record_session(
                        pipe, udp, streams, mode, seq, live, origin, margins)
                    keep(f"{name}_live_{mode}", r)
                    out[f"{name}_live_{mode}_live"] = json.dumps(counts)
                    print(f"{name} live {mode}: {r['n_frames']} frames, "
                          f"{r['n_keyframes']} keyframes, closures "
                          f"mid-session {mid}, in all {pipe.closures}, "
                          f"{r['n_landmarks']} landmarks; ATE "
                          f"{r['ate']:.4f} m; {counts}", flush=True)

    for model in cfg["models"]:
        oc = cfg["odometry"]
        seq, calib = odometry_drive(cfg, model)
        track = ins_track(seq, oc["drive"]["drift_rate"])
        dcalib = DeviceCalib.from_host(calibration.LaserCalib(*calib))
        for part, eng, batch in (
                ("fused", StreamingOdometry(dcalib, model=model,
                                            n_beams=calib.n_lasers),
                 oc["fused_batch"]),
                ("batched", StreamingOdometry(
                    dcalib, model=model, n_beams=calib.n_lasers,
                    batched=True, use_dense=True, sample_assembly=True,
                    **oc["config"]), oc["batched_batch"])):
            res = eng.run(seq["packets"], seq["pkt_times_us"], track,
                          batch=batch)
            keep(f"{model}_odometry_{part}",
                 {k: res[k] for k in ("times_us", "positions",
                                      "quaternions", "n_frames")})
            print(f"{model} odometry {part}: {res['n_frames']} frames",
                  flush=True)

    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
