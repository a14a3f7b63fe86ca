"""Generate live_golden_seed3.npz: the JAX package's live mode
(SlamPipeline.run_online, per frame and fast) on three drives, each
session replayed by chip_smoke.ScriptedUdp in place of UDP, for the port
to be held to.

Each drive is written as a pcap plus an INS text log (chip_smoke.
write_pipeline_drive, as bench.py::_make_drive writes it).  The session's
datagrams (chip_smoke.live_streams): with "ins", the InsPVA payloads that
the JAX package's replay_ins_txt builds from the INS log (ENU re-encoded
as LLH against chip_smoke's origin; kept here as "<drive>_ins_payloads",
so the port's replay and the card's loopback runs send the same bytes);
with "position", the pcap's position packets; then the pcap's LiDAR
packets.  The JAX SlamPipeline runs on the CPU:

    run_online(fast=...) over the scripted receiver; finalize()

  * "full": bench.py's full-SLAM drive (7 s HDL-32, seed 3,
    World.demo(3, extent=40, n_posts=40, n_walls=16), an 8 m circle at
    8 m/s, INS drifting 1 m/s) with bench._slam_cfg() at the production
    width (16384 points, 16 GN iterations, a dense-index ROI of up to
    16384 1 m voxels, 512-packet batches), per frame and fast.  Nothing
    is cut; chip_smoke.py's `live` phase replays it on the card.
  * "small": tests/test_udp_live.py's live drive (0.8 s, seed 17,
    World.demo(3), the simulator's default trajectory, the INS at truth)
    with 128-packet batches, 16384 points, 8 GN iterations and a
    32-keyframe graph (the fast mode's device finalize sized for a CPU),
    per frame and fast.
  * "gps": tests/test_udp_live.py's grounding drive (0.6 s, seed 11,
    World.demo(2)), no INS: the hour clock is grounded by the pcap's
    position packet; 128-packet batches, a 32-keyframe graph; per frame
    only (the fast stream needs an INS track).

The npz keeps each session's results under "<drive>_<mode>_<field>"
(gen_torch_perframe_golden.record: times, trajectory, keyframes, the
closures accepted during the stream and in all, landmarks, per-tile map
counts, ATE; run_online's own trajectory before finalize,
"stream_times_us" and "stream_positions"; "assoc_margin", the smallest
distance of a decision of finalize's greedy landmark clustering from its
radius, chip_smoke.assoc_margin) and, as JSON under
"<drive>_<mode>_live", the INS and GPS
health, the IMU log's length and live_stats' counts; "config" holds the
drives with their SlamConfig as dataclasses.asdict, so the port rebuilds
them from this one file and needs no jax.

Run from the repository root (JAX on the CPU, ~4 minutes, a few GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_live_golden.py
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "live_golden_seed3.npz")
ORIGIN = (31.0, 121.5, 0.0)


def golden_config() -> dict:
    """The drives, their modes and their SlamConfigs, as plain JSON
    values."""
    for path in (REPO, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from bench import _slam_cfg
    from gen_torch_perframe_golden import golden_config as per_frame

    full = {d["name"]: d for d in per_frame()["drives"]}["full"]
    base = _slam_cfg()
    small = base.replace(
        pipeline=dataclasses.replace(base.pipeline, packets_per_batch=128),
        registration=dataclasses.replace(base.registration, max_points=16384,
                                         max_iterations=8),
        graph=dataclasses.replace(base.graph, max_keyframes=32))
    gps = small.replace(registration=base.registration)

    def as_dict(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("mesh")          # the multi-device layout: not ported yet
        return json.loads(json.dumps(d))

    return {"model": "hdl32", "origin": list(ORIGIN), "drives": [
        {**full, "ins": True, "position": False,
         "modes": ["per_frame", "fast"]},
        {"name": "small", "duration_s": 0.8, "seed": 17,
         "world": {"seed": 3}, "circle": None, "drift_rate": 0.0,
         "ins": True, "position": False, "modes": ["per_frame", "fast"],
         "slam": as_dict(small)},
        {"name": "gps", "duration_s": 0.6, "seed": 11,
         "world": {"seed": 2}, "circle": None, "drift_rate": 0.0,
         "ins": False, "position": True, "modes": ["per_frame"],
         "slam": as_dict(gps)},
    ]}


def measure_margins() -> list:
    """Wrap the JAX package's associate_and_add so that each call appends
    chip_smoke.assoc_margin of its clustering decisions to the returned
    list (the caller clears it between runs)."""
    import chip_smoke as cs
    from veloslam_tpu.graph import landmark_assoc
    margins = []
    associate = landmark_assoc.associate_and_add

    def measured(graph, posts, radius=1.0, **kw):
        q, t = graph.poses()
        margins.append(cs.assoc_margin(q, t, posts, radius))
        return associate(graph, posts, radius=radius, **kw)

    landmark_assoc.associate_and_add = measured
    return margins


def record_session(pipe, udp, streams: dict, mode: str, seq, drive: dict,
                   origin, margins: list) -> tuple:
    """One scripted session of the JAX pipeline `pipe` (run_online over
    chip_smoke.ScriptedUdp + finalize): (its record, the closures
    accepted before finalize, the live counts)."""
    import chip_smoke as cs
    from gen_torch_perframe_golden import record
    margins.clear()
    live, mid, res = cs.run_live_scripted(pipe, udp, streams,
                                          mode == "fast", origin)
    r = record(pipe, res, mid, seq, drive)
    r["stream_times_us"] = live["times_us"]
    r["stream_positions"] = live["positions"]
    r["assoc_margin"] = min(margins, default=np.inf)
    return r, mid, cs.live_counts(pipe, live, res)


def main():
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from gen_torch_pipeline_golden import jax_slam_config
    from veloslam_tpu.apps.replay import replay_ins_txt
    from veloslam_tpu.io import udp
    from veloslam_tpu.runtime.pipeline import SlamPipeline

    margins = measure_margins()
    cfg = golden_config()
    out = {"config": json.dumps(cfg)}
    for drive in cfg["drives"]:
        name = drive["name"]
        with tempfile.TemporaryDirectory() as d:
            paths, seq = cs.write_pipeline_drive(drive, cfg["model"], d)
            ins = (cs.ins_payloads(replay_ins_txt, udp, paths["ins"],
                                   ORIGIN) if drive["ins"] else [])
            streams = cs.live_streams(drive, paths, ins)
        out[f"{name}_ins_payloads"] = np.frombuffer(
            b"".join(ins), np.uint8).reshape(len(ins), 104)
        for mode in drive["modes"]:
            pipe = SlamPipeline(jax_slam_config(drive["slam"]))
            r, mid, counts = record_session(pipe, udp, streams, mode, seq,
                                            drive, ORIGIN, margins)
            for k, v in r.items():
                out[f"{name}_{mode}_{k}"] = v
            out[f"{name}_{mode}_live"] = json.dumps(counts)
            print(f"{name} {mode}: {r['n_frames']} frames "
                  f"({int(r['registered'].sum())} registered), "
                  f"{r['n_keyframes']} keyframes, closures mid-session "
                  f"{mid}, in all {pipe.closures}, {r['n_landmarks']} "
                  f"landmarks; ATE {r['ate']:.4f} m (raw INS "
                  f"{r['ate_raw_ins']:.3f} m); {counts}", flush=True)
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
