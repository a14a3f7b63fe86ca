"""Where the PyTorch port's full-SLAM time goes on one CUDA card.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_fullslam.py              # device full SLAM, then the
                                             # user pipeline
    python3 profile_fullslam.py pipeline     # the user pipeline only

Device full SLAM: chip_smoke.py's full-SLAM drive (bench.py's 7 s loop
drive at the production width) once to warm up, then each finalize stage
timed alone (propose, verify, solve; median of 3, synchronized) and
torch.profiler over the stream and each stage.  For each it prints the
kernel launches, the device time, the largest items and what
synchronizes the host; the full tables go to
chiprun_out/profile_<name>.txt.

The user pipeline: chip_smoke.py's `pipeline` drive (the same drive as a
pcap + INS log through SlamPipeline.run_offline_batched + finalize) once
to warm up; the host input stages (INS log, pcap read, GPS grounding)
timed alone; then one run under torch.profiler with every pipeline
stage marked, synchronized at each stage's end: per stage its wall time,
the device time of the kernels it launched, its kernel launches and its
host-device synchronizations and copies.

It checks nothing: chip_smoke.py holds both paths to the JAX goldens.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def _sync_sources(prof) -> dict:
    """Host-device synchronizations and copies in a trace, keyed by the
    outermost and the innermost operator around them."""
    out = {}
    for e in prof.events():
        if "Synchronize" not in e.name and "Memcpy" not in e.name:
            continue
        chain = []
        p = e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        key = (f"{e.name} <- {chain[-1] if chain else '-'}"
               f" / {chain[0] if chain else '-'}")
        out[key] = out.get(key, 0) + 1
    return out


def profile_fullslam(device) -> None:
    from torch.profiler import ProfilerActivity, profile

    from veloslam_tpu_torch.runtime import devfinalize as dv
    from veloslam_tpu_torch.runtime.pipeline import sweep_budget
    gold = np.load(cs.FULLSLAM_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["full"]
    fin = drive["finalize"]
    seq, track, engine = cs._fullslam_drive(device, drive, cfg["model"])
    cs.run_fullslam(seq, track, engine(), drive, cfg["budget_floor"])
    eng = engine()
    out_dir = os.path.join(cs.REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        eng.run_device(seq["packets"], seq["pkt_times_us"], track,
                       batch=drive["batch"])
        torch.cuda.synchronize()
    traces = {"stream": prof}

    r, st = eng.ring, eng.state
    K = r.capacity
    budget = sweep_budget(eng, cfg["budget_floor"])
    info = [dv.device_vector(fin[k], device)
            for k in ("odom_info", "closure_info")]

    def propose():
        return dv.propose_closures(
            r.desc[:K], r.q[:K], r.t[:K], r.n, min_score=fin["min_score"],
            radius=fin["radius"], min_gap=fin["min_gap"],
            max_candidates=budget, use_scan_context=fin["use_scan_context"])

    cand = propose()

    def verify():
        return dv.verify_closures_device(
            r.pts[:K], r.msk[:K], cand, voxel_size=fin["voxel_size"],
            capacity=fin["capacity"],
            reassociate_every=dv.VERIFY_REASSOCIATE_EVERY)

    meas = verify()

    def solve():
        return dv.solve_and_correct(
            r.q[:K], r.t[:K], r.time_rel_s[:K], r.n, cand, *meas, *info,
            st.traj_q, st.traj_t, st.traj_time, st.n_frames,
            gn_iterations=fin["gn_iterations"])

    for name, fn in (("propose", propose), ("verify", verify),
                     ("solve", solve)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[profile] {name}: {np.median(times) * 1e3:.1f} ms wall "
              f"(median of 3, synchronized)", flush=True)
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        traces[name] = prof
    _report(traces, out_dir)


def _report(traces: dict, out_dir: str) -> None:
    for name, prof in traces.items():
        ka = prof.key_averages()
        calls = {e.key: e.count for e in ka}
        table = ka.table(sort_by="device_time_total", row_limit=40)
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(table)
        busy = cs._kernel_us(prof) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
        print(f"[profile] {name}: cudaLaunchKernel "
              f"{calls.get('cudaLaunchKernel', 0)}, device busy {busy:.3f} "
              f"ms; top: " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top), flush=True)
        print(f"[profile] {name} syncs/copies: {_sync_sources(prof)}",
              flush=True)


def _stage_of(e) -> str:
    """The outermost pipeline stage range around a profiler event."""
    stage = "-"
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("stage:"):
            stage = p.name[6:]
        p = p.cpu_parent
    return stage


def profile_pipeline(device, name: str = "full") -> None:
    """`name`: the golden drive ("small" rehearses this on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.io.pcap import read_lidar_packets
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    from veloslam_tpu_torch.utils.profiling import StageTimers

    class MarkedStages(StageTimers):
        """Stage timers that also mark each stage in the trace."""

        @contextlib.contextmanager
        def stage(self, name: str):
            with record_function(f"stage:{name}"), super().stage(name):
                yield

    gold = np.load(cs.PIPELINE_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    cuda = device.type == "cuda"
    out_dir = os.path.join(cs.REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = cs.write_pipeline_drive(drive, cfg["model"], tmp)
        cs.run_pipeline(paths, drive, device)                # warm-up
        probe = SlamPipeline(SlamConfig.from_dict(drive["slam"]),
                             device=device)
        pkts, times, _ = read_lidar_packets(paths["pcap"])
        for stage, fn in (
                ("ins_load", lambda: probe.feed_ins_txt(paths["ins"])),
                ("pcap_read", lambda: read_lidar_packets(paths["pcap"])),
                ("gps_ground", lambda: probe._ground_offline_times(
                    paths["pcap"], pkts, times))):
            t0 = time.perf_counter()
            fn()
            print(f"[profile] pipeline {stage}: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host only)",
                  flush=True)
        acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
        timers = MarkedStages(sync=torch.cuda.synchronize if cuda else None)
        with profile(activities=acts) as prof:
            _, res, wall = cs.run_pipeline(paths, drive, device, timers)
    per = {}
    for e in prof.events():
        st = per.setdefault(_stage_of(e), {"launches": 0, "syncs": {},
                                           "device_ms": 0.0})
        if e.name.startswith("cudaLaunchKernel"):
            st["launches"] += 1
        if "Synchronize" in e.name or "Memcpy" in e.name:
            st["syncs"][e.name] = st["syncs"].get(e.name, 0) + 1
        if e.device_type == DeviceType.CPU:     # its own kernels' time
            st["device_ms"] += e.self_device_time_total / 1e3
    print(f"[profile] pipeline run under the profiler: {wall:.3f} s wall, "
          f"{res['n_frames']} frames", flush=True)
    for stage, v in sorted(res["timing"].items()):
        st = per.get(stage, {"launches": 0, "syncs": {}, "device_ms": 0.0})
        print(f"[profile] pipeline {stage}: {v['total_s'] * 1e3:.1f} ms wall "
              f"(synchronized at its end), device {st['device_ms']:.2f} ms "
              f"in its kernels, {st['launches']} kernel launches, "
              f"syncs/copies {st['syncs']}", flush=True)
    rest = per.get("-", {"launches": 0, "syncs": {}})
    print(f"[profile] pipeline outside the stages: {rest['launches']} "
          f"kernel launches, syncs/copies {rest['syncs']}", flush=True)
    with open(os.path.join(out_dir, "profile_pipeline.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="device_time_total",
                                          row_limit=60))


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    device = torch.device("cuda", 0)
    if sys.argv[1:] != ["pipeline"]:
        profile_fullslam(device)
    profile_pipeline(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
