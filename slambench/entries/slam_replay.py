"""Entry: full SLAM replay, `slam_run` (the per-frame `run_offline`) or
`slam_run --batched` (`run_offline_batched`), as the traffic's `stream`
says (`per_frame`, or `batched` in `batch`-packet batches).

One pass is one user run without the process start: a fresh
`SlamPipeline` of the cell's engine, the run from the pcap and the INS
log on disk, then `finalize()` (landmarks, the graph solve, the tiled
map, the corrected trajectory), its results on the host.  The pass keeps
its final map and landmarks for the check after the window, which reads
the map's voxels only then.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
from veloslam_tpu_torch.map.voxelmap import MapPatchData
from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
from veloslam_tpu_torch.utils.profiling import StageTimers

from slambench.lib import drives, port
from slambench.lib.context import replay_window
from slambench.reference import check, frames, world


@contextlib.contextmanager
def _annotated_stages(on: bool):
    """In a traced run, each of the program's StageTimers stages is also
    a profiler annotation (`slambench.stage.<name>`), so the trace names
    the idle gaps by the stage the host was in."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    orig = StageTimers.stage

    @contextlib.contextmanager
    def stage(self, name):
        with record_function("slambench.stage." + name), orig(self, name):
            yield
    StageTimers.stage = stage
    try:
        yield
    finally:
        StageTimers.stage = orig


def map_voxels(vmap):
    """(means (V, 3), counts (V,)) of every voxel of a `VoxelMap`, its
    resident and its spilled tiles."""
    vs = vmap.cfg.voxel_size
    tiles = list(vmap._patches.values()) + [
        MapPatchData.load(p) for p in vmap._spilled.values()]
    means, counts = [np.zeros((0, 3))], [np.zeros(0)]
    for t in tiles:
        n = np.maximum(t.count, 1e-12)[:, None]
        means.append((t.coords + 0.5) * vs + t.s1 / n)
        counts.append(t.count)
    return np.concatenate(means), np.concatenate(counts)


class Entry:
    frames_metric = "slam_frames_per_s"

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        ctx = self.ctx
        self.files = drives.make(ctx.config, ctx.traffic["drive_s"],
                                 ctx.seed, ctx.device, ctx.tmp)
        self.cfg = port.engine_config(ctx.config,
                                      self.files.calibration_path)
        self.one_pass()                       # the warm pass
        port.sync(ctx.device)

    def one_pass(self) -> dict:
        ctx, paths = self.ctx, self.files.paths
        self.n_pass = getattr(self, "n_pass", 0) + 1
        spill = os.path.join(ctx.tmp, "spill", str(self.n_pass))
        pipe = SlamPipeline(self.cfg, spill_dir=spill, device=ctx.device)
        if ctx.traffic["stream"] == "per_frame":
            pipe.run_offline(paths["pcap"], paths["ins"])
        else:
            pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                     batch=ctx.traffic["batch"])
        res = pipe.finalize()
        g = pipe.graph
        closures = [(int(i), int(j), g.e_t[e].astype(np.float64))
                    for e, (i, j) in enumerate(zip(g.e_i[:g.n_edges],
                                                   g.e_j[:g.n_edges]))
                    if j != i + 1]
        out = {k: res[k] for k in ("times_us", "positions", "quaternions",
                                   "n_frames", "n_keyframes", "n_closures",
                                   "n_landmarks", "keyframe_times_us",
                                   "timing")}
        out["closures"] = closures
        out["map"] = pipe.map
        out["landmarks"] = g.l_pos[:g.n_landmarks].copy()
        return out

    def window(self) -> dict:
        with _annotated_stages(self.ctx.spans.annotate):
            r = replay_window(self.ctx.seconds, self.one_pass,
                              self.ctx.spans)
        frames_done = sum(p["n_frames"] for p in r["passes"])
        r["metrics"] = {self.frames_metric: frames_done / r["window_s"]}
        r["info"] = {
            "passes": len(r["passes"]), "pass_s": r["pass_s"],
            "pass_cpu_s": r["pass_cpu_s"],
            "frames_per_pass": [p["n_frames"] for p in r["passes"]],
            "keyframes_per_pass": [p["n_keyframes"] for p in r["passes"]],
            "closures_per_pass": [p["n_closures"] for p in r["passes"]],
            "landmarks_per_pass": [p["n_landmarks"] for p in r["passes"]]}
        return r

    def check(self, result: dict) -> dict:
        pkts, times = frames.read_lidar(self.files.paths["pcap"])
        ref = frames.schedule(pkts, times, self.cfg.sensor.model)
        f = self.files
        gc = self.cfg.graph
        rules = dict(self.ctx.cell["check"],
                     keyframe_m=gc.keyframe_translation_m,
                     keyframe_deg=gc.keyframe_rotation_deg,
                     voxel_m=self.cfg.map.voxel_size,
                     landmark_radius_m=gc.landmark_cluster_radius_m)
        returns = world.Returns(pkts, times, self.cfg.sensor.model)
        rot, vert = world.laser_angles(self.cfg.sensor.model,
                                       f.calibration_path)
        refs = {}
        judged = []
        for p in result["passes"]:
            p["map_means"], p["map_counts"] = map_voxels(p.pop("map"))
            kt = tuple(int(t) for t in p["keyframe_times_us"])
            if kt not in refs:
                refs[kt] = world.keyframe_reference(
                    returns, np.asarray(kt), rot, vert, f.world, f.path,
                    f.t0_us, rules["voxel_m"], self.ctx.device)
            nums, diag = check.judge(p, ref, f.path, f.t0_us, rules)
            wn, wd = world.judge(p, refs[kt], f.world, f.path, f.t0_us,
                                 rules)
            nums.update(wn)
            diag.update(wd)
            judged.append((nums, diag))
        nums = check.worst(judged)
        nums["attempted"] = len(ref) * len(result["passes"])
        return nums
