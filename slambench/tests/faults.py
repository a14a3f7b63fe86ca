"""The control and the planted faults that `correct` has to catch.

CONTROL breaks the guarantee the configurations state that each frame's
pose is registered (GICP) and not the INS prior: every call of the
port's `gicp.register_batch` runs 0 Gauss-Newton iterations, so the
frames' registration and the closure verification return their priors.  The faults
break the timed path underneath a run:

  step_unchanged     the step (the per-frame `process_packets`, and the
                     batched stream's `StreamingOdometry.feed`, which
                     `FullSlam` inherits) returns with its state unchanged
  half_batch         each batch is cut to its first half
  answer_altered     the last frame's position is moved 10 m (more than
                     the position limit) where the results are produced
  map_emptied        `finalize`'s map rebuild integrates no scan
                     (`SlamPipeline.rebuild_map` leaves an empty map)
  landmarks_skipped  `finalize` adds no landmark
                     (`add_landmark_observations` does nothing)

(The exchange between chips is not a fault these one-chip cells can
have.)  On the card, at a cell's own size:

    python3 -m slambench.tests.faults --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault control|step_unchanged|...]

runs the cell under the break for each seed in one process and prints
each run's result.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def _patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def control():
    from veloslam_tpu_torch.registration import gicp

    def wrap(orig):
        def register_batch(*a, **k):
            k["iterations"] = 0
            return orig(*a, **k)
        return register_batch
    return _patched(gicp, "register_batch", wrap)


def step_unchanged():
    from veloslam_tpu_torch.runtime.odometry import StreamingOdometry
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(
        StreamingOdometry, "feed", lambda orig: lambda self, *a, **k: None))
    stack.enter_context(_patched(
        SlamPipeline, "process_packets",
        lambda orig: lambda self, *a, **k: 0))
    return stack


def half_batch():
    from veloslam_tpu_torch.runtime.odometry import StreamingOdometry
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    def feed(orig):
        def f(self, pkts, times_us, track_window):
            n = len(pkts) // 2
            return orig(self, pkts[:n], times_us[:n], track_window)
        return f

    def process(orig):
        def f(self, pkts, times_us, *a, **k):
            n = len(pkts) // 2
            return orig(self, pkts[:n], times_us[:n])
        return f
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(StreamingOdometry, "feed", feed))
    stack.enter_context(_patched(SlamPipeline, "process_packets", process))
    return stack


def answer_altered():
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    def alter(res):
        pos = np.array(res["positions"], copy=True)
        if len(pos):
            pos[-1, 0] += 10.0
        res["positions"] = pos
        return res

    def wrap(orig):
        return lambda self, *a, **k: alter(orig(self, *a, **k))
    return _patched(SlamPipeline, "results", wrap)


def map_emptied():
    from veloslam_tpu_torch.map.voxelmap import VoxelMap
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    def rebuild(orig):
        def f(self):
            self.map = VoxelMap(self.cfg.map, spill_dir=self.map.spill_dir,
                                device=self.device)
        return f
    return _patched(SlamPipeline, "rebuild_map", rebuild)


def landmarks_skipped():
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    return _patched(SlamPipeline, "add_landmark_observations",
                    lambda orig: lambda self: (0, 0))


BREAKS = {"control": control, "step_unchanged": step_unchanged,
          "half_batch": half_batch, "answer_altered": answer_altered,
          "map_emptied": map_emptied, "landmarks_skipped": landmarks_skipped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="control", choices=sorted(BREAKS))
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from slambench import run as runmod
    rc = 0
    for seed in a.seeds:
        print(f"# {a.fault} {a.workload} seed={seed}", file=sys.stderr)
        with BREAKS[a.fault]():
            rc |= runmod.run(a.workload, seed, a.seconds, False)
    return rc


if __name__ == "__main__":
    sys.exit(main())
