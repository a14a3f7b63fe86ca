"""Pieces of veloslam_tpu/runtime/pipeline.py::SlamPipeline that the
device full-SLAM path needs; the host pipeline itself (mirror, residual
sweep, map rebuild) is not ported yet."""

from __future__ import annotations

import math


def sweep_budget(eng, floor: int) -> int:
    """End-of-stream closure-verification budget (SlamPipeline.
    _sweep_budget): ~half the engine's frame estimate for the recording
    (≈ 2 candidates per keyframe at 2 m spacing), power-of-two bucketed,
    at least `floor`, capped at 256; the ring capacity stands in when the
    engine has no estimate."""
    est = getattr(eng, "_est_frames", None) or eng.ring.capacity
    b = 1 << max(int(math.ceil(math.log2(max(est // 2, 1)))), 0)
    return int(min(max(floor, b), 256))
