"""Per-stage wall-clock counters.

A copy of veloslam_tpu/utils/profiling.py::StageTimers.  Work on the card
is queued asynchronously, so a stage's wall time is its enqueue time
until something waits on the device; `sync` (e.g. torch.cuda.synchronize)
is called at each stage's end, for runs that measure each stage's own
time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


class StageTimers:
    """Accumulates wall-clock per named stage; cheap enough to always on."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self._total = defaultdict(float)
        self._count = defaultdict(int)
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            dt = time.perf_counter() - t0
            self._total[name] += dt
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self._total[k], "count": self._count[k],
                    "mean_ms": 1e3 * self._total[k] / max(self._count[k], 1)}
                for k in sorted(self._total)}

    def report(self) -> str:
        lines = [f"{k:24s} n={v['count']:6d}  mean={v['mean_ms']:8.2f} ms  "
                 f"total={v['total_s']:7.2f} s"
                 for k, v in self.summary().items()]
        return "\n".join(lines)
