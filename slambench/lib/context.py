"""What an entry and a metric reader are handed: the cell, its
configuration and traffic, the seed, the device, a scratch directory for
the run's files, the spans, and what the window and the trace left."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from slambench.lib.spans import Spans


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any
    tmp: str
    spans: Spans
    trace: Any = None                  # lib.trace.Trace of a traced run
    result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    probes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    window_from: int = 0               # spans before this index: set-up

    def window_spans(self, name: str) -> list:
        """The spans named `name` that the window recorded."""
        return [s for s in self.spans.items[self.window_from:]
                if s.name == name]


def replay_window(seconds: float, one_pass, spans: Spans) -> Dict[str, Any]:
    """Passes back to back: the window opens when the first starts and
    closes at the end of the first pass that ends after `seconds`."""
    passes: List[dict] = []
    cpu: List[float] = []
    t0 = time.perf_counter()
    while True:
        c0 = time.process_time()
        with spans.span("pass"):
            passes.append(one_pass())
        cpu.append(time.process_time() - c0)
        if time.perf_counter() - t0 >= seconds:
            break
    return {"passes": passes, "window_s": time.perf_counter() - t0,
            "pass_s": [s.seconds for s in spans.named("pass")[-len(passes):]],
            "pass_cpu_s": cpu}


def median(xs: List[float]) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def stage_seconds(ctx, stages) -> Optional[float]:
    """The median over the window's passes of the seconds a pass spent in
    the program's StageTimers `stages` (summed); None where no pass ran
    any of them."""
    per_pass = [sum(p["timing"][s]["total_s"] for s in stages
                    if s in p["timing"])
                for p in ctx.result.get("passes", [])
                if any(s in p.get("timing", {}) for s in stages)]
    return median(per_pass)
