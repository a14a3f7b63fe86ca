"""Per-stage wall-clock counters and device traces.

A copy of veloslam_tpu/utils/profiling.py::StageTimers, and its
`device_trace` on torch.profiler.  Work on the card
is queued asynchronously, so a stage's wall time is its enqueue time
until something waits on the device; `sync` (e.g. torch.cuda.synchronize)
is called at each stage's end, for runs that measure each stage's own
time.

Stages nest: each keeps its own seconds (`self_s`, its seconds less its
child stages'), so the stages' `self_s` add up to the time spent inside
any stage.  Code with no pipeline at hand records into the timers bound
by `recording` (`SlamPipeline` binds its own while its entry points
run): `sync_span` wraps one operation that blocks the host on the card
in a stage `sync.<innermost open stage>` there, so the count of `sync.*`
stages is the number of such waits and their seconds the host's time
blocked in them.  While a torch profiler records, every stage is also
the annotation `veloslam.<name>` on the profiler's clock, beside the
card's kernels.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Dict, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
# A CPU-side record on the profiler's clock: a user annotation
# (`record_function`) would also lay a range over the card's own
# activity in the trace, and readers of that activity would count it as
# device work.
_Annotation = torch._C._profiler._RecordFunctionFast
_NOTHING = contextlib.nullcontext()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "veloslam_stage_timers", default=None)
SYNC_PREFIX = "sync."
UNSTAGED = "unstaged"


class _Stage:
    """One open stage of a StageTimers."""

    __slots__ = ("timers", "name", "t0", "child_s", "note")

    def __init__(self, timers: "StageTimers", name: str):
        self.timers = timers
        self.name = name

    def __enter__(self):
        self.note = None
        if _profiler_enabled():
            self.note = _Annotation("veloslam." + self.name)
            self.note.__enter__()
        self.child_s = 0.0
        self.timers._open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = self.timers
        try:
            # A sync span's operation has waited already.
            if t._sync is not None and not self.name.startswith(SYNC_PREFIX):
                t._sync()
        finally:
            dt = time.perf_counter() - self.t0
            t._open.pop()
            acc = t._acc.get(self.name)
            if acc is None:
                acc = t._acc[self.name] = [0.0, 0.0, 0]
            acc[0] += dt                  # total
            acc[1] += dt - self.child_s   # own
            acc[2] += 1
            if t._open:
                t._open[-1].child_s += dt
            if self.note is not None:
                self.note.__exit__(*exc)
        return False


class StageTimers:
    """Accumulates wall-clock per named stage; cheap enough to always on."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self._acc: Dict[str, list] = {}   # name: [total s, own s, count]
        self._sync = sync
        self._open = []

    def stage(self, name: str):
        return _Stage(self, name)

    def innermost(self) -> Optional[str]:
        """The name of the innermost open stage, None outside every
        stage."""
        return self._open[-1].name if self._open else None

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": total, "count": count,
                    "mean_ms": 1e3 * total / max(count, 1), "self_s": own}
                for k, (total, own, count) in sorted(self._acc.items())}

    def report(self) -> str:
        lines = [f"{k:24s} n={v['count']:6d}  mean={v['mean_ms']:8.2f} ms  "
                 f"total={v['total_s']:7.2f} s  self={v['self_s']:7.2f} s"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def recording(timers):
    """Bind `timers` as the recorder of `sync_span` inside the region
    (nests; the previous binding returns after it)."""
    token = _CURRENT.set(timers)
    try:
        yield timers
    finally:
        _CURRENT.reset(token)


def sync_span(on):
    """The stage `sync.<innermost open stage>` around one operation that
    blocks the host on the card (a readback, `.item()`, `int()` of a card
    tensor, an upload from pageable memory, `nonzero` or a boolean mask
    on the card).  `on` is the tensor or device the operation waits on:
    nothing is recorded unless it is a CUDA one and a recorder is bound,
    nor inside another sync span.  The operation runs as it would
    without the span."""
    rec = _CURRENT.get()
    if rec is None:
        return _NOTHING
    if isinstance(on, torch.Tensor):
        on_card = on.is_cuda
    elif isinstance(on, torch.device):
        on_card = on.type == "cuda"
    else:
        on_card = isinstance(on, str) and torch.device(on).type == "cuda"
    if not on_card:
        return _NOTHING
    inner = rec.innermost()
    if inner is not None and inner.startswith(SYNC_PREFIX):
        return _NOTHING
    return rec.stage(SYNC_PREFIX + (inner or UNSTAGED))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record the region's CPU activity, and the card's where CUDA is
    available, into `log_dir` as a Chrome trace (trace.json, open it in
    chrome://tracing or Perfetto); nothing when log_dir is None.  The
    stages run inside it appear as `veloslam.<name>` on the same
    timeline."""
    if log_dir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
