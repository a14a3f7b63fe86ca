"""Reduction of a traced window: the device's activity from the profiler
(kernels, copies and fills on the card) and the harness's annotations on
the host.

The window is the `slambench.window` annotation.  Busy time is the union
of the device's intervals inside it; a launch is a kernel event (copies
and fills are not launches); an idle gap is a stretch of the window with
nothing on the device, named by the innermost harness span open on the
host at its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "slambench.window"


class Trace(NamedTuple):
    names: List[str]            # device events
    kind: np.ndarray            # index into DEVICE_KINDS
    t0: np.ndarray              # ns
    t1: np.ndarray
    ann_names: List[str]        # host annotations
    ann_t0: np.ndarray
    ann_t1: np.ndarray
    w0: int                     # window, ns
    w1: int


def from_events(device: List[Tuple[str, str, int, int]],
                annotations: List[Tuple[str, int, int]]) -> Trace:
    """A Trace from (activity, name, start ns, end ns) device events and
    (name, start ns, end ns) host annotations; the window is the
    annotation named WINDOW, else the span of all events."""
    dev = [e for e in device if e[0] in DEVICE_KINDS]
    win = [a for a in annotations if a[0] == WINDOW]
    if win:
        w0, w1 = win[0][1], win[0][2]
    else:
        ts = [e[2] for e in dev] + [a[1] for a in annotations]
        te = [e[3] for e in dev] + [a[2] for a in annotations]
        w0, w1 = (min(ts), max(te)) if ts else (0, 0)
    return Trace(
        names=[e[1] for e in dev],
        kind=np.array([DEVICE_KINDS.index(e[0]) for e in dev], np.int64),
        t0=np.array([e[2] for e in dev], np.int64),
        t1=np.array([e[3] for e in dev], np.int64),
        ann_names=[a[0] for a in annotations],
        ann_t0=np.array([a[1] for a in annotations], np.int64),
        ann_t1=np.array([a[2] for a in annotations], np.int64),
        w0=int(w0), w1=int(w1))


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof) -> Trace:
    """Read a finished torch.profiler.profile's events once: the card's
    events (a copy or a fill by its name, else a kernel) and the
    harness's annotations on the host."""
    device, annotations = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns()
        on_card = str(e.device_type()).endswith("CUDA")
        if name.startswith("slambench."):
            if not on_card:
                annotations.append((name, t0, t0 + e.duration_ns()))
        elif on_card:
            device.append((_device_kind(name), name, t0,
                           t0 + e.duration_ns()))
    return from_events(device, annotations)


def _clipped(tr: Trace) -> Tuple[np.ndarray, np.ndarray]:
    a = np.clip(tr.t0, tr.w0, tr.w1)
    b = np.clip(tr.t1, tr.w0, tr.w1)
    keep = b > a
    return a[keep], b[keep]


def _union(a: np.ndarray, b: np.ndarray) -> List[Tuple[int, int]]:
    order = np.argsort(a, kind="stable")
    out: List[Tuple[int, int]] = []
    for s, e in zip(a[order].tolist(), b[order].tolist()):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def window_s(tr: Trace) -> float:
    return (tr.w1 - tr.w0) * 1e-9


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which something ran on the device."""
    return sum(e - s for s, e in _union(*_clipped(tr))) * 1e-9


def idle_share(tr: Trace) -> Optional[float]:
    w = window_s(tr)
    if w <= 0 or len(tr.t0) == 0:
        return None
    return 1.0 - busy_s(tr) / w


def launches(tr: Trace) -> int:
    """Kernel events that start inside the window."""
    return int(((tr.t0 >= tr.w0) & (tr.t0 < tr.w1) & (tr.kind == 0)).sum())


def kernel_seconds(tr: Trace, name_part: str) -> Tuple[float, int]:
    """(device seconds, calls) of the kernels whose name contains
    `name_part`, inside the window."""
    s, n = 0, 0
    for i in np.nonzero((tr.kind == 0) & (tr.t0 >= tr.w0)
                        & (tr.t0 < tr.w1))[0]:
        if name_part in tr.names[i]:
            s += int(tr.t1[i] - tr.t0[i])
            n += 1
    return s * 1e-9, n


def device_ops(tr: Trace, n: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds]]."""
    tot: Dict[str, int] = defaultdict(int)
    inside = (tr.t0 >= tr.w0) & (tr.t0 < tr.w1)
    for i in np.nonzero(inside)[0]:
        tot[tr.names[i][:120]] += int(tr.t1[i] - tr.t0[i])
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in top]


def _host_at(tr: Trace, t: int) -> str:
    """The innermost harness span open at t (the shortest that covers
    it), without its prefix."""
    cover = (tr.ann_t0 <= t) & (tr.ann_t1 >= t)
    best, best_len = None, None
    for i in np.nonzero(cover)[0]:
        if tr.ann_names[i] == WINDOW:
            continue
        ln = tr.ann_t1[i] - tr.ann_t0[i]
        if best_len is None or ln < best_len:
            best, best_len = tr.ann_names[i], ln
    return best[len("slambench."):] if best else "window"


def idle_gaps(tr: Trace, n: int = 10) -> List[list]:
    """The longest idle stretches of the window: [[what the host was
    doing, seconds]]."""
    busy = _union(*_clipped(tr))
    gaps = []
    prev = tr.w0
    for s, e in busy + [(tr.w1, tr.w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_host_at(tr, (a + b) // 2), (b - a) * 1e-9]
            for a, b in gaps[:n]]
