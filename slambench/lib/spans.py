"""The harness's spans: a name, a start and an end on the host's
monotonic clock, and a few numbers, kept in memory.  In a traced run each
span is also a profiler annotation (`slambench.<name>`), so the trace can
say what the host was doing while the card sat idle."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    attrs: Dict[str, float]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self, annotate: bool = False):
        self.items: List[Span] = []
        self.annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function("slambench." + name)
        with ctx:
            t0 = time.perf_counter()
            try:
                yield attrs
            finally:
                self.items.append(Span(name, t0, time.perf_counter(),
                                       attrs))

    def named(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]
