"""Per-pass readings of the program's StageTimers beyond one stage's
seconds: the `sync.*` spans (one count per host-card synchronization,
their seconds the host's time blocked in them) and each stage's own
seconds (`self_s`, less its nested stages').  A pass counts only where
its timing has `self_s`, the mark of timers that record both; a program
without them gives no value."""

from __future__ import annotations

from typing import Callable, Optional

from slambench.lib.context import median

SYNC_PREFIX = "sync."


def nested(timing: dict) -> bool:
    """The timing of StageTimers that know nesting and sync spans."""
    return any(isinstance(v, dict) and "self_s" in v
               for v in timing.values())


def syncs(timing: dict) -> tuple:
    """(count, seconds) of the pass's sync spans."""
    spans = [v for k, v in timing.items() if k.startswith(SYNC_PREFIX)]
    return (sum(v["count"] for v in spans),
            sum(v["total_s"] for v in spans))


def own_seconds(timing: dict) -> float:
    """The seconds the pass spent inside any stage: the sum of every
    stage's own seconds."""
    return sum(v["self_s"] for v in timing.values()
               if isinstance(v, dict) and "self_s" in v)


def per_pass(ctx, value: Callable[[dict, Optional[float]], float]
             ) -> Optional[float]:
    """The median over the window's passes of value(pass, pass seconds),
    over the passes whose timing is nested; None where there is none."""
    passes = ctx.result.get("passes", [])
    pass_s = ctx.result.get("pass_s") or []
    vals = [value(p, pass_s[i] if i < len(pass_s) else None)
            for i, p in enumerate(passes) if nested(p.get("timing", {}))]
    vals = [v for v in vals if v is not None]
    return median(vals)
