"""The readers of the per-layer metrics that come from the program's
nested StageTimers and sync spans, on canned passes: each the median
over the window's passes, a pass that lacks a stage, and a program whose
timers give none of it (no `self_s`), which reads as no value."""

import types

import pytest

from slambench.lib import registry

SPAN_READERS = {
    "pass.inputs_s": ("read_inputs",),
    "frame.host_prep_s": ("frames_to_host", "frame_prep", "frame_store"),
    "frame.roi_s": ("roi",),
    "closure.propose_s": ("scan_context", "loop_propose"),
    "closure.map_reintegrate_s": ("map_reintegrate",),
    "finalize.map_rebuild_s": ("map_rebuild",),
}
NEW = list(SPAN_READERS) + ["sync.per_frame", "sync.wait_s",
                            "pass.untraced_s"]


def _stage(total, count=1, own=None):
    return {"total_s": total, "count": count,
            "mean_ms": 1e3 * total / max(count, 1),
            "self_s": total if own is None else own}


def _ctx(passes, pass_s):
    return types.SimpleNamespace(result={"passes": passes,
                                         "pass_s": pass_s})


def _pass(scale, n_frames=100, drop=()):
    """A pass's timing: a frame stage around its children, two sync
    spans, finalize's map stages; `drop` leaves stages out."""
    t = {
        "read_inputs": _stage(0.5 * scale),
        "frames_to_host": _stage(0.1 * scale, 50),
        "frame": _stage(6.0 * scale, n_frames, own=0.2 * scale),
        "frame_prep": _stage(0.3 * scale, 2 * n_frames),
        "roi": _stage(1.0 * scale, n_frames, own=0.9 * scale),
        "register": _stage(2.0 * scale, n_frames, own=1.5 * scale),
        "sync.roi": _stage(0.1 * scale, n_frames),
        "sync.register": _stage(0.5 * scale, 3 * n_frames),
        "frame_store": _stage(0.05 * scale, n_frames),
        "scan_context": _stage(0.2 * scale, 50),
        "loop_propose": _stage(0.4 * scale, 5),
        "map_downdate": _stage(3.0 * scale, 6, own=0.1 * scale),
        "map_reintegrate": _stage(1.9 * scale, 5),
        "map_rebuild": _stage(1.0 * scale, 1),
        "map_update": _stage(1.75 * scale, n_frames),
    }
    for k in drop:
        del t[k]
    return {"n_frames": n_frames, "timing": t}


def _read(name, ctx):
    return registry.metric(name).read(ctx)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_take_the_median_of_their_stages(name):
    stages = SPAN_READERS[name]
    passes = [_pass(1.0), _pass(3.0), _pass(2.0)]
    want = sum(passes[2]["timing"][s]["total_s"] for s in stages)
    assert _read(name, _ctx(passes, [20.0, 22.0, 21.0])) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_on_a_pass_that_lacks_a_stage(name):
    """A pass that lacks one of the stages sums the rest; a pass that
    lacks them all does not count."""
    stages = SPAN_READERS[name]
    some = _pass(1.0, drop=stages[:1])
    none = _pass(5.0, drop=stages)
    whole = _pass(2.0)
    got = _read(name, _ctx([some, none, whole], [1.0, 1.0, 1.0]))
    parts = [sum(p["timing"][s]["total_s"] for s in stages
                 if s in p["timing"]) for p in (some, whole)]
    if len(stages) == 1:
        assert got == pytest.approx(parts[1])
    else:
        assert got == pytest.approx(0.5 * (parts[0] + parts[1]))


def test_sync_readers():
    passes = [_pass(1.0, n_frames=100), _pass(2.0, n_frames=200),
              _pass(4.0, n_frames=50)]
    ctx = _ctx(passes, [1.0, 2.0, 3.0])
    assert _read("sync.per_frame", ctx) == pytest.approx(4.0)
    assert _read("sync.wait_s", ctx) == pytest.approx(0.6 * 2.0)
    bare = _pass(1.0, drop=("sync.roi", "sync.register"))
    assert _read("sync.per_frame", _ctx([bare], [1.0])) == 0.0
    assert _read("sync.wait_s", _ctx([bare], [1.0])) == 0.0
    assert _read("sync.per_frame",
                 _ctx([dict(bare, n_frames=0)], [1.0])) is None


def test_untraced_is_the_pass_less_every_stage_own_seconds():
    passes = [_pass(1.0), _pass(2.0), _pass(1.5)]
    own = [sum(v["self_s"] for v in p["timing"].values()) for p in passes]
    pass_s = [own[0] + 0.25, own[1] + 0.75, own[2] + 0.5]
    assert _read("pass.untraced_s", _ctx(passes, pass_s)) == \
        pytest.approx(0.5)
    # A pass the harness has no seconds for does not count.
    assert _read("pass.untraced_s", _ctx(passes, pass_s[:1])) == \
        pytest.approx(0.25)


@pytest.mark.parametrize("name", NEW)
def test_no_value_from_timers_without_the_new_spans(name):
    """Timers with only the stages the first benchmark read, and no
    self_s: every new metric reads None and none raises."""
    old = {"timing": {k: {"total_s": 1.0, "count": 1, "mean_ms": 1e3}
                      for k in ("decode", "compensate", "assemble", "frame",
                                "register", "map_update", "loop_verify",
                                "graph_solve", "map_downdate", "landmarks")},
           "n_frames": 199}
    assert _read(name, _ctx([old, old], [20.0, 21.0])) is None
    assert _read(name, _ctx([], [])) is None
