"""The reader of `map.merge_s`, the seconds a pass spends merging scans
into the map's tiles (StageTimers `map_merge`, nested in the map stages),
on canned passes: the median over the window's passes, a pass without
the stage, and a program whose timers have no such stage."""

import pytest

from slambench.tests.test_slambench_readers import _ctx, _pass, _read, _stage


def _merge_pass(scale, n_frames=100, merge=True):
    p = _pass(scale, n_frames)
    if merge:
        p["timing"]["map_merge"] = _stage(0.8 * scale, 20 * n_frames)
    return p


def test_map_merge_reads_the_median_of_its_stage():
    passes = [_merge_pass(1.0), _merge_pass(3.0), _merge_pass(2.0)]
    ctx = _ctx(passes, [20.0, 22.0, 21.0])
    assert _read("map.merge_s", ctx) == pytest.approx(0.8 * 2.0)


def test_map_merge_skips_a_pass_without_the_stage():
    passes = [_merge_pass(1.0, merge=False), _merge_pass(2.0),
              _merge_pass(4.0)]
    ctx = _ctx(passes, [1.0, 1.0, 1.0])
    assert _read("map.merge_s", ctx) == pytest.approx(0.5 * 0.8 * 6.0)


def test_map_merge_reads_nothing_where_no_pass_merged():
    """The program before the merge was a stage of its own: no value,
    and nothing raises."""
    passes = [_merge_pass(1.0, merge=False), _merge_pass(2.0, merge=False)]
    assert _read("map.merge_s", _ctx(passes, [20.0, 21.0])) is None
    assert _read("map.merge_s", _ctx([], [])) is None
