"""The port's stage timers as spans: nesting and each stage's own seconds
(`self_s`), the recorder bound while a pipeline's entry points run, the
sync spans (`sync.<stage>`), the stages as `veloslam.<name>` annotations
in a torch.profiler trace, `slam_run --trace-dir`, how much of a
per-frame run the stages cover, and the map's tile merges as stages.

The last two tests need a CUDA card (marker `cuda`; they skip without
one): the stages' annotations lay no range among the card's events, and
over a short per-frame drive every synchronizing operation that torch's
sync debug mode reports is one `sync.*` span.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \
        tests/test_torch_tracing.py

This module imports no jax.
"""

import glob
import json
import os
import time
import types
import warnings

import numpy as np
import pytest
import torch

from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch.utils import profiling
from veloslam_tpu_torch.utils.profiling import StageTimers, sync_span

CARD = torch.device("cuda")


@pytest.fixture
def clock(monkeypatch):
    """The profiling module's clock, moved by hand."""
    clk = types.SimpleNamespace(t=100.0)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: clk.t))
    return clk


def test_self_seconds_of_nested_repeated_and_raising_stages(clock):
    """outer holds a twice and b, b holds c, and c raises once: each
    stage's total_s, count and mean_ms are its own wall seconds as
    before; self_s is that less its children's, and the self_s of all
    stages add up to the outermost stage's seconds."""
    t = StageTimers()
    with t.stage("outer"):
        clock.t += 1.0
        for _ in range(2):
            with t.stage("a"):
                clock.t += 2.0
        with t.stage("b"):
            clock.t += 0.5
            with pytest.raises(ValueError):
                with t.stage("c"):
                    clock.t += 4.0
                    raise ValueError("inside c")
            assert t.innermost() == "b"
            with t.stage("c"):
                clock.t += 1.0
        clock.t += 0.25
    assert t.innermost() is None
    s = t.summary()
    want = {"outer": (10.75, 1, 1.25), "a": (4.0, 2, 4.0),
            "b": (5.5, 1, 0.5), "c": (5.0, 2, 5.0)}
    for name, (total, count, own) in want.items():
        assert s[name]["total_s"] == pytest.approx(total)
        assert s[name]["count"] == count
        assert s[name]["mean_ms"] == pytest.approx(1e3 * total / count)
        assert s[name]["self_s"] == pytest.approx(own)
    assert sum(v["self_s"] for v in s.values()) == \
        pytest.approx(s["outer"]["total_s"])
    report = t.report()
    assert "self=" in report and "total=" in report


def test_sync_span_counts_and_times_under_the_innermost_stage(clock):
    """A sync span on a card tensor or device is the stage
    sync.<innermost open stage> of the bound recorder, one count per
    operation; nothing on CPU tensors, nothing inside another sync span,
    and sync.unstaged outside every stage."""
    t = StageTimers(sync=lambda: None)
    with profiling.recording(t):
        with t.stage("register"):
            clock.t += 1.0
            for _ in range(3):
                with sync_span(CARD):
                    clock.t += 0.5
                    with sync_span("cuda:0"):     # nested: not counted
                        clock.t += 0.25
            with sync_span(torch.zeros(2)):       # on the CPU
                clock.t += 8.0
        with sync_span(CARD):
            clock.t += 2.0
    with sync_span(CARD):                         # unbound again
        clock.t += 1.0
    s = t.summary()
    assert s["sync.register"]["count"] == 3
    assert s["sync.register"]["total_s"] == pytest.approx(2.25)
    assert s["register"]["total_s"] == pytest.approx(11.25)
    assert s["register"]["self_s"] == pytest.approx(9.0)
    assert s["sync.unstaged"]["count"] == 1
    assert set(s) == {"register", "sync.register", "sync.unstaged"}


def test_nothing_is_recorded_without_a_bound_recorder(clock):
    t = StageTimers()
    with t.stage("register"):
        with sync_span(CARD):
            clock.t += 1.0
    assert set(t.summary()) == {"register"}
    assert t.summary()["register"]["self_s"] == pytest.approx(1.0)


def test_stage_opens_in_the_bound_recorder(clock):
    """profiling.stage opens a stage of the timers bound by `recording`,
    nested in their open stages; unbound, it records nothing."""
    t = StageTimers(sync=lambda: None)
    with profiling.stage("map_merge"):          # unbound
        clock.t += 1.0
    with profiling.recording(t):
        with t.stage("map_update"):
            for _ in range(2):
                with profiling.stage("map_merge"):
                    clock.t += 0.5
    s = t.summary()
    assert set(s) == {"map_update", "map_merge"}
    assert s["map_merge"]["count"] == 2
    assert s["map_merge"]["total_s"] == pytest.approx(1.0)
    assert s["map_update"]["self_s"] == pytest.approx(0.0)

def test_stages_are_profiler_annotations_only_while_it_records(
        monkeypatch):
    """Inside a torch.profiler recording each stage is the annotation
    veloslam.<name> on the profiler's clock; outside it no annotation is
    made at all."""
    from torch.profiler import ProfilerActivity, profile
    t = StageTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("register"):
            with t.stage("roi"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"veloslam.register", "veloslam.roi"} <= names

    def forbidden(name):
        raise AssertionError(f"annotation {name} outside the profiler")
    monkeypatch.setattr(profiling, "_Annotation", forbidden)
    with t.stage("register"):
        torch.ones(8).sum()
    assert t.summary()["register"]["count"] == 2


@pytest.fixture(scope="module")
def slam_run_drive(tmp_path_factory):
    """`slam_run --simulate 0.6 --device cpu --trace-dir`: its output
    directory and trace directory."""
    from veloslam_tpu_torch.apps import slam_run
    out = tmp_path_factory.mktemp("slam_run")
    trace_dir = out / "trace"
    assert slam_run.main(["--simulate", "0.6", "--device", "cpu",
                          "--out-dir", str(out),
                          "--trace-dir", str(trace_dir)]) == 0
    return out, trace_dir


def test_slam_run_trace_dir_writes_the_stages(slam_run_drive):
    """--trace-dir writes one Chrome trace holding the pipeline's stages
    as veloslam.<stage> annotations (register among them)."""
    _, trace_dir = slam_run_drive
    assert sorted(os.listdir(trace_dir)) == ["trace.json"]
    events = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert {"veloslam.register", "veloslam.frame", "veloslam.read_inputs",
            "veloslam.roi"} <= names


def test_stages_cover_a_per_frame_run(slam_run_drive):
    """On slam_run's 0.6 s drive, the stages' own seconds add up to at
    least 90% of the wall time of run_offline + finalize(): the time a
    new step in the loop spends outside every stage shows here."""
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    out, _ = slam_run_drive
    pcap = glob.glob(str(out / "*.pcap"))[0]
    ins = glob.glob(str(out / "*_ins.txt")) or glob.glob(str(out / "*.txt"))
    ins = [p for p in ins if not p.endswith("trajectory.txt")][0]
    pipe = SlamPipeline(device="cpu", spill_dir=str(out / "spill2"))
    t0 = time.perf_counter()
    pipe.run_offline(pcap, ins)
    res = pipe.finalize()
    wall = time.perf_counter() - t0
    timing = res["timing"]
    staged = sum(v["self_s"] for k, v in timing.items()
                 if k != "pipeline_init")
    assert timing["frame"]["count"] == res["n_frames"] > 2
    assert {"read_inputs", "frames_to_host", "frame_prep", "roi",
            "frame_store", "trajectory"} <= set(timing)
    assert staged >= 0.9 * wall, (staged, wall, timing)
    assert staged <= wall


def test_map_merges_are_stages_and_match_the_resort(slam_run_drive,
                                                    monkeypatch):
    """On slam_run's 0.6 s drive (run_offline, finalize, then a map
    rebuild): each tile merge is one stage map_merge, inside the map's
    stages, and none takes the re-sort (map_merge_resort).  The final map
    equals, to the bit, the map of the same run with every merge made by
    the re-sort."""
    from veloslam_tpu_torch.map import voxelmap
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    out, _ = slam_run_drive
    pcap = glob.glob(str(out / "*.pcap"))[0]
    ins = [p for p in glob.glob(str(out / "*.txt"))
           if not p.endswith("trajectory.txt")][0]
    merge = voxelmap.MapPatchData.merge
    made = []

    def counted(self, *args, **kwargs):
        made.append(1)
        return merge(self, *args, **kwargs)

    def run():
        pipe = SlamPipeline(device="cpu")
        pipe.run_offline(pcap, ins)
        pipe.finalize()
        pipe.rebuild_map()
        tiles = sorted(set(pipe.map._patches) | set(pipe.map._spilled))
        return pipe.timers.summary(), {
            k: pipe.map._materialize(k, create=False) for k in tiles}

    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # the two runs' device work alike
    try:
        with monkeypatch.context() as m:
            m.setattr(voxelmap.MapPatchData, "merge", counted)
            timing, tiles = run()
        with monkeypatch.context() as m:
            m.setattr(voxelmap.MapPatchData, "_merge_lookup",
                      lambda self, *args: False)
            resort_timing, resort_tiles = run()
    finally:
        torch.set_num_threads(threads)
    assert timing["map_merge"]["count"] == len(made) > 0
    assert "map_merge_resort" not in timing
    assert timing["map_rebuild"]["count"] == 1
    around = sum(timing[k]["total_s"] for k in
                 ("map_update", "map_reintegrate", "map_rebuild")
                 if k in timing)
    assert timing["map_merge"]["total_s"] <= around
    assert resort_timing["map_merge_resort"]["count"] == len(made)
    assert list(tiles) == list(resort_tiles)
    for k, p in resort_tiles.items():
        for f in ("coords", "count", "s1", "s2"):
            assert getattr(tiles[k], f).tobytes() == \
                getattr(p, f).tobytes(), (k, f)

@pytest.mark.cuda
def test_stage_annotations_lay_nothing_on_the_card_timeline():
    """Under a profiler that records the card, a stage is a CPU-side
    record (veloslam.<name>) around its kernels' launches, and puts no
    range of its own among the card's events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from torch.profiler import ProfilerActivity, profile
    card = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=card)
    t = StageTimers()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with t.stage("register"):
            (x * 2).sum().item()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e.name() for e in events
               if str(e.device_type()).endswith("CUDA")]
    ours = [e for e in events if e.name() == "veloslam.register"]
    assert len(ours) == 1 and str(ours[0].device_type()).endswith("CPU")
    assert on_card and not any(n.startswith("veloslam.") for n in on_card)


@pytest.mark.cuda
def test_every_sync_of_a_per_frame_drive_is_a_sync_span(tmp_path):
    """On the card, over a short per-frame drive (a fresh SlamPipeline,
    run_offline, finalize): the synchronizing operations that torch's
    sync debug mode reports are as many as the sync.* spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    gold = np.load(cs.PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["small"]
    paths, _ = cs.write_pipeline_drive(drive, cfg["model"], str(tmp_path))
    card = torch.device("cuda", 0)
    cs.run_perframe(paths, drive, card)           # warm: kernels, libraries
    torch.cuda.synchronize()
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]),
                                device=card)
            pipe.run_offline(paths["pcap"], paths["ins"])
            res = pipe.finalize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # Only the operations: setting the mode also warns once that it is
    # a prototype ("Synchronization debug mode ..."), which is none.
    reported = sum("synchronizing CUDA operation" in str(w.message)
                   for w in caught)
    spans = {k: v["count"] for k, v in res["timing"].items()
             if k.startswith("sync.")}
    assert res["n_closures"] >= 1
    assert sum(spans.values()) == reported > 0, (reported, spans)
