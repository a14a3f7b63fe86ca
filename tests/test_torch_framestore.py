"""The port's FrameStore (a jax-free copy of
veloslam_tpu/runtime/framestore.py): the JAX package's own FrameStore
tests (tests/test_pipeline.py) run on the copy, its source is the
original's but for the module docstring and the Timeline import, and the
meta checkpoints of either package load in the other."""

import inspect
import os
import threading
import time

import numpy as np

from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.runtime import framestore as jfs
from veloslam_tpu_torch.runtime import framestore as fs_mod
from veloslam_tpu_torch.runtime.framestore import FrameStore


def test_framestore_cache_and_spill(tmp_path):
    fs = FrameStore(capacity=3, spill_dir=str(tmp_path / "spill"))
    for k in range(6):
        frame = {"xyz": np.full((2, 4, 3), k, np.float32),
                 "mask": np.ones((2, 4), bool)}
        fs.add_frame(1000 * k, frame)
    assert len(fs) == 6
    assert len(fs._frames) <= 3
    f0 = fs.get_frame_at(0)
    assert f0 is not None and f0["xyz"][0, 0, 0] == 0
    assert fs.get_frame_at(1) is None
    fn = fs.get_frame_near(1400)
    assert fn["xyz"][0, 0, 0] == 1
    rng = fs.get_range_between(2000, 5000)
    assert len(rng) == 3
    assert fs.get_recent_frame()["xyz"][0, 0, 0] == 5


def test_framestore_wait_for_frame():
    fs = FrameStore(capacity=4)
    frame = {"xyz": np.zeros((2, 4, 3), np.float32),
             "mask": np.ones((2, 4), bool)}
    fs.add_frame(1000, dict(frame))
    assert fs.wait_for_frame(after_us=-1, timeout_s=0.0) is not None
    assert fs.wait_for_frame(after_us=1000, timeout_s=0.05) is None

    def producer():
        time.sleep(0.1)
        fs.add_frame(2000, dict(frame))

    th = threading.Thread(target=producer)
    t0 = time.monotonic()
    th.start()
    got = fs.wait_for_frame(after_us=1000, timeout_s=2.0)
    th.join()
    assert got is not None
    assert time.monotonic() - t0 >= 0.08


def test_framestore_meta_resume(tmp_path):
    spill = str(tmp_path / "spill")
    fs = FrameStore(capacity=1, spill_dir=spill)
    for k in range(4):
        fs.add_frame(1000 * k, {"xyz": np.full((1, 2, 3), k, np.float32),
                                "mask": np.ones((1, 2), bool)})
    meta = str(tmp_path / "frames_meta.npz")
    fs.save_meta(meta)
    fs2 = FrameStore(capacity=2, spill_dir=spill)
    fs2.load_meta(meta)
    assert len(fs2) == 4
    f = fs2.get_frame_at(2000)
    assert f is not None and f["xyz"][0, 0, 0] == 2


def test_framestore_async_spill(tmp_path):
    """Eviction never blocks, queued frames stay readable, flush() joins
    the writer so every evicted frame is on disk."""
    spill = str(tmp_path / "spill")
    fs = FrameStore(capacity=2, spill_dir=spill, async_spill=True)
    for k in range(8):
        fs.add_frame(1000 * k, {"xyz": np.full((1, 2, 3), k, np.float32),
                                "mask": np.ones((1, 2), bool)})
    for k in range(8):
        f = fs.get_frame_at(1000 * k)
        assert f is not None and f["xyz"][0, 0, 0] == k
    fs.flush()
    assert fs._wq.unfinished_tasks == 0 and not fs._pending
    assert len(os.listdir(spill)) >= 6
    meta = str(tmp_path / "m.npz")
    fs.save_meta(meta)
    fs2 = FrameStore(capacity=2, spill_dir=spill)
    fs2.load_meta(meta)
    for k in range(8):
        f = fs2.get_frame_at(1000 * k)
        assert f is not None and f["xyz"][0, 0, 0] == k


def test_source_is_the_originals():
    """The copy's code is the JAX package's, line for line, after its
    module docstring; only the Timeline import names the port."""
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):].splitlines()

    ours, ref = body(fs_mod), body(jfs)
    assert len(ours) == len(ref)
    diff = [(a, b) for a, b in zip(ours, ref) if a != b]
    assert diff == [("from veloslam_tpu_torch.core.timeline import Timeline",
                     "from veloslam_tpu.core.timeline import Timeline")]


def test_meta_checkpoints_load_across_packages(tmp_path):
    """Meta with per-frame pcap sources, saved by either package, loads
    in the other: the same frame times, car poses, point counts, sources
    and payloads."""
    rng = np.random.default_rng(0)
    frames = [{"xyz": rng.normal(size=(2, 5, 3)).astype(np.float32),
               "mask": rng.random((2, 5)) < 0.7} for _ in range(5)]
    for writer, reader in ((jfs.FrameStore, FrameStore),
                           (FrameStore, jfs.FrameStore)):
        d = tmp_path / writer.__module__.replace(".", "_")
        a = writer(capacity=2, spill_dir=str(d / "spill"))
        for k, f in enumerate(frames):
            a.add_frame(1000 * k + 7, f, carpose_q=rng.normal(size=4),
                        carpose_t=rng.normal(size=3),
                        source=("drive.pcap", 24 + 1248 * k))
        meta = str(d / "frames_meta.npz")
        a.save_meta(meta, frames_dir=str(d / "frames"))
        b = reader(capacity=2)
        b.load_meta(meta, spill_dir=str(d / "frames"))
        (ta, va), (tb, vb) = a.all_frame_meta(), b.all_frame_meta()
        np.testing.assert_array_equal(ta, tb)
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_array_equal(va[k], vb[k])
        assert b._sources == a._sources
        for k, f in enumerate(frames):
            got = b.get_frame_at(1000 * k + 7)
            for key in f:
                np.testing.assert_array_equal(got[key], f[key])
