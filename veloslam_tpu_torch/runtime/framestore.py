"""Frame store: time-indexed frame cache with transparent disk spill.

A jax-free copy of veloslam_tpu/runtime/framestore.py (importing the
original runs the JAX package's __init__): a bounded in-RAM cache of
decoded frames keyed by start time, evicted frames persisted as npz by a
background writer thread, Timeline binary searches for exact, nearest
and range queries, a blocking wait for the next frame, and a meta-index
checkpoint (frame times, car poses, point counts and each frame's pcap
source) that resumes a session from disk alone.  Frames whose payload was
dropped or whose npz is missing are re-decoded from their pcap byte
offsets through a pipeline-provided `redecoder`.
tests/test_torch_framestore.py runs the JAX package's FrameStore tests on
this copy and holds its checkpoints interchangeable with the original's.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from veloslam_tpu_torch.core.timeline import Timeline

FrameDict = Dict[str, np.ndarray]


class FrameStore:
    """Bounded cache of decoded frames keyed by start time (int64 µs).

    With `async_spill` (default), evicted frames are persisted by a
    background writer thread — the SLAM loop never blocks on disk, the
    reference's writer-thread design (HDLManager.cxx:321-389, double
    buffer hardDriveBuffer1/2).  Frames queued for writing remain readable
    (pending set) until the writer finishes."""

    def __init__(self, capacity: int = 200,
                 spill_dir: Optional[str] = None,
                 async_spill: bool = True):
        self.capacity = capacity          # reference default 200 frames
        self.spill_dir = spill_dir
        self._frames: Dict[int, FrameDict] = {}
        self._spilled: Dict[int, str] = {}
        self._meta = Timeline(("carpose_q", "carpose_t", "n_points"))
        self._touch: Dict[int, int] = {}
        self._clock = 0
        # One reentrant lock guards _frames/_touch/_meta/_spilled/_pending:
        # add_frame runs on the ingest thread while wait_for_frame /
        # get_* readers run on consumers (the reference's condvar+mutex
        # waitForFrame design, HDLManager.cxx:213-225).  RLock because
        # _materialize -> _evict_if_needed re-enters.
        self._lock = threading.RLock()
        self._arrival = threading.Condition()
        self._pending: Dict[int, FrameDict] = {}
        self._wq: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        self._async = async_spill and spill_dir is not None
        # Per-frame pcap source (path, byte offset of the packet at or
        # before the frame start) + a redecoder callback
        # (source, start_us) -> FrameDict set by the owning pipeline.
        self._sources: Dict[int, tuple] = {}
        self.redecoder = None

    # --- background writer (HDLManager writer-thread parity) ----------------

    def _ensure_writer(self) -> None:
        if self._wq is None:
            self._wq = queue.Queue()
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._wq.get()
            try:
                if item is None:
                    return
                t, frame, path = item
                np.savez_compressed(path, **frame)
                with self._lock:
                    self._spilled[t] = path
                    self._pending.pop(t, None)
            finally:
                self._wq.task_done()

    def flush(self) -> None:
        """Block until all queued spills are on disk."""
        if self._wq is not None:
            self._wq.join()

    def __len__(self) -> int:
        return len(self._meta)

    # --- writes -------------------------------------------------------------

    def add_frame(self, start_us: int, frame: FrameDict,
                  carpose_q: np.ndarray = None,
                  carpose_t: np.ndarray = None,
                  source: Optional[tuple] = None) -> None:
        """`source`: optional (pcap_path, byte_offset) of the packet at or
        before this frame's start — enables payload re-decode (the
        reference's (fileStartPos, skips) frame meta, HDLFrame.h:40-44)."""
        start_us = int(start_us)
        with self._lock:
            if source is not None:
                self._sources[start_us] = (str(source[0]), int(source[1]))
            self._clock += 1
            self._frames[start_us] = frame
            self._touch[start_us] = self._clock
            self._meta.add(
                start_us,
                carpose_q=(np.asarray([1.0, 0, 0, 0]) if carpose_q is None
                           else np.asarray(carpose_q)),
                carpose_t=(np.zeros(3) if carpose_t is None
                           else np.asarray(carpose_t)),
                n_points=int(frame["mask"].sum()))
            self._evict_if_needed()
        with self._arrival:
            self._arrival.notify_all()

    def _evict_if_needed(self) -> None:
        while len(self._frames) > self.capacity:
            lru = min(self._touch, key=self._touch.get)
            frame = self._frames.pop(lru)
            del self._touch[lru]
            if self.spill_dir is not None:
                os.makedirs(self.spill_dir, exist_ok=True)
                path = os.path.join(self.spill_dir, f"frame_{lru}.npz")
                with self._lock:
                    already = lru in self._spilled or lru in self._pending
                if already:
                    continue
                if self._async:
                    self._ensure_writer()
                    with self._lock:
                        self._pending[lru] = frame
                    self._wq.put((lru, frame, path))
                else:
                    np.savez_compressed(path, **frame)
                    with self._lock:
                        self._spilled[lru] = path
            # without spill_dir the frame data is dropped; meta remains

    # --- reads (prepareFrame analog: HDLManager.cxx:195-211) ----------------

    def _materialize(self, start_us: int) -> Optional[FrameDict]:
        with self._lock:
            self._clock += 1
            if start_us in self._frames:
                self._touch[start_us] = self._clock
                return self._frames[start_us]
            pending = self._pending.get(start_us)
            path = self._spilled.get(start_us)
        if pending is not None:       # queued for write — still in RAM
            return pending
        if path is not None:
            data = np.load(path, allow_pickle=False)
            frame = {k: data[k] for k in data.files}
            with self._lock:
                self._frames[start_us] = frame
                self._touch[start_us] = self._clock
                self._evict_if_needed()
            return frame
        # Payload gone (dropped without spill, or npz missing after a
        # partial checkpoint): re-decode from the pcap offset
        # (prepareFrame -> HDLParser::getFrame, HDLManager.cxx:195-211).
        with self._lock:
            src = self._sources.get(start_us)
        if src is not None and self.redecoder is not None:
            frame = self.redecoder(src, start_us)
            if frame is not None:
                with self._lock:
                    self._frames[start_us] = frame
                    self._touch[start_us] = self._clock
                    self._evict_if_needed()
                return frame
        return None

    def get_frame_at(self, t_us: int) -> Optional[FrameDict]:
        """Exact-start lookup (getFrameAt, HDLManager.h:141)."""
        with self._lock:
            times, _ = self._meta.arrays()
            i = np.searchsorted(times, int(t_us))
            if i >= len(times) or times[i] != int(t_us):
                return None
            return self._materialize(int(times[i]))

    def get_frame_near(self, t_us: int) -> Optional[FrameDict]:
        """Nearest-start lookup (getFrameNear, HDLManager.h:144)."""
        with self._lock:
            if len(self._meta) == 0:
                return None
            times, _ = self._meta.arrays()
            return self._materialize(
                int(times[self._meta.nearest(int(t_us))]))

    def get_recent_frame(self) -> Optional[FrameDict]:
        """Latest frame (getRecentFrame, HDLManager.h:138)."""
        with self._lock:
            if len(self._meta) == 0:
                return None
            times, _ = self._meta.arrays()
            return self._materialize(int(times[-1]))

    def wait_for_frame(self, after_us: int = -1,
                       timeout_s: Optional[float] = None
                       ) -> Optional[FrameDict]:
        """Block until a frame starting after `after_us` exists, then
        return it (waitForFrame, HDLManager.cxx:213-225 — condvar on
        frame arrival).  `after_us=-1` accepts any frame; returns None on
        timeout."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)

        def newest_after():
            with self._lock:
                if len(self._meta) == 0:
                    return None
                times, _ = self._meta.arrays()
                return int(times[-1]) if int(times[-1]) > after_us else None

        with self._arrival:
            while True:
                t = newest_after()
                if t is not None:
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                if not self._arrival.wait(timeout=remaining):
                    return None
        return self._materialize(t)

    def get_range_between(self, t0_us: int, t1_us: int) -> List[FrameDict]:
        """All frames starting in [t0, t1) (getRangeBetween,
        HDLManager.h:146)."""
        with self._lock:
            times, _ = self._meta.arrays()
            sl = self._meta.range_between(int(t0_us), int(t1_us))
            starts = [int(t) for t in times[sl]]
        out = []
        for t in starts:
            f = self._materialize(t)
            if f is not None:
                out.append(f)
        return out

    def all_frame_meta(self):
        """(times_us, values) of the frame index (getAllFrameMeta,
        HDLManager.h:148)."""
        with self._lock:
            return self._meta.arrays()

    # --- meta checkpoint (saveHDLMeta/loadHDLMeta contract) ------------------

    def spill_all(self, target_dir: Optional[str] = None) -> None:
        """Persist every frame to `target_dir` (default: the spill dir) so
        a checkpoint is complete — the reference never needs this because
        raw packets are always on disk; here decoded frames are the
        artifact.  Already-spilled frames are copied when targeting a
        different directory."""
        target = target_dir or self.spill_dir
        if target is None:
            return
        self.flush()              # pending async writes land in _spilled
        os.makedirs(target, exist_ok=True)
        for t, frame in self._frames.items():
            path = os.path.join(target, f"frame_{t}.npz")
            if not os.path.exists(path):
                np.savez_compressed(path, **frame)
            if t not in self._spilled:
                self._spilled[t] = path
        if target_dir is not None:
            import shutil
            for t, src in list(self._spilled.items()):
                dst = os.path.join(target, f"frame_{t}.npz")
                if os.path.abspath(src) != os.path.abspath(dst) and \
                        not os.path.exists(dst):
                    shutil.copyfile(src, dst)

    def save_meta(self, path: str,
                  frames_dir: Optional[str] = None) -> None:
        self.spill_all(frames_dir)
        self._meta.save(path)
        if self._sources:
            ts = sorted(self._sources)
            np.savez(path.replace(".npz", "") + "_sources.npz",
                     times_us=np.asarray(ts, np.int64),
                     offsets=np.asarray([self._sources[t][1] for t in ts],
                                        np.int64),
                     paths=np.asarray([self._sources[t][0] for t in ts]))

    def load_meta(self, path: str, spill_dir: Optional[str] = None) -> None:
        """Rebuild the index from a meta checkpoint; frame payloads resolve
        from `spill_dir` (or this store's) on access, falling back to pcap
        re-decode when sources were checkpointed."""
        self._meta = Timeline.load(path)
        sd = spill_dir or self.spill_dir
        times, _ = self._meta.arrays()
        if sd is not None:
            for t in times:
                p = os.path.join(sd, f"frame_{int(t)}.npz")
                if os.path.exists(p):
                    self._spilled[int(t)] = p
        spath = path.replace(".npz", "") + "_sources.npz"
        if os.path.exists(spath):
            data = np.load(spath, allow_pickle=False)
            for t, off, pp in zip(data["times_us"], data["offsets"],
                                  data["paths"]):
                self._sources[int(t)] = (str(pp), int(off))
