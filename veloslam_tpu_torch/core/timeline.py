"""Pose timelines: device interpolation + jax-free host copies.

`interpolate_poses` ports veloslam_tpu/core/timeline.py's device function.
`Timeline`, `PoseTrack` and `interpolate_poses_np` are numpy-only copies
of the originals: importing the JAX package's module pulls in jax through
its package __init__, and the machine the port runs on has no jax.
tests/test_torch_host.py holds the copies equal to the originals.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.core import se3


def interpolate_poses(track_rel_s: torch.Tensor, track_q: torch.Tensor,
                      track_t: torch.Tensor, track_v: torch.Tensor,
                      query_rel_s: torch.Tensor) -> se3.Pose:
    """Batched pose interpolation over a sorted pose window.

    Inside the track: slerp rotation + lerp translation.  Outside (before
    the first / after the last sample): constant-velocity translation
    extrapolation with the boundary rotation held.

    Args:
      track_rel_s: (M,) sorted float32 seconds relative to the batch anchor.
      track_q / track_t / track_v: (M, 4) / (M, 3) / (M, 3).
      query_rel_s: (N,) query times, same time base.
    Returns:
      Pose with leading dim N.
    """
    m = track_rel_s.shape[0]
    hi = torch.searchsorted(track_rel_s, query_rel_s, right=True)
    lo = torch.clamp(hi - 1, 0, m - 1)
    hi = torch.clamp(hi, 0, m - 1)
    t0, t1 = track_rel_s[lo], track_rel_s[hi]
    denom = torch.where(hi == lo, 1.0, t1 - t0)
    u = torch.clamp((query_rel_s - t0) / denom, 0.0, 1.0)
    pose = se3.interp(se3.Pose(track_q[lo], track_t[lo]),
                      se3.Pose(track_q[hi], track_t[hi]), u)
    before = (query_rel_s < track_rel_s[0])[..., None]
    after = (query_rel_s > track_rel_s[-1])[..., None]
    dt_b = (query_rel_s - track_rel_s[0])[..., None]
    dt_a = (query_rel_s - track_rel_s[-1])[..., None]
    t = torch.where(before, track_t[0] + track_v[0] * dt_b, pose.t)
    t = torch.where(after, track_t[-1] + track_v[-1] * dt_a, t)
    q = torch.where(before, track_q[0], pose.q)
    q = torch.where(after, track_q[-1], q)
    return se3.Pose(q, t)


# --- host copies (numpy) -----------------------------------------------------

def interpolate_poses_np(track_rel_s: np.ndarray, track_q: np.ndarray,
                         track_t: np.ndarray, track_v: np.ndarray,
                         query_rel_s: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy `interpolate_poses` for host-side queries.  Returns
    (q (N,4), t (N,3)) float32."""
    tr = np.asarray(track_rel_s, np.float64)
    tq = np.asarray(track_q, np.float64)
    tt = np.asarray(track_t, np.float64)
    tv = np.asarray(track_v, np.float64)
    qr = np.atleast_1d(np.asarray(query_rel_s, np.float64))
    m = len(tr)
    hi = np.clip(np.searchsorted(tr, qr, side="right"), 0, m - 1)
    lo = np.clip(hi - 1, 0, m - 1)
    denom = np.where(hi == lo, 1.0, tr[hi] - tr[lo])
    u = np.clip((qr - tr[lo]) / denom, 0.0, 1.0)[:, None]
    q0, q1 = tq[lo], tq[hi]
    # slerp (sign-aligned), nlerp fallback near parallel
    dot = np.sum(q0 * q1, -1, keepdims=True)
    q1 = np.where(dot < 0, -q1, q1)
    dot = np.abs(dot)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    sin_t = np.sin(theta)
    near = sin_t < 1e-6
    w0 = np.where(near, 1.0 - u, np.sin((1.0 - u) * theta)
                  / np.where(near, 1.0, sin_t))
    w1 = np.where(near, u, np.sin(u * theta) / np.where(near, 1.0, sin_t))
    q = w0 * q0 + w1 * q1
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = tt[lo] + (tt[hi] - tt[lo]) * u
    before = qr < tr[0]
    after = qr > tr[-1]
    t = np.where(before[:, None],
                 tt[0] + tv[0] * (qr - tr[0])[:, None], t)
    t = np.where(after[:, None],
                 tt[-1] + tv[-1] * (qr - tr[-1])[:, None], t)
    q = np.where(before[:, None], tq[0], q)
    q = np.where(after[:, None], tq[-1], q)
    return q.astype(np.float32), t.astype(np.float32)


class Timeline:
    """Sorted time-indexed store of array records (host, numpy).

    Appending in timestamp order is O(1) amortized; out-of-order inserts
    trigger a re-sort; duplicate timestamps overwrite."""

    def __init__(self, value_fields: Tuple[str, ...]):
        self._fields = tuple(value_fields)
        self._times: list = []
        self._values: Dict[str, list] = {f: [] for f in self._fields}
        self._dirty = False
        self._cache: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]] = None

    def __len__(self) -> int:
        return len(self._times)

    def add(self, t_us: int, **values) -> None:
        if set(values) != set(self._fields):
            raise ValueError(
                f"expected fields {self._fields}, got {tuple(values)}")
        if self._times and t_us == self._times[-1]:
            for f in self._fields:          # overwrite duplicate timestamp
                self._values[f][-1] = values[f]
            self._cache = None
            return
        if self._times and t_us < self._times[-1]:
            self._dirty = True
        self._times.append(int(t_us))
        for f in self._fields:
            self._values[f].append(values[f])
        self._cache = None

    def arrays(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Materialize as (sorted times int64, values dict)."""
        if self._cache is None:
            times = np.asarray(self._times, dtype=np.int64)
            vals = {f: np.asarray(self._values[f]) for f in self._fields}
            if self._dirty:
                # Stable sort keeps the later duplicate, then drop earlier dups.
                order = np.argsort(times, kind="stable")
                times = times[order]
                vals = {f: v[order] for f, v in vals.items()}
                keep = np.ones(len(times), bool)
                keep[:-1] = times[:-1] != times[1:]
                times = times[keep]
                vals = {f: v[keep] for f, v in vals.items()}
                self._times = times.tolist()
                self._values = {f: list(v) for f, v in vals.items()}
                self._dirty = False
            self._cache = (times, vals)
        return self._cache

    # --- queries (batched; q_us may be scalar or array) ---------------------

    def nearest(self, q_us) -> np.ndarray:
        """Index of the record nearest each query time."""
        times, _ = self.arrays()
        q = np.atleast_1d(np.asarray(q_us, np.int64))
        hi = np.searchsorted(times, q)
        lo = np.clip(hi - 1, 0, len(times) - 1)
        hi = np.clip(hi, 0, len(times) - 1)
        pick_hi = np.abs(times[hi] - q) < np.abs(q - times[lo])
        idx = np.where(pick_hi, hi, lo)
        return idx if np.ndim(q_us) else int(idx[0])

    def bracket(self, q_us) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) indices bracketing each query; lo == hi at the ends of
        the timeline (single-sided)."""
        times, _ = self.arrays()
        hi = np.searchsorted(times, np.atleast_1d(np.asarray(q_us, np.int64)),
                             side="right")
        lo = np.clip(hi - 1, 0, len(times) - 1)
        hi = np.clip(hi, 0, len(times) - 1)
        return lo, hi

    def range_between(self, t0_us: int, t1_us: int) -> slice:
        """Slice of records with t0 <= t < t1."""
        times, _ = self.arrays()
        return slice(int(np.searchsorted(times, t0_us)),
                     int(np.searchsorted(times, t1_us)))

    # --- persistence (npz, byte-compatible with the JAX package's) ----------

    def save(self, path: str) -> None:
        times, vals = self.arrays()
        np.savez(path, __times_us=times, **vals)

    @classmethod
    def load(cls, path: str) -> "Timeline":
        data = np.load(path, allow_pickle=False)
        fields = tuple(k for k in data.files if k != "__times_us")
        tl = cls(fields)
        times = data["__times_us"]
        tl._times = times.tolist()
        tl._values = {f: list(data[f]) for f in fields}
        tl._cache = None
        return tl


class PoseTrack:
    """Host pose timeline (q wxyz, t, v; int64 µs) with window extraction."""

    FIELDS = ("q", "t", "v")

    def __init__(self):
        self.timeline = Timeline(self.FIELDS)

    def __len__(self):
        return len(self.timeline)

    def add(self, t_us: int, q: np.ndarray, t: np.ndarray,
            v: Optional[np.ndarray] = None) -> None:
        v = np.zeros(3) if v is None else np.asarray(v, np.float64)
        self.timeline.add(t_us, q=np.asarray(q, np.float64),
                          t=np.asarray(t, np.float64), v=v)

    def window(self, t0_us: int, t1_us: int, anchor_us: int, pad: int = 2
               ) -> Dict[str, np.ndarray]:
        """Poses covering [t0, t1] (+pad records each side) as float32
        arrays with times relative to `anchor_us`."""
        if len(self.timeline) == 0:
            raise ValueError(
                "PoseTrack is empty — cannot build an interpolation window "
                "(feed INS poses before querying)")
        times, vals = self.timeline.arrays()
        lo = max(0, int(np.searchsorted(times, t0_us)) - pad)
        hi = min(len(times), int(np.searchsorted(times, t1_us, "right")) + pad)
        sl = slice(lo, hi)
        return {
            "rel_s": ((times[sl] - anchor_us) * 1e-6).astype(np.float32),
            "q": vals["q"][sl].astype(np.float32),
            "t": vals["t"][sl].astype(np.float32),
            "v": vals["v"][sl].astype(np.float32),
        }

    def save(self, path: str) -> None:
        self.timeline.save(path)

    @classmethod
    def load(cls, path: str) -> "PoseTrack":
        pt = cls()
        pt.timeline = Timeline.load(path)
        return pt
