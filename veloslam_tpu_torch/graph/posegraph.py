"""Pose-graph state: the host builder and its fixed-capacity device view.

Port of veloslam_tpu/graph/posegraph.py.  `PoseGraph` is the host numpy
builder (append APIs, geometric growth, residual trim, save/load);
`PoseGraph.arrays(device)` snapshots it as `GraphArrays`, keyframe poses
and factors in static-shape tensors with validity counts, so one solver
serves any graph up to capacity.  Factors: pose-pose edges (odometry and
loop closures; relative-pose measurement with diagonal information (6,))
and pose-landmark observations (landmark position in the keyframe's
frame, information (3,)); the pose-only solver (graph.optimize.solve)
reads the edges only, the landmark solve (solve_with_landmarks) both.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class GraphArrays(NamedTuple):
    """Device view of the graph (static shapes)."""

    q: torch.Tensor            # (K, 4) keyframe orientations
    t: torch.Tensor            # (K, 3) keyframe positions
    n_poses: torch.Tensor      # () int32
    e_i: torch.Tensor          # (E,) int32 edge source keyframe
    e_j: torch.Tensor          # (E,) int32 edge target keyframe
    e_q: torch.Tensor          # (E, 4) measured relative rotation
    e_t: torch.Tensor          # (E, 3) measured relative translation
    e_info: torch.Tensor       # (E, 6) diagonal information
    e_valid: torch.Tensor      # (E,) bool
    l_pos: torch.Tensor        # (M, 3) landmark positions
    n_landmarks: torch.Tensor  # () int32
    o_i: torch.Tensor          # (O,) int32 observing keyframe
    o_l: torch.Tensor          # (O,) int32 observed landmark
    o_z: torch.Tensor          # (O, 3) measurement in keyframe frame
    o_info: torch.Tensor       # (O, 3) diagonal information
    o_valid: torch.Tensor      # (O,) bool


class PoseGraph:
    """Host-side builder with append APIs; `arrays(device)` snapshots it.

    Capacities are starting sizes, not limits: every `add_*` grows its
    backing array geometrically (powers of two) when full.  The solve
    paths crop to the occupied prefix (runtime.pipeline.crop_graph), so
    the solved shapes track the live counts, not these allocations."""

    def __init__(self, max_poses: int = 1024, max_edges: int = 4096,
                 max_landmarks: int = 1024, max_obs: int = 8192):
        self.K, self.E = max_poses, max_edges
        self.M, self.O = max_landmarks, max_obs
        self.q = np.zeros((self.K, 4), np.float32)
        self.q[:, 0] = 1.0
        self.t = np.zeros((self.K, 3), np.float32)
        self.n_poses = 0
        self.e_i = np.zeros(self.E, np.int32)
        self.e_j = np.zeros(self.E, np.int32)
        self.e_q = np.zeros((self.E, 4), np.float32)
        self.e_q[:, 0] = 1.0
        self.e_t = np.zeros((self.E, 3), np.float32)
        self.e_info = np.zeros((self.E, 6), np.float32)
        self.n_edges = 0
        self.l_pos = np.zeros((self.M, 3), np.float32)
        self.n_landmarks = 0
        self.o_i = np.zeros(self.O, np.int32)
        self.o_l = np.zeros(self.O, np.int32)
        self.o_z = np.zeros((self.O, 3), np.float32)
        self.o_info = np.zeros((self.O, 3), np.float32)
        self.o_ok = np.ones(self.O, bool)   # residual-trim mask
        self.n_obs = 0

    # --- construction ------------------------------------------------------

    @staticmethod
    def _grow(arr: np.ndarray, new_n: int) -> np.ndarray:
        out = np.zeros((new_n,) + arr.shape[1:], arr.dtype)
        out[:len(arr)] = arr
        return out

    def _grow_poses(self) -> None:
        K2 = max(self.K * 2, 32)
        self.q = self._grow(self.q, K2)
        self.q[self.K:, 0] = 1.0
        self.t = self._grow(self.t, K2)
        self.K = K2

    def _grow_edges(self) -> None:
        E2 = max(self.E * 2, 32)
        self.e_i = self._grow(self.e_i, E2)
        self.e_j = self._grow(self.e_j, E2)
        self.e_q = self._grow(self.e_q, E2)
        self.e_q[self.E:, 0] = 1.0
        self.e_t = self._grow(self.e_t, E2)
        self.e_info = self._grow(self.e_info, E2)
        self.E = E2

    def _grow_landmarks(self) -> None:
        M2 = max(self.M * 2, 16)
        self.l_pos = self._grow(self.l_pos, M2)
        self.M = M2

    def _grow_obs(self) -> None:
        O2 = max(self.O * 2, 32)
        self.o_i = self._grow(self.o_i, O2)
        self.o_l = self._grow(self.o_l, O2)
        self.o_z = self._grow(self.o_z, O2)
        self.o_info = self._grow(self.o_info, O2)
        ok = np.ones(O2, bool)
        ok[:len(self.o_ok)] = self.o_ok
        self.o_ok = ok
        self.O = O2

    def add_pose(self, q, t) -> int:
        if self.n_poses >= self.K:
            self._grow_poses()
        k = self.n_poses
        self.q[k] = np.asarray(q, np.float32)
        self.t[k] = np.asarray(t, np.float32)
        self.n_poses += 1
        return k

    def add_edge(self, i: int, j: int, rel_q, rel_t,
                 info=(100.0,) * 6) -> int:
        if self.n_edges >= self.E:
            self._grow_edges()
        e = self.n_edges
        self.e_i[e], self.e_j[e] = i, j
        self.e_q[e] = np.asarray(rel_q, np.float32)
        self.e_t[e] = np.asarray(rel_t, np.float32)
        info = np.asarray(info, np.float32)
        self.e_info[e] = np.broadcast_to(info, (6,))
        self.n_edges += 1
        return e

    def add_landmark(self, pos) -> int:
        if self.n_landmarks >= self.M:
            self._grow_landmarks()
        m = self.n_landmarks
        self.l_pos[m] = np.asarray(pos, np.float32)
        self.n_landmarks += 1
        return m

    def add_observation(self, pose_i: int, landmark: int, z,
                        info=(25.0,) * 3) -> int:
        if self.n_obs >= self.O:
            self._grow_obs()
        o = self.n_obs
        self.o_i[o], self.o_l[o] = pose_i, landmark
        self.o_z[o] = np.asarray(z, np.float32)
        self.o_info[o] = np.broadcast_to(np.asarray(info, np.float32), (3,))
        self.n_obs += 1
        return o

    # --- snapshots ---------------------------------------------------------

    def arrays(self, device) -> GraphArrays:
        """The graph as GraphArrays tensors on `device` (full capacity;
        counts and validity masks mark the occupied rows)."""
        e_valid = np.zeros(self.E, bool)
        e_valid[:self.n_edges] = True
        o_valid = np.zeros(self.O, bool)
        o_valid[:self.n_obs] = True
        o_valid &= self.o_ok

        def dev(a):
            return torch.as_tensor(np.array(a), device=device)

        return GraphArrays(
            q=dev(self.q), t=dev(self.t), n_poses=dev(np.int32(self.n_poses)),
            e_i=dev(self.e_i), e_j=dev(self.e_j), e_q=dev(self.e_q),
            e_t=dev(self.e_t), e_info=dev(self.e_info), e_valid=dev(e_valid),
            l_pos=dev(self.l_pos),
            n_landmarks=dev(np.int32(self.n_landmarks)),
            o_i=dev(self.o_i), o_l=dev(self.o_l), o_z=dev(self.o_z),
            o_info=dev(self.o_info), o_valid=dev(o_valid))

    def update_from(self, q: np.ndarray, t: np.ndarray,
                    l_pos: np.ndarray = None) -> None:
        """Write optimized values back into the builder."""
        self.q[:len(q)] = np.asarray(q)
        self.t[:len(t)] = np.asarray(t)
        if l_pos is not None:
            self.l_pos[:len(l_pos)] = np.asarray(l_pos)

    def poses(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.q[:self.n_poses], self.t[:self.n_poses]

    def obs_residual_norms(self) -> np.ndarray:
        """Per-observation residual |R_iᵀ(l − t_i) − z| at the current
        state (float64 numpy twin of optimize._obs_residual at zero
        deltas)."""
        n = self.n_obs
        if n == 0:
            return np.zeros(0, np.float32)
        qi = self.q[self.o_i[:n]].astype(np.float64)
        w, x, y, z = qi[:, 0], qi[:, 1], qi[:, 2], qi[:, 3]
        # Rows of R_iᵀ (= columns of R_i).
        d = self.l_pos[self.o_l[:n]].astype(np.float64) \
            - self.t[self.o_i[:n]].astype(np.float64)
        lx = (1 - 2 * (y * y + z * z)) * d[:, 0] \
            + 2 * (x * y + w * z) * d[:, 1] + 2 * (x * z - w * y) * d[:, 2]
        ly = 2 * (x * y - w * z) * d[:, 0] \
            + (1 - 2 * (x * x + z * z)) * d[:, 1] \
            + 2 * (y * z + w * x) * d[:, 2]
        lz = 2 * (x * z + w * y) * d[:, 0] + 2 * (y * z - w * x) * d[:, 1] \
            + (1 - 2 * (x * x + y * y)) * d[:, 2]
        r = np.stack([lx, ly, lz], -1) - self.o_z[:n].astype(np.float64)
        return np.linalg.norm(r, axis=-1).astype(np.float32)

    def trim_observations(self, max_residual_m: float) -> int:
        """Disable observations whose residual at the current (solved)
        state exceeds `max_residual_m`: cross-association outliers that
        the Huber weight bounds but cannot remove.  Returns the number
        newly disabled; arrays() and the solves then see them as
        invalid.  Irreversible."""
        n = self.n_obs
        if n == 0:
            return 0
        rn = self.obs_residual_norms()
        bad = (rn > max_residual_m) & self.o_ok[:n]
        self.o_ok[:n] &= ~bad
        return int(bad.sum())

    # --- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(path, q=self.q[:self.n_poses], t=self.t[:self.n_poses],
                 e_i=self.e_i[:self.n_edges], e_j=self.e_j[:self.n_edges],
                 e_q=self.e_q[:self.n_edges], e_t=self.e_t[:self.n_edges],
                 e_info=self.e_info[:self.n_edges],
                 l_pos=self.l_pos[:self.n_landmarks],
                 o_i=self.o_i[:self.n_obs], o_l=self.o_l[:self.n_obs],
                 o_z=self.o_z[:self.n_obs], o_info=self.o_info[:self.n_obs],
                 o_ok=self.o_ok[:self.n_obs],
                 caps=np.asarray([self.K, self.E, self.M, self.O]))

    @classmethod
    def load(cls, path: str) -> "PoseGraph":
        return cls.from_arrays(np.load(path))

    @classmethod
    def from_arrays(cls, d) -> "PoseGraph":
        """A graph from the fields `save` writes (an npz or a dict)."""
        K, E, M, O = d["caps"]
        g = cls(int(K), int(E), int(M), int(O))
        n = len(d["q"])
        g.q[:n], g.t[:n] = d["q"], d["t"]
        g.n_poses = n
        ne = len(d["e_i"])
        g.e_i[:ne], g.e_j[:ne] = d["e_i"], d["e_j"]
        g.e_q[:ne], g.e_t[:ne] = d["e_q"], d["e_t"]
        g.e_info[:ne] = d["e_info"]
        g.n_edges = ne
        nl = len(d["l_pos"])
        g.l_pos[:nl] = d["l_pos"]
        g.n_landmarks = nl
        no = len(d["o_i"])
        g.o_i[:no], g.o_l[:no] = d["o_i"], d["o_l"]
        g.o_z[:no], g.o_info[:no] = d["o_z"], d["o_info"]
        if "o_ok" in d:           # older checkpoints predate the mask
            g.o_ok[:no] = d["o_ok"]
        g.n_obs = no
        return g
