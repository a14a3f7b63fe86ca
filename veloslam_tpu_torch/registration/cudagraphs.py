"""The per-frame GICP chain on the card as two CUDA graphs.

Each frame of the per-frame pipeline registers one scan against the
map's ROI (a VoxelGrid of fixed capacity) through its dense index.
Around the Gauss-Newton iterations that chain is a few hundred small
launches at fixed shapes, with no host sync inside it: the target
(`gicp.plane_grid_from` + `voxel.build_dense_index`) once a frame and one
correspondence search (`gicp.associate`) every `reassociate_every`
iterations.  `GicpGraphs` captures the two over static inputs and
outputs, once, on the first frame's own scan, prior and ROI, and
replays them:

  (A) the target, from a static copy of the ROI's leaves;
  (B) one association, from the static scan, mask and pose.

The iterations themselves stay eager: `gicp.register` runs its loop as
always, one `normal_equations._launch` an iteration, with (B) standing
in for `associate` through `register_batch`'s `association` argument.
A replay runs the captured kernels on the same inputs, so a frame's
result equals the eager chain's to the bit.

Each replay of (A) is the stage `register_graph` and the capture the
stage `register_graph_capture`.  The gather launches a replay makes are
added to `gather.LAUNCHES`; those the capture recorded, which never ran,
are not.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import gather, gicp
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.utils import profiling
from veloslam_tpu_torch.utils.profiling import sync_span


class GicpGraphs:
    """The target and association graphs of one pipeline, at the shapes
    of `roi` (capacity V) and of an `n_points`-point scan on the ROI's
    card.  `register` registers a frame at those shapes; its first call
    warms both chains up and captures them on that frame's own data."""

    def __init__(self, roi: vx.VoxelGrid, n_points: int, *,
                 min_points: int, min_planarity: float):
        dev = roi.keys.device
        P = n_points
        self.n_points = P
        self.plane_args = dict(min_points=min_points,
                               min_planarity=min_planarity)
        # Static inputs.  The upload: points, prior q and t, mask as 0/1.
        self.roi = vx.VoxelGrid(*(torch.empty_like(x) for x in roi))
        self.upload = torch.empty(3 * P + 7 + P, dtype=torch.float32,
                                  device=dev)
        self.pts = self.upload[:3 * P].view(1, P, 3)
        self.prior = se3.Pose(self.upload[3 * P:3 * P + 4],
                              self.upload[3 * P + 4:3 * P + 7])
        self.mask = torch.zeros((1, P), dtype=torch.bool, device=dev)
        self.pose = se3.Pose.identity((1,), device=dev)
        self.graph_target = None

    def _fits(self, roi: vx.VoxelGrid, n_points: int) -> bool:
        return n_points == self.n_points and all(
            a.shape == b.shape and a.dtype == b.dtype
            and a.device == b.device for a, b in zip(roi, self.roi))

    def _target(self):
        return (gicp.plane_grid_from(self.roi, **self.plane_args),
                vx.build_dense_index(self.roi))

    def _capture(self) -> None:
        """Warm both chains up on a side stream, on the loaded frame at
        its prior, as the eager path's first association sees it (every
        kernel loaded, every library handle made), then capture each on
        it."""
        dev = self.upload.device
        self.pose.q.copy_(self.prior.q)
        self.pose.t.copy_(self.prior.t)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            target, dense = self._target()
            gicp.associate(self.pts, self.mask, self.pose, target, dense)
            del target, dense
            self.graph_target, self.launches_target, (
                self.target, self.dense) = _record(self._target)
            self.graph_assoc, self.launches_assoc, (
                self.mu, self.n, self.hit) = _record(
                    lambda: gicp.associate(self.pts, self.mask, self.pose,
                                           self.target, self.dense))
        torch.cuda.current_stream(dev).wait_stream(side)

    @staticmethod
    def _replay(graph, launches: Dict[str, int]) -> None:
        graph.replay()
        for k, v in launches.items():
            gather.LAUNCHES[k] += v

    def associate(self, pts, mask, pose: se3.Pose, target, dense):
        """`gicp.associate` of the static scan and mask against the
        static target at `pose`, by graph (B).  `register_batch` passes
        those static tensors as pts, mask, target and dense."""
        self.pose.q.copy_(pose.q)
        self.pose.t.copy_(pose.t)
        self._replay(self.graph_assoc, self.launches_assoc)
        return self.mu, self.n, self.hit

    def register(self, pts: np.ndarray, mask: np.ndarray,
                 T_prior: se3.Pose, roi: vx.VoxelGrid,
                 **kw) -> gicp.GicpResult:
        """One frame: host points (P, 3), mask (P,), the host prior, the
        ROI on the card; `kw` as `gicp.register`.  The scan, the prior
        and the mask go up in one upload.  The first call captures the
        graphs (the stage `register_graph_capture`).  A frame at other
        shapes than the graphs' is a ValueError: a pipeline's config
        fixes them (`max_points`, `voxels_per_patch`)."""
        if not self._fits(roi, len(pts)):
            raise ValueError(
                f"a {len(pts)}-point scan and an ROI of "
                f"{[tuple(x.shape) for x in roi]} on {roi.keys.device}: "
                f"the graphs were captured at {self.n_points} points and "
                f"{[tuple(x.shape) for x in self.roi]} on "
                f"{self.roi.keys.device}")
        host = np.concatenate([pts.reshape(-1), T_prior.q.numpy(),
                               T_prior.t.numpy(),
                               mask.astype(np.float32)])
        with sync_span(self.upload):
            self.upload.copy_(torch.from_numpy(host))
        P = self.n_points
        torch.ne(self.upload[3 * P + 7:], 0.0, out=self.mask[0])
        for dst, src in zip(self.roi, roi):
            dst.copy_(src)
        if self.graph_target is None:
            with profiling.stage("register_graph_capture"):
                self._capture()
        with profiling.stage("register_graph"):
            self._replay(self.graph_target, self.launches_target)
        return gicp.register(self.pts[0], self.mask[0], self.target,
                             self.prior, self.dense,
                             association=self.associate, **kw)


def _record(chain):
    """Capture `chain()` into a new graph on the current stream: (the
    graph, the gather launches a replay of it makes, chain's outputs,
    which each replay rewrites in place).  The garbage collector waits
    meanwhile: collecting another pipeline's graph would free it, and
    its memory pool, in the middle of the capture."""
    before: Dict[str, int] = dict(gather.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = chain()
        finally:
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    launches = {k: gather.LAUNCHES[k] - before[k] for k in before}
    gather.LAUNCHES.update(before)            # captured, not run
    return graph, launches, out
