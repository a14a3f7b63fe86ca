"""Multi-process SLAM session: the full pipeline over a tile-partitioned map.

Port of veloslam_tpu/parallel/session.py.  Each rank owns the map tiles
hashing to it (dist.tile_owner), registers against the ROI made of every
rank's owned rows (each rank's own rows are its map shard,
sharded.register_sharded: one all_gather per association block), writes
scans only into its own tiles, and solves the pose graph with its edges
and observations split over the ranks (sharded.solve_graph_sharded: one
all_reduce per GN iteration).  Host control flow (keyframes, loop
closure, graph) is deterministic and replicated, so every rank computes
the identical trajectory — there is no leader.

Run under `dist.init_distributed` (or `dist.spawn_ranks`): Gloo between
CPU processes in the tests and between ranks sharing one card, NCCL with
one rank per card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.parallel import dist, sharded
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.runtime.pipeline import (FrameRegistration,
                                                 SlamPipeline, crop_graph)


class DistributedSlamSession(SlamPipeline):
    """SlamPipeline whose map is partitioned across ranks.

    Overrides the pipeline's multi-device primitives:
      * `_integrate_scan` / `_tile_filter` keep only this rank's tiles;
      * `_register_frame` registers against the map sharded over the
        ranks' owned rows;
      * `_solve_graph` / `_solve_graph_landmarks` run the edge-sharded
        solves.
    Everything else (decode, compensation, keyframes, loop closure,
    landmarks, checkpointing) is inherited unchanged and runs replicated.
    The mesh is `mesh`, or all ranks on the "map" axis on `device`.
    """

    # ROI refresh cadence: the assembled target is reused for up to this
    # many frames (and until the vehicle leaves the map tile it was built
    # in) — registration against a few-frames-stale map, the
    # approximation the batched odometry makes, for one scalar allgather
    # per refresh instead of per frame.
    roi_refresh_frames: int = 4

    def __init__(self, config: Optional[SlamConfig] = None,
                 spill_dir: Optional[str] = None, mesh=None,
                 device="cuda"):
        super().__init__(config, spill_dir=spill_dir,
                         device=mesh.device if mesh is not None else device)
        self.mesh = mesh if mesh is not None else dist.global_mesh(
            self.device, data_axis=1)
        self.pid = dist.process_index()
        self.n_procs = dist.process_count()
        self._roi_cache = None   # {"tile", "frame", "target", "dense"}

    # --- ownership -----------------------------------------------------------

    def owns_tile(self, tx: int, ty: int) -> bool:
        return int(dist.tile_owner(tx, ty, self.n_procs)) == self.pid

    def _integrate_scan(self, pts_world, mask, center, map_obj=None,
                        sign: float = 1.0) -> None:
        (map_obj or self.map).integrate_points(
            pts_world, mask, center=center, sign=sign,
            tile_filter=self.owns_tile)

    def _tile_filter(self):
        return self.owns_tile

    # --- map-sharded registration ---------------------------------------------

    def _roi_rows(self, x: float, y: float):
        """This rank's owned ROI as its map shard (a PlaneGrid on the
        device, the common capacity) and its occupied row count.  Empty
        owned content still yields full-capacity INVALID rows at the
        shared origin, so every shard has the same size."""
        rc = self.cfg.registration
        cap = self.cfg.map.voxels_per_patch
        roi = self.map.roi_grid(x, y, capacity=cap)
        if roi is None:
            vs = self.cfg.map.voxel_size
            origin = np.array([np.floor(x / vs) * vs, np.floor(y / vs) * vs,
                               0.0], np.float32)
            rows = [np.full(cap, vx.INVALID_KEY, np.int32),
                    np.zeros(cap, np.float32),
                    np.zeros((cap, 3), np.float32),
                    np.zeros((cap, 3, 3), np.float32),
                    np.zeros((cap, 3), np.float32), np.zeros(cap, bool)]
            return (dist.assemble_global_plane_grid(
                self.mesh, rows, origin, np.float32(vs)), 0)
        pg = gicp.plane_grid_from(roi, min_points=rc.min_points_per_voxel,
                                  min_planarity=rc.min_planarity)
        return pg, int((roi.keys != vx.INVALID_KEY).sum())

    def _global_roi(self, x: float, y: float):
        """This rank's shard of the registration target (and its dense
        index), cached across frames: rebuilt only when the vehicle
        crosses into another map tile or the cache is
        `roi_refresh_frames` frames old.  Whether any rank holds content
        comes from the ranks' row counts (one scalar allgather per
        refresh); an empty map is not cached (the very next frame may
        integrate the first content)."""
        tile = self.map.patch_index(x, y)
        n_seen = len(self.trajectory)
        c = self._roi_cache
        if (c is not None and c["tile"] == tile
                and n_seen - c["frame"] < self.roi_refresh_frames):
            return c["target"], c["dense"], True
        target, local_n = self._roi_rows(x, y)
        total = int(np.sum(dist.allgather(
            self.mesh, np.asarray([local_n], np.int64))))
        dense = (sharded.build_dense_sharded(self.mesh, target)
                 if self.cfg.registration.use_dense_index else None)
        if total > 0:
            self._roi_cache = {"tile": tile, "frame": n_seen,
                               "target": target, "dense": dense}
        else:
            self._roi_cache = None
        return target, dense, total > 0

    def _register_frame(self, pts: np.ndarray, mask: np.ndarray,
                        T_prior: se3.Pose) -> Optional[FrameRegistration]:
        """GICP of the frame against the map sharded over the ranks (the
        session registers by GICP whatever `registration.method` says,
        as the JAX session does); None while no rank holds content."""
        rc = self.cfg.registration
        prior_t = T_prior.t.numpy()
        dev = self.device
        with self.timers.stage("register"):
            target, dense, has = self._global_roi(float(prior_t[0]),
                                                  float(prior_t[1]))
            if not has:
                return None
            P = len(pts)
            buf = torch.as_tensor(np.concatenate(
                [pts.reshape(-1), T_prior.q.numpy(), T_prior.t.numpy()]),
                device=dev)
            pts_dev = buf[:3 * P].reshape(P, 3)
            mask_dev = torch.as_tensor(mask, device=dev)
            prior = se3.Pose(buf[3 * P:3 * P + 4], buf[3 * P + 4:])
            res = sharded.register_sharded(
                self.mesh, pts_dev, mask_dev, target, prior,
                iterations=rc.max_iterations, damping=rc.damping,
                huber_delta=rc.huber_delta,
                max_dist=rc.max_correspondence_dist,
                reassociate_every=rc.reassociate_every,
                use_dense=rc.use_dense_index, dense=dense)
            out = torch.cat([res.pose.q, res.pose.t,
                             res.n_matched.to(torch.float32)[None],
                             res.mean_error[None]]).cpu()
        return FrameRegistration(pose=se3.Pose(out[:4], out[4:7]),
                                 n_matched=int(out[7]),
                                 mean_error=float(out[8]))

    # --- edge-sharded pose-graph solves ----------------------------------------

    def _solve_graph(self) -> None:
        """Distributed Gauss-Newton over the mesh: per-rank assembly of
        its edges, the all_reduce'd normal equations, the replicated
        dense solve.  Cropped to the occupied power-of-two buckets like
        the single-process path (crop_graph; the bucket floors
        128/64/512/512 are multiples of 8, so they split over 2, 4 or 8
        ranks)."""
        g = self.graph
        Kc, cropped, _ = crop_graph(g.arrays(self.device), g.n_poses, 0,
                                    g.n_edges, 0)
        out, _ = sharded.solve_graph_sharded(
            self.mesh, cropped, max_poses=Kc,
            iterations=self.cfg.graph.gn_iterations)
        g.update_from(out.q[:g.n_poses].cpu().numpy(),
                      out.t[:g.n_poses].cpu().numpy())

    def _solve_graph_landmarks(self) -> None:
        g = self.graph
        Kc, cropped, Mc = crop_graph(g.arrays(self.device), g.n_poses,
                                     g.n_landmarks, g.n_edges, g.n_obs)
        out, _ = sharded.solve_graph_sharded(
            self.mesh, cropped, max_poses=Kc, max_landmarks=Mc,
            iterations=self.cfg.graph.gn_iterations, with_landmarks=True)
        g.update_from(out.q[:g.n_poses].cpu().numpy(),
                      out.t[:g.n_poses].cpu().numpy(),
                      out.l_pos[:g.n_landmarks].cpu().numpy())

    # --- diagnostics -----------------------------------------------------------

    def owned_tiles(self):
        return sorted(set(self.map._patches) | set(self.map._spilled))
