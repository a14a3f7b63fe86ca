"""Patch-tiled persistent voxel-Gaussian map.

Port of veloslam_tpu/map/voxelmap.py (tiling, residency, integration,
persistence; the ROI assembly and BEV layers of the per-frame path and
the viewer are not ported yet, ROADMAP.md slice 3):

  * the world is tiled into square patches (default 100 m); each patch
    stores sufficient statistics per occupied voxel (count, Σp, Σppᵀ
    relative to the voxel centre) as host numpy, merged by absolute
    integer voxel coordinates;
  * scans are voxelized on the map's device: a chunk of 64 posed scans is
    transformed and built into 64 stacked grids in one batched pass
    (se3.apply + registration.voxel.build_grid), read back once, and
    merged on the host;
  * a resident budget with LRU spill to npz keeps host RAM bounded;
    spilled patches reload transparently on access.

The host merge (`MapPatchData.merge`, an np.unique over each touched
patch per scan) is the JAX package's, unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from veloslam_tpu_torch.config import MapConfig
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.map.landmarks import Landmarks
from veloslam_tpu_torch.registration import voxel as vx

# Fixed chunk of scans per batched transform + voxelize pass.
_BATCH_CHUNK = 64


def transform_build_chunk(pts, msk, q, t, origins, voxel_size, *,
                          capacity: int) -> vx.VoxelGrid:
    """Transform F frame-local scans (F, P, 3) by their world poses
    (q (F, 4), t (F, 3)) and voxelize each around its origin (F, 3): F
    stacked grids from one batched build."""
    pw = se3.apply(se3.Pose(q[:, None], t[:, None]), pts)
    return vx.build_grid(pw, msk, origins, voxel_size.expand(pts.shape[0]),
                         capacity=capacity)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MapPatchData:
    """Host-side per-tile store: voxel sufficient stats + landmarks."""

    def __init__(self):
        self.coords = np.zeros((0, 3), np.int32)   # absolute voxel coords
        self.count = np.zeros(0, np.float64)
        self.s1 = np.zeros((0, 3), np.float64)     # Σ(p − voxel_center)
        self.s2 = np.zeros((0, 3, 3), np.float64)  # Σ(p−c)(p−c)ᵀ
        self.landmarks = Landmarks.empty()

    @property
    def n_voxels(self) -> int:
        return len(self.count)

    def merge(self, coords: np.ndarray, count: np.ndarray, s1: np.ndarray,
              s2: np.ndarray, prune: bool = False) -> None:
        """Accumulate new voxel stats (absolute coords) into this patch.
        Negative counts subtract (downdating); with `prune`, voxels whose
        count falls below 0.5 are dropped (fp cancellation residue)."""
        all_c = np.concatenate([self.coords, coords])
        all_n = np.concatenate([self.count, count])
        all_1 = np.concatenate([self.s1, s1])
        all_2 = np.concatenate([self.s2, s2])
        uniq, inv = np.unique(all_c, axis=0, return_inverse=True)
        self.coords = uniq.astype(np.int32)
        self.count = np.zeros(len(uniq))
        self.s1 = np.zeros((len(uniq), 3))
        self.s2 = np.zeros((len(uniq), 3, 3))
        np.add.at(self.count, inv, all_n)
        np.add.at(self.s1, inv, all_1)
        np.add.at(self.s2, inv, all_2)
        if prune:
            keep = self.count >= 0.5
            self.coords = self.coords[keep]
            self.count = self.count[keep]
            self.s1 = self.s1[keep]
            self.s2 = self.s2[keep]

    def save(self, path: str) -> None:
        np.savez_compressed(path, coords=self.coords, count=self.count,
                            s1=self.s1, s2=self.s2,
                            **self.landmarks.to_arrays())

    @classmethod
    def load(cls, path: str) -> "MapPatchData":
        d = np.load(path, allow_pickle=False)
        p = cls()
        p.coords = d["coords"]
        p.count = d["count"]
        p.s1 = d["s1"]
        p.s2 = d["s2"]
        p.landmarks = Landmarks.from_arrays(d)
        return p


class VoxelMap:
    """The map manager: tiles, residency, persistence; scans are
    voxelized on `device`."""

    def __init__(self, config: Optional[MapConfig] = None,
                 spill_dir: Optional[str] = None, *, device):
        self.cfg = config or MapConfig()
        self.spill_dir = spill_dir
        self.device = torch.device(device)
        self._patches: Dict[Tuple[int, int], MapPatchData] = {}
        self._touch: Dict[Tuple[int, int], int] = {}
        self._clock = 0
        self._spilled: Dict[Tuple[int, int], str] = {}

    # --- tiling ------------------------------------------------------------

    def patch_index(self, x: float, y: float) -> Tuple[int, int]:
        s = self.cfg.patch_size_m
        return (int(np.floor(x / s)), int(np.floor(y / s)))

    def get_patch(self, x: float, y: float) -> MapPatchData:
        """Create-if-absent."""
        return self._materialize(self.patch_index(x, y), create=True)

    def find_patch(self, x: float, y: float) -> Optional[MapPatchData]:
        """None if absent."""
        return self._materialize(self.patch_index(x, y), create=False)

    def _materialize(self, idx: Tuple[int, int], create: bool
                     ) -> Optional[MapPatchData]:
        self._clock += 1
        if idx in self._patches:
            self._touch[idx] = self._clock
            return self._patches[idx]
        if idx in self._spilled:                  # transparent reload
            patch = MapPatchData.load(self._spilled.pop(idx))
            self._patches[idx] = patch
            self._touch[idx] = self._clock
            self._enforce_budget()
            return patch
        if not create:
            return None
        patch = MapPatchData()
        self._patches[idx] = patch
        self._touch[idx] = self._clock
        self._enforce_budget()
        return patch

    def _enforce_budget(self) -> None:
        while len(self._patches) > self.cfg.max_resident_patches:
            lru = min(self._touch, key=self._touch.get)
            patch = self._patches.pop(lru)
            del self._touch[lru]
            if self.spill_dir is not None:
                os.makedirs(self.spill_dir, exist_ok=True)
                path = os.path.join(self.spill_dir,
                                    f"patch_{lru[0]}_{lru[1]}.npz")
                patch.save(path)
                self._spilled[lru] = path
            # without a spill dir the evicted patch is dropped (bounded RAM)

    # --- scan integration --------------------------------------------------

    def integrate_grid(self, grid: vx.VoxelGrid, sign: float = 1.0,
                       tile_filter=None) -> None:
        """Merge a scan VoxelGrid (tensors or numpy leaves) into the map
        tiles.  With sign=-1 (count already negated by the caller) the
        merge subtracts statistics and prunes emptied voxels.
        `tile_filter` ((tx, ty) -> bool) keeps only accepted tiles: the
        tile-ownership hook of a multi-device session."""
        keys = _host(grid.keys)
        occ = keys != vx.INVALID_KEY
        if not occ.any():
            return
        keys = keys[occ]
        count = _host(grid.count)[occ].astype(np.float64)
        mean = _host(grid.mean)[occ].astype(np.float64)
        cov = _host(grid.cov)[occ].astype(np.float64)
        origin = _host(grid.origin).astype(np.float64)
        vs = float(grid.voxel_size)
        # Unpack keys to absolute integer voxel coords.
        bits = 10
        half = 1 << (bits - 1)
        axis_mask = (1 << bits) - 1
        g = np.stack([(keys >> (2 * bits)) & axis_mask,
                      (keys >> bits) & axis_mask,
                      keys & axis_mask], -1) - half
        coords = (g + np.floor(origin / vs)).astype(np.int32)
        centers = (coords + 0.5) * vs
        m_rel = mean - centers
        s1 = m_rel * count[:, None]
        s2 = (cov + m_rel[:, :, None] * m_rel[:, None, :]) * \
            count[:, None, None]

        # Group voxels by patch tile and merge.
        vox_per_tile = self.cfg.patch_size_m / vs
        tiles = np.floor(coords[:, :2] / vox_per_tile).astype(np.int64)
        uniq, inv = np.unique(tiles, axis=0, return_inverse=True)
        for i, (tx, ty) in enumerate(uniq):
            if tile_filter is not None and not tile_filter(int(tx),
                                                           int(ty)):
                continue
            sel = inv == i
            patch = self._materialize((int(tx), int(ty)), create=True)
            patch.merge(coords[sel], count[sel], s1[sel], s2[sel],
                        prune=(sign < 0))

    def integrate_points(self, pts_world: np.ndarray, mask: np.ndarray,
                         center: np.ndarray, sign: float = 1.0,
                         tile_filter=None) -> None:
        """Build one scan's grid around `center` on the device, then
        integrate it.  The grid origin is snapped to the voxel lattice so
        packed keys map exactly onto absolute voxel coordinates.
        `sign=-1` subtracts the scan's sufficient statistics."""
        vs = self.cfg.voxel_size
        origin = np.floor(np.asarray(center, np.float64) / vs) * vs
        dev = self.device
        grid = vx.build_grid(
            torch.as_tensor(np.asarray(pts_world, np.float32), device=dev),
            torch.as_tensor(np.asarray(mask, bool), device=dev),
            torch.as_tensor(origin.astype(np.float32), device=dev),
            torch.tensor(vs, dtype=torch.float32, device=dev),
            capacity=self.cfg.voxels_per_patch)
        if sign != 1.0:
            grid = grid._replace(count=grid.count * sign)
        self.integrate_grid(grid, sign=sign, tile_filter=tile_filter)

    def integrate_scans_batch(self, pts, msk, q, t, signs=None,
                              tile_filter=None) -> None:
        """Integrate K posed scans: `pts` (K, P, 3) frame-local points with
        `msk` (K, P), `q`/`t` (K, 4)/(K, 3) world poses, optional per-scan
        `signs` (−1 downdates).  Each chunk of `_BATCH_CHUNK` scans (the
        last padded with empty scans at identity poses) is transformed and
        voxelized in one batched pass on the device and read back once."""
        K = len(pts)
        if K == 0:
            return
        vs = self.cfg.voxel_size
        signs = (np.ones(K, np.float64) if signs is None
                 else np.asarray(signs, np.float64))
        origins = np.floor(np.asarray(t, np.float64)[:, :3] / vs) * vs
        # A scan of P points occupies at most P voxels.
        cap = min(self.cfg.voxels_per_patch, int(pts.shape[1]))
        ch = _BATCH_CHUNK
        pts = np.asarray(pts, np.float32)
        msk = np.asarray(msk, bool)
        q = np.asarray(q, np.float32)
        t = np.asarray(t, np.float32)
        dev = self.device
        vs_dev = torch.tensor(vs, dtype=torch.float32, device=dev)
        for s0 in range(0, K, ch):
            n = min(ch, K - s0)
            pad = ch - n

            def padded(a, s0=s0, n=n, pad=pad):
                sl = a[s0:s0 + n]
                if pad:
                    sl = np.concatenate(
                        [sl, np.zeros((pad,) + a.shape[1:], a.dtype)])
                return torch.as_tensor(sl, device=dev)

            pq = padded(q)
            if pad:
                pq[n:, 0] = 1.0          # identity quats in pad slots
            grids = transform_build_chunk(
                padded(pts), padded(msk), pq, padded(t),
                padded(origins.astype(np.float32)), vs_dev, capacity=cap)
            host = vx.VoxelGrid(*(_host(x[:n]) for x in grids))
            for k in range(n):
                g = vx.VoxelGrid(
                    keys=host.keys[k],
                    count=host.count[k] * signs[s0 + k],
                    mean=host.mean[k], cov=host.cov[k],
                    origin=host.origin[k], voxel_size=host.voxel_size[k])
                self.integrate_grid(g, sign=float(signs[s0 + k]),
                                    tile_filter=tile_filter)

    def deintegrate_points(self, pts_world: np.ndarray, mask: np.ndarray,
                           center: np.ndarray) -> None:
        """Remove a previously integrated scan's contribution: subtract its
        statistics and prune voxels whose count falls to ~zero (the exact
        inverse of integrate_points for the same points)."""
        self.integrate_points(pts_world, mask, center, sign=-1.0)

    # --- persistence -------------------------------------------------------

    def save(self, dirname: str) -> None:
        os.makedirs(dirname, exist_ok=True)
        idx: List[Tuple[int, int]] = []
        for key, patch in self._patches.items():
            patch.save(os.path.join(dirname, f"patch_{key[0]}_{key[1]}.npz"))
            idx.append(key)
        for key, path in self._spilled.items():
            # spilled patches already on disk; copy into the map dir
            if os.path.dirname(path) != dirname:
                MapPatchData.load(path).save(
                    os.path.join(dirname, f"patch_{key[0]}_{key[1]}.npz"))
            idx.append(key)
        np.savez(os.path.join(dirname, "map_index.npz"),
                 tiles=np.asarray(idx, np.int64).reshape(-1, 2),
                 patch_size_m=self.cfg.patch_size_m,
                 voxel_size=self.cfg.voxel_size)

    @classmethod
    def load(cls, dirname: str, config: Optional[MapConfig] = None,
             spill_dir: Optional[str] = None, *, device) -> "VoxelMap":
        idx = np.load(os.path.join(dirname, "map_index.npz"))
        m = cls(config or MapConfig(), spill_dir=spill_dir, device=device)
        for tx, ty in idx["tiles"]:
            path = os.path.join(dirname, f"patch_{tx}_{ty}.npz")
            # registered as spilled: loaded on first touch
            m._spilled[(int(tx), int(ty))] = path
        return m

    @property
    def n_patches(self) -> int:
        return len(self._patches) + len(self._spilled)
