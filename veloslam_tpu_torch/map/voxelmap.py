"""Patch-tiled persistent voxel-Gaussian map.

Port of veloslam_tpu/map/voxelmap.py (tiling, residency, integration,
the ROI assembly of the per-frame pipeline, persistence, the BEV viewer's
layers):

  * the world is tiled into square patches (default 100 m); each patch
    stores sufficient statistics per occupied voxel (count, Σp, Σppᵀ
    relative to the voxel centre) as host numpy, merged by absolute
    integer voxel coordinates;
  * every scan enters the tiles through one device step (`_integrate`):
    up to `_BATCH_CHUNK` posed scans go up in one packed upload, are
    transformed and built into stacked grids in one batched pass
    (se3.apply + registration.voxel.build_grid), come back in one packed
    readback, and are merged on the host scan by scan, in the order
    given.  Eager torch rounds each op once, so a scan's grid is the same
    whatever else shares its chunk, and the device transform equals the
    same float32 ops on the host;
  * `roi_grid` assembles the patches within ±roi_range of a query point
    into one fixed-capacity VoxelGrid on the map's device, keys packed
    relative to the query (host numpy, one upload): the per-frame
    pipeline's registration target;
  * a resident budget with LRU spill to npz keeps host RAM bounded;
    spilled patches reload transparently on access.

The host merge (`MapPatchData.merge`) keeps each tile's rows in the
order np.unique gives them and merges a scan by looking its voxels up
among them, in time linear in the tile: the JAX package's re-sort of the
whole tile per scan, to the bit (it remains the fallback).
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
from veloslam_tpu_torch.utils.profiling import stage, sync_span

# Most scans per device step: bounds the step's device memory.
_BATCH_CHUNK = 64
# Bits an axis of a tile merge's lookup key: three axes in an int64.
_KEY_BITS = 21
# The row shapes of a tile's fields: coords, count, s1, s2.
_ROW_SHAPES = ((3,), (), (3,), (3, 3))


def transform_build_chunk(pts, msk, q, t, origins, voxel_size, *,
                          capacity: int) -> vx.VoxelGrid:
    """Transform F frame-local scans (F, P, 3) by their world poses
    (q (F, 4), t (F, 3)) and voxelize each around its origin (F, 3): F
    stacked grids from one batched build."""
    pw = se3.apply(se3.Pose(q[:, None], t[:, None]), pts)
    return vx.build_grid(pw, msk, origins, voxel_size.expand(pts.shape[0]),
                         capacity=capacity)


def _rows(a: np.ndarray) -> np.ndarray:
    """A 1-D view of the rows of a 2-D array, one opaque item a row:
    indexing it moves whole rows at once."""
    return a.view(np.dtype((np.void, a.itemsize * a.shape[1])))[:, 0]


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
        count falls below 0.5 are dropped (fp cancellation residue).

        The rows stay sorted by (x, y, z), as np.unique orders them.  The
        scan's voxels are looked up among them by a packed key, added to
        the rows they have or inserted where they sort: the same arrays,
        to the bit, as re-sorting the whole tile (`_merge_resort`), which
        stays the path for inputs the lookup does not take (a span of
        2^21 voxels or more on an axis, a voxel twice in one scan, fields
        not in the form a merge leaves them).  The tile's other rows are
        copied as they are: a merge leaves no -0.0 in them for the
        re-sort's 0 + old to turn into +0.0."""
        with stage("map_merge"):
            if not self._merge_lookup(coords, count, s1, s2, prune):
                with stage("map_merge_resort"):
                    self._merge_resort(coords, count, s1, s2, prune)

    def _merge_lookup(self, coords, count, s1, s2, prune: bool) -> bool:
        """The merge by sorted-key lookup; False, with nothing changed,
        where it does not apply."""
        tile = (self.coords, self.count, self.s1, self.s2)
        scan = tuple(np.asarray(x) for x in (coords, count, s1, s2))
        n, m = len(self.coords), len(scan[0])
        shapes = [(k,) + w for k in (n, m) for w in _ROW_SHAPES]
        dtypes = (np.int32, np.float64, np.float64, np.float64) * 2
        if any(a.shape != w or a.dtype != d
               for a, w, d in zip(tile + scan, shapes, dtypes)):
            return False
        if n + m == 0:
            return True
        # Keys relative to the common per-axis minimum, _KEY_BITS an
        # axis, so that they order as (x, y, z) lexicographically.
        axes = np.concatenate([self.coords, scan[0]]).T.copy()
        lo = axes.min(axis=1)
        if (axes.max(axis=1).astype(np.int64) - lo >= 1 << _KEY_BITS).any():
            return False
        rel = (axes - lo[:, None]).astype(np.int64)
        keys = (rel[0] << 2 * _KEY_BITS) | (rel[1] << _KEY_BITS) | rel[2]
        tkeys, skeys = keys[:n], keys[n:]
        order = np.argsort(skeys)
        skeys = skeys[order]
        if (tkeys[1:] <= tkeys[:-1]).any() or \
                (skeys[1:] <= skeys[:-1]).any():
            return False
        pos = np.searchsorted(tkeys, skeys)
        hit = pos < n
        hit[hit] = tkeys[pos[hit]] == skeys[hit]
        new = ~hit
        # Each scan voxel's row in the merged tile: its row in the tile,
        # or its place after the tile's rows and the new voxels that sort
        # before it.
        dest = pos + np.cumsum(new) - new
        at_hit, to_hit, to_new = pos[hit], dest[hit], dest[new]
        total = n + len(to_new)
        from_tile = np.ones(total, bool)
        from_tile[to_new] = False
        out = []
        for old, add, shape in zip(tile, scan, _ROW_SHAPES):
            width = int(np.prod(shape))
            old = np.ascontiguousarray(old.reshape(n, width))
            add = np.take(add.reshape(m, width), order, axis=0)
            o = np.empty((total, width), old.dtype)
            rows = _rows(o)
            rows[from_tile] = _rows(old)
            if old.dtype != np.int32:
                # As np.add.at onto zeros: 0 + new, and old + new where
                # old (never -0.0) is 0 + old already.
                add += 0.0
                o[to_hit] = np.take(old, at_hit, axis=0) + \
                    np.compress(hit, add, axis=0)
            rows[to_new] = _rows(add)[new]
            out.append(o)
        if prune:
            keep = out[1][:, 0] >= 0.5
            if not keep.all():
                out = [_rows(o)[keep].view(o.dtype).reshape(-1, o.shape[1])
                       for o in out]
        self.coords, self.count, self.s1, self.s2 = (
            o.reshape((len(o),) + shape)
            for o, shape in zip(out, _ROW_SHAPES))
        return True

    def _merge_resort(self, coords, count, s1, s2, prune: bool) -> None:
        """The merge by re-sorting the whole tile (np.unique)."""
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
        """Merge a scan VoxelGrid (numpy leaves) into the map tiles.  With
        sign=-1 (count already negated by the caller) the merge subtracts
        statistics and prunes emptied voxels.  `tile_filter` ((tx, ty) ->
        bool) keeps only accepted tiles: the tile-ownership hook of a
        multi-device session."""
        keys = np.asarray(grid.keys)
        occ = keys != vx.INVALID_KEY
        if not occ.any():
            return
        count = np.asarray(grid.count)[occ].astype(np.float64)
        mean = np.asarray(grid.mean)[occ].astype(np.float64)
        cov = np.asarray(grid.cov)[occ].astype(np.float64)
        origin = np.asarray(grid.origin).astype(np.float64)
        vs = float(grid.voxel_size)
        # Keys → absolute integer voxel coords.
        coords = (vx.unpack_coords_np(keys[occ])
                  + np.floor(origin / vs)).astype(np.int32)
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

    def _integrate(self, pts, msk, q, t, origins, signs,
                   tile_filter) -> None:
        """The one device step every scan enters the tiles by: K scans
        `pts` (K, P, 3) with `msk` (K, P), world poses `q`/`t` (K, 4)/
        (K, 3), key origins (K, 3) on the voxel lattice and signs (K,),
        in chunks of at most `_BATCH_CHUNK` scans.  A chunk is one
        float32 upload (points, mask as 0/1, q, t, origins, the voxel
        size), `transform_build_chunk`, and one int32 readback (per scan
        its keys, then the bits of its count, mean and cov); then each
        scan is merged, in the order given."""
        K = len(pts)
        P = int(np.shape(pts)[1]) if K else 0
        if P == 0:
            return
        vs = np.float32(self.cfg.voxel_size)
        # A scan of P points occupies at most P voxels.
        cap = min(self.cfg.voxels_per_patch, P)
        origins = np.asarray(origins, np.float32)
        dev = self.device
        for s0 in range(0, K, _BATCH_CHUNK):
            sl = slice(s0, min(s0 + _BATCH_CHUNK, K))
            parts = [pts[sl], msk[sl], q[sl], t[sl], origins[sl], vs]
            buf = np.concatenate([np.asarray(x, np.float32).reshape(-1)
                                  for x in parts])
            with sync_span(dev):
                up = torch.as_tensor(buf, device=dev)
            n = sl.stop - s0
            p_d, m_d, q_d, t_d, o_d, vs_d = torch.split(
                up, [n * P * 3, n * P, n * 4, n * 3, n * 3, 1])
            g = transform_build_chunk(
                p_d.view(n, P, 3), m_d.view(n, P) != 0, q_d.view(n, 4),
                t_d.view(n, 3), o_d.view(n, 3), vs_d, capacity=cap)
            # Integer copies move the float bits as they are.
            packed = torch.cat([x.reshape(n, -1) for x in (
                g.keys, g.count.view(torch.int32), g.mean.view(torch.int32),
                g.cov.view(torch.int32))], 1)
            with sync_span(packed):
                host = packed.cpu().numpy()
            keys, stats = host[:, :cap], host[:, cap:].view(np.float32)
            for k in range(n):
                sign = float(signs[s0 + k])
                self.integrate_grid(vx.VoxelGrid(
                    keys=keys[k], count=stats[k, :cap] * sign,
                    mean=stats[k, cap:4 * cap].reshape(cap, 3),
                    cov=stats[k, 4 * cap:].reshape(cap, 3, 3),
                    origin=origins[s0 + k], voxel_size=vs),
                    sign=sign, tile_filter=tile_filter)

    def _origins(self, centers) -> np.ndarray:
        """Key origins (K, 3): the scan centres snapped down to the voxel
        lattice, so packed keys map exactly onto absolute voxel coords."""
        vs = self.cfg.voxel_size
        return np.floor(np.asarray(centers, np.float64) / vs) * vs

    def integrate_points(self, pts_world: np.ndarray, mask: np.ndarray,
                         center: np.ndarray, sign: float = 1.0,
                         tile_filter=None) -> None:
        """Integrate one world-frame scan (P, 3), its grid keyed about
        `center`: the device step at the identity pose.  `sign=-1`
        subtracts the scan's sufficient statistics."""
        self._integrate(np.asarray(pts_world)[None], np.asarray(mask)[None],
                        np.array([[1.0, 0.0, 0.0, 0.0]]), np.zeros((1, 3)),
                        self._origins(np.asarray(center)[None]), [sign],
                        tile_filter)

    def integrate_scans_batch(self, pts, msk, q, t, signs=None,
                              tile_filter=None) -> None:
        """Integrate K posed scans: `pts` (K, P, 3) frame-local points with
        `msk` (K, P), `q`/`t` (K, 4)/(K, 3) world poses, optional per-scan
        `signs` (−1 downdates), each keyed about its pose's position and
        merged in the order given."""
        signs = np.ones(len(pts)) if signs is None else signs
        self._integrate(pts, msk, q, t, self._origins(t), signs, tile_filter)

    def deintegrate_points(self, pts_world: np.ndarray, mask: np.ndarray,
                           center: np.ndarray) -> None:
        """Remove a previously integrated scan's contribution: subtract its
        statistics and prune voxels whose count falls to ~zero (the exact
        inverse of integrate_points for the same points)."""
        self.integrate_points(pts_world, mask, center, sign=-1.0)

    def bev_layers(self, *, max_cells: int = 20000, min_count: float = 4.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(occupancy_xy, post_xy) across all patches, resident and
        spilled, for the BEV artifact (utils.viewer): the centres of cells
        with at least `min_count` points, strided down to at most
        `max_cells`, and the landmark posts' xy."""
        occ, posts = [], []
        for idx in sorted(set(self._patches) | set(self._spilled)):
            patch = self._materialize(idx, create=False)
            if patch is None:
                continue
            sel = patch.count >= min_count
            occ.append((patch.coords[sel, :2] + 0.5) * self.cfg.voxel_size)
            if len(patch.landmarks.posts):
                posts.append(patch.landmarks.posts[:, :2])
        occ_xy = (np.concatenate(occ) if occ else np.zeros((0, 2)))
        if len(occ_xy) > max_cells:
            step = int(np.ceil(len(occ_xy) / max_cells))
            occ_xy = occ_xy[::step]
        posts_xy = (np.concatenate(posts) if posts else np.zeros((0, 2)))
        return occ_xy, posts_xy

    # --- ROI assembly (the registration working set) -----------------------

    def roi_patches(self, x: float, y: float) -> List[Tuple[int, int]]:
        """Tiles overlapping ±roi_range around (x, y)."""
        r = self.cfg.roi_range_m
        s = self.cfg.patch_size_m
        x0, x1 = int(np.floor((x - r) / s)), int(np.floor((x + r) / s))
        y0, y1 = int(np.floor((y - r) / s)), int(np.floor((y + r) / s))
        return [(ix, iy) for ix in range(x0, x1 + 1)
                for iy in range(y0, y1 + 1)
                if (ix, iy) in self._patches or (ix, iy) in self._spilled]

    def roi_grid(self, x: float, y: float, *, capacity: Optional[int] = None
                 ) -> Optional[vx.VoxelGrid]:
        """Assemble the ROI as one VoxelGrid on the map's device, centred
        near the query (keys packed relative to the query point, so the
        ±512-voxel packed range covers the ROI wherever it lies); the
        voxels nearest the query first when the ROI holds more than
        `capacity`.  None when no tile around the query holds a voxel."""
        cap = capacity or self.cfg.voxels_per_patch
        tiles = self.roi_patches(x, y)
        if not tiles:
            return None
        coords_l, count_l, s1_l, s2_l = [], [], [], []
        for t in tiles:
            p = self._materialize(t, create=False)
            if p is None or p.n_voxels == 0:
                continue
            coords_l.append(p.coords)
            count_l.append(p.count)
            s1_l.append(p.s1)
            s2_l.append(p.s2)
        if not coords_l:
            return None
        coords = np.concatenate(coords_l)
        count = np.concatenate(count_l)
        s1 = np.concatenate(s1_l)
        s2 = np.concatenate(s2_l)
        vs = self.cfg.voxel_size
        # Keep only voxels inside the ROI box.
        centers = (coords + 0.5) * vs
        r = self.cfg.roi_range_m
        keep = (np.abs(centers[:, 0] - x) <= r) & \
            (np.abs(centers[:, 1] - y) <= r)
        coords, count, s1, s2 = (coords[keep], count[keep], s1[keep],
                                 s2[keep])
        centers = centers[keep]
        if len(coords) > cap:                      # nearest-first truncation
            d2 = (centers[:, 0] - x) ** 2 + (centers[:, 1] - y) ** 2
            sel = np.argsort(d2)[:cap]
            coords, count, s1, s2 = (coords[sel], count[sel], s1[sel],
                                     s2[sel])
            centers = centers[sel]

        origin = np.array([np.floor(x / vs) * vs, np.floor(y / vs) * vs, 0.0],
                          np.float32)
        keys = vx.pack_coords_np(coords
                                 - np.floor(origin / vs).astype(np.int64))
        ok = keys != vx.INVALID_KEY
        keys, count, s1, s2, centers = (keys[ok], count[ok], s1[ok], s2[ok],
                                        centers[ok])
        order = np.argsort(keys)
        n = min(len(order), cap)
        denom = np.maximum(count[order], 1.0)[:, None]
        mean_rel = s1[order] / denom
        cov = s2[order] / denom[..., None] \
            - mean_rel[:, :, None] * mean_rel[:, None, :]
        mean = mean_rel + centers[order]

        # One float32 buffer, one upload: [keys (int32 bits), count,
        # mean, cov] per row, then origin and the voxel size.
        rows = np.zeros((cap, 14), np.float32)
        rows[:, 0] = np.full(cap, vx.INVALID_KEY, np.int32).view(np.float32)
        rows[:n, 0] = keys[order][:n].astype(np.int32).view(np.float32)
        rows[:n, 1] = count[order][:n]
        rows[:n, 2:5] = mean[:n]
        rows[:n, 5:14] = cov[:n].reshape(-1, 9)
        buf = np.concatenate([rows.T.reshape(-1), origin,
                              np.asarray([vs], np.float32)])
        with sync_span(self.device):
            dev = torch.as_tensor(buf, device=self.device)
        cols = dev[:14 * cap].reshape(14, cap)
        return vx.VoxelGrid(
            keys=cols[0].contiguous().view(torch.int32),
            count=cols[1].contiguous(),
            mean=cols[2:5].T.contiguous(),
            cov=cols[5:14].T.reshape(cap, 3, 3).contiguous(),
            origin=dev[14 * cap:14 * cap + 3],
            voxel_size=dev[14 * cap + 3])

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
