"""Device voxel-Gaussian grids and the dilated dense correspondence index.

Port of veloslam_tpu/registration/voxel.py (grids, the dense and
dilated dense indexes, the binary-search lookups).  Scans and maps are
fixed-capacity tables of voxel Gaussians (count / mean / covariance per
occupied voxel) sorted by packed int32 key, built with a stable sort +
segment sums; F scans build F stacked grids in one pass.
Correspondences come from a dense (256, 256, 32) table pre-dilated over
each cell's face neighbours (one kernel gather per point), from the plain
dense table with the nearest mean among a point's own cell and its six
face neighbours (`lookup_nearest_dense`: seven kernel gathers per point),
or, for stacked per-scan targets, from seven batched binary searches
(`lookup_nearest`).

Torch differs from JAX in a few ways this module handles explicitly:
sorts are `stable=True` where JAX's were stable; writes JAX dropped under
mode="drop" go to a trash row that is cut off; `jnp.median` averages the
two middle values where `torch.median` takes the lower one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from veloslam_tpu_torch.core.segment import segment_min, segment_sum_sorted
from veloslam_tpu_torch.registration.gather import gather_i32

# Sentinel for missing/invalid voxel keys (sorts last).  It is also the
# identity of an int32 segment minimum, so empty segments come out invalid.
INVALID_KEY = 2**31 - 1


class VoxelGrid(NamedTuple):
    """Fixed-capacity voxel-Gaussian table, sorted by packed key.

    Padding rows have key == INVALID_KEY and count == 0.  F stacked grids
    (per-scan targets) carry a leading F on every leaf.
    """

    keys: torch.Tensor        # (V,) int32, sorted ascending
    count: torch.Tensor       # (V,) float32
    mean: torch.Tensor        # (V, 3) float32
    cov: torch.Tensor         # (V, 3, 3) float32 (population covariance)
    origin: torch.Tensor      # (3,) float32 — key-space origin (world)
    voxel_size: torch.Tensor  # () float32

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    @property
    def occupied(self) -> torch.Tensor:
        return self.keys != INVALID_KEY


def _grid_coords(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed keys → integer key-space coordinates (..., 3)."""
    m = (1 << bits) - 1
    return torch.stack([(keys >> (2 * bits)) & m, (keys >> bits) & m,
                        keys & m], dim=-1)


def pack_keys(pts, mask, origin, voxel_size, bits: int = 10):
    """Points (..., 3) → packed int32 voxel keys; masked/out-of-range →
    INVALID_KEY."""
    half = 2 ** (bits - 1)
    g = torch.floor((pts - origin) / voxel_size).to(torch.int32) + half
    in_range = torch.all((g >= 0) & (g < 2 ** bits), dim=-1)
    key = (g[..., 0] << (2 * bits)) | (g[..., 1] << bits) | g[..., 2]
    return torch.where(mask & in_range, key, INVALID_KEY)


def unpack_keys(keys, origin, voxel_size, bits: int = 10):
    """Packed keys → voxel centre coordinates (..., 3)."""
    g = _grid_coords(keys, bits).to(torch.float32) - 2 ** (bits - 1)
    return origin + (g + 0.5) * voxel_size


def _segments(sk: torch.Tensor, capacity: int):
    """Sorted keys (..., P) → (valid mask, segment id per row along the
    last axis); invalid rows and voxels past `capacity` go to the trash
    segment `capacity`."""
    valid = sk != INVALID_KEY
    first = torch.ones_like(sk[..., :1], dtype=torch.bool)
    new_seg = torch.cat([first, sk[..., 1:] != sk[..., :-1]], dim=-1) & valid
    seg_id = torch.cumsum(new_seg.to(torch.int32), -1, dtype=torch.int32) - 1
    seg_id = torch.where(valid, torch.clamp(seg_id, max=capacity), capacity)
    return valid, seg_id


def _stats(sums: torch.Tensor, seg_keys, origin, voxel_size,
           bits: int = 10):
    """(count, Σ rel, Σ rel·relᵀ) rows (..., 13) → (count, mean, cov),
    moments taken relative to each voxel's centre."""
    count = sums[..., 0]
    denom = torch.clamp(count, min=1.0)[..., None]
    mean_rel = sums[..., 1:4] / denom
    cov = sums[..., 4:13].reshape(*sums.shape[:-1], 3, 3) / denom[..., None] \
        - mean_rel[..., :, None] * mean_rel[..., None, :]
    mean = mean_rel + unpack_keys(seg_keys, origin, voxel_size, bits)
    return count, mean, cov


def build_grid(pts, mask, origin, voxel_size, *, capacity: int,
               bits: int = 10) -> VoxelGrid:
    """Build a voxel-Gaussian grid from (P, 3) points + validity mask:
    stable sort by key → segment ids → one 13-channel segment sum
    (count, first and second moments about the voxel centre), each
    voxel's rows added in key order, so a build repeats to the bit on the
    card.  Voxels past `capacity` in key order are dropped.

    A batch of F independent scans, pts (F, P, 3) with origin (F, 3) and
    voxel_size (F,), gives F stacked grids (every leaf with a leading F):
    each row is sorted on its own and its segments are offset by
    f·(capacity + 1), so the result equals F separate builds."""
    if pts.dim() == 2:
        g = build_grid(pts[None], mask[None], origin[None],
                       voxel_size.reshape(1), capacity=capacity, bits=bits)
        return VoxelGrid(*(x[0] for x in g))
    F = pts.shape[0]
    o = origin[:, None, :]
    vs = voxel_size[:, None, None]
    keys = pack_keys(pts, mask, o, vs, bits)                     # (F, P)
    sk, order = torch.sort(keys, dim=-1, stable=True)
    valid, seg_id = _segments(sk, capacity)
    n_seg = capacity + 1
    seg = (seg_id + n_seg * torch.arange(F, dtype=torch.int32,
                                         device=pts.device)[:, None]
           ).reshape(-1)
    # Moments relative to each point's own voxel centre keep float32
    # covariances well-conditioned at map-scale coordinates.
    sp = (torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
          - unpack_keys(sk, o, vs, bits))
    w = valid.to(torch.float32)[..., None]
    outer = (sp[..., :, None] * sp[..., None, :]).reshape(F, -1, 9)
    payload = torch.cat([w, sp * w, outer * w], dim=-1)        # (F, P, 13)
    sums = segment_sum_sorted(payload, seg_id, capacity)      # (F, V, 13)
    seg_keys = segment_min(torch.where(valid, sk, INVALID_KEY).reshape(-1),
                           seg, F * n_seg).reshape(F, n_seg)[:, :capacity]
    seg_keys = seg_keys.contiguous()    # searched row by row by lookup()
    count, mean, cov = _stats(sums, seg_keys, o, vs, bits)
    return VoxelGrid(keys=seg_keys, count=count, mean=mean, cov=cov,
                     origin=origin, voxel_size=voxel_size)


def stack1(grid: VoxelGrid) -> VoxelGrid:
    """One grid as F = 1 stacked grids (views), for `lookup_nearest`."""
    return VoxelGrid(*(x[None] for x in grid))


def lookup(grid: VoxelGrid, query_keys) -> torch.Tensor:
    """Rows of query keys in the grid (−1 where absent): a binary search
    over the sorted keys, then one kernel gather of the key found there.

    grid.keys (V,) with query_keys (Q,), or stacked grids (F, V) with
    query_keys (F, Q) searched row by row."""
    keys = grid.keys.reshape(-1, grid.keys.shape[-1])
    q = query_keys.reshape(keys.shape[0], -1)
    V = keys.shape[-1]
    idx = torch.clamp(torch.searchsorted(keys, q), 0, V - 1).to(torch.int32)
    row0 = V * torch.arange(keys.shape[0], dtype=torch.int32,
                            device=keys.device)[:, None]
    found = gather_i32(keys.reshape(-1), (idx + row0).reshape(-1)
                       ).reshape(q.shape)
    out = torch.where((found == q) & (q != INVALID_KEY), idx, -1)
    return out.reshape(query_keys.shape)


def lookup_nearest(grid: VoxelGrid, pts, mask, usable,
                   bits: int = 10) -> torch.Tensor:
    """Row of the nearest usable voxel Gaussian among each point's own
    voxel and its 6 face neighbours (−1 if none), for F stacked grids
    (leaves with a leading F) and points (F, P, 3): seven key searches in
    one batched lookup, then the mean-distance argmin (first minimum wins,
    as jnp.argmin)."""
    F, P = mask.shape
    keys = pack_keys(pts, mask, grid.origin[:, None, :],
                     grid.voxel_size[:, None, None], bits)      # (F, P)
    # Python-int offsets: a tensor of them would cost a host-to-device
    # copy, which synchronizes the stream.
    offsets = (0, 1, -1, 1 << bits, -(1 << bits), 1 << (2 * bits),
               -(1 << (2 * bits)))
    cand = torch.where((keys == INVALID_KEY)[:, None, :], INVALID_KEY,
                       torch.stack([keys + o for o in offsets], dim=1))
    idx7 = lookup(grid, cand.reshape(F, -1)).reshape(F, 7, P)
    safe = torch.clamp(idx7, min=0).reshape(F, -1).long()
    ok7 = (idx7 >= 0) & torch.gather(usable, 1, safe).reshape(F, 7, P)
    mu7 = torch.gather(grid.mean, 1, safe[..., None].expand(-1, -1, 3)
                       ).reshape(F, 7, P, 3)
    # (x² + y²) + z² in this order on every device, as the JAX original
    # sums on the CPU (a device reduction may add in another order and
    # break a near tie the other way).
    d = pts[:, None] - mu7
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(ok7, d2, float("inf"))
    best = torch.argmin(d2, dim=1, keepdim=True)                 # (F, 1, P)
    idx = torch.gather(idx7, 1, best)[:, 0]
    return torch.where(ok7.any(dim=1), idx, -1)


def merge_stats(grid: VoxelGrid, other: VoxelGrid, *,
                capacity: int) -> VoxelGrid:
    """Merge two grids' sufficient statistics into a new grid of the given
    capacity (both must share origin and voxel size), each voxel's rows
    added in key order, as build_grid does."""
    def moments(g: VoxelGrid):
        # Padding rows contribute zero via count == 0.
        c = g.count[:, None]
        m_rel = g.mean - unpack_keys(g.keys, g.origin, g.voxel_size)
        s2 = (g.cov + m_rel[:, :, None] * m_rel[:, None, :]) * c[..., None]
        return torch.cat([c, m_rel * c, s2.reshape(-1, 9)], dim=1)

    keys = torch.cat([grid.keys, other.keys])
    payload = torch.cat([moments(grid), moments(other)])
    sk, order = torch.sort(keys, stable=True)
    valid, seg_id = _segments(sk, capacity)
    sums = segment_sum_sorted(payload[order][None], seg_id[None],
                              capacity)[0]
    seg_keys = segment_min(torch.where(valid, sk, INVALID_KEY), seg_id,
                           capacity + 1)[:capacity]
    count, mean, cov = _stats(sums, seg_keys, grid.origin, grid.voxel_size)
    return VoxelGrid(keys=seg_keys, count=count, mean=mean, cov=cov,
                     origin=grid.origin, voxel_size=grid.voxel_size)


def rebase_grid(grid: VoxelGrid, new_center, bits: int = 10) -> VoxelGrid:
    """Shift the key-space origin to the voxel-aligned `new_center` and
    re-key every voxel (voxels leaving the ±2^(bits−1) window are
    dropped); re-sorts so lookups stay valid.  Statistics are unchanged."""
    d = torch.round((new_center - grid.origin) / grid.voxel_size
                    ).to(torch.int32)                          # (3,) voxels
    new_origin = grid.origin + d.to(torch.float32) * grid.voxel_size
    axis_mask = (1 << bits) - 1
    g = _grid_coords(grid.keys, bits) - d
    ok = grid.occupied & torch.all((g >= 0) & (g < (1 << bits)), dim=-1)
    gc = torch.clamp(g, 0, axis_mask)
    new_keys = torch.where(
        ok, (gc[:, 0] << (2 * bits)) | (gc[:, 1] << bits) | gc[:, 2],
        INVALID_KEY)
    sk, order = torch.sort(new_keys, stable=True)
    return VoxelGrid(
        keys=sk, count=torch.where(ok, grid.count, 0.0)[order],
        mean=grid.mean[order], cov=grid.cov[order],
        origin=new_origin, voxel_size=grid.voxel_size)


# --- dense spatial index (O(1) lookup) ---------------------------------------

class DenseIndex(NamedTuple):
    """Direct-mapped 3-D index over a box of the grid's key space:
    `table[x, y, z]` holds the grid row of that voxel, or −1."""

    table: torch.Tensor     # (X, Y, Z) int32
    lo: torch.Tensor        # (3,) int32 — key-space coords of table[0,0,0]


def _in_box(rel: torch.Tensor, shape) -> torch.Tensor:
    """All of rel (..., 3) inside [0, shape) per axis.  Python-int bounds:
    a bounds tensor built from a list would cost a host-to-device copy,
    which synchronizes the stream."""
    inside = torch.all(rel >= 0, dim=-1)
    for axis, size in enumerate(shape):
        inside = inside & (rel[..., axis] < size)
    return inside


def median_midpoint(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """jnp.median semantics: float median that AVERAGES the two middle
    values of an even count (torch.median returns the lower one)."""
    s = torch.sort(x, dim=dim).values.to(torch.float32)
    n = x.shape[dim]
    hi = s.select(dim, n // 2)
    if n % 2:
        return hi
    return (s.select(dim, n // 2 - 1) + hi) / 2.0


def build_dense_index(grid: VoxelGrid, *, shape=(256, 256, 32),
                      bits: int = 10) -> DenseIndex:
    """Scatter the grid's occupied rows into a dense box centred on the
    occupied voxels' median coordinate."""
    half = 1 << (bits - 1)
    occ = grid.occupied
    g = _grid_coords(grid.keys, bits)                          # (V, 3)
    med = median_midpoint(torch.where(occ[:, None], g, half), dim=0)
    X, Y, Z = shape
    lo = torch.stack([med[i].to(torch.int32) - size // 2
                      for i, size in enumerate(shape)])
    rel = g - lo
    inside = occ & _in_box(rel, shape)
    rows = torch.arange(grid.capacity, dtype=torch.int32, device=g.device)
    # Rows outside the box land in a trash cell past the end.
    flat = torch.where(inside, (rel[:, 0] * Y + rel[:, 1]) * Z + rel[:, 2],
                       X * Y * Z)
    table = torch.full((X * Y * Z + 1,), -1, dtype=torch.int32,
                       device=g.device)
    table.scatter_(0, flat.long(), rows)
    return DenseIndex(table=table[:-1].reshape(X, Y, Z), lo=lo)


def lookup_nearest_dense(grid: VoxelGrid, dense: DenseIndex, pts, mask,
                         usable, bits: int = 10,
                         approx_centers: bool = False) -> torch.Tensor:
    """Row of the nearest usable voxel Gaussian among each point's own
    cell and its 6 face neighbours (−1 if none), through the dense index:
    the 7·P table reads are one kernel gather, then the squared distance
    to each candidate's mean (or, with `approx_centers`, its voxel
    centre) and the first minimum wins, as jnp.argmin; the winner is
    taken by a 7-way select, as in the JAX original.  pts (P, 3), mask
    and the result (P,)."""
    half = 1 << (bits - 1)
    g = (torch.floor((pts - grid.origin) / grid.voxel_size).to(torch.int32)
         + half - dense.lo)                                    # (P, 3)
    X, Y, Z = dense.table.shape
    # Python-int offsets (a tensor of them would be a host-to-device copy).
    offsets = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
               (1, 0, 0), (-1, 0, 0))
    cand = torch.stack([torch.stack([g[:, 0] + dx, g[:, 1] + dy,
                                     g[:, 2] + dz], dim=-1)
                        for dx, dy, dz in offsets])            # (7, P, 3)
    inside = _in_box(cand, (X, Y, Z)) & mask[None, :]
    flat = ((torch.clamp(cand[..., 0], 0, X - 1) * Y
             + torch.clamp(cand[..., 1], 0, Y - 1)) * Z
            + torch.clamp(cand[..., 2], 0, Z - 1))             # (7, P)
    idx7 = gather_i32(dense.table.reshape(-1),
                      flat.reshape(-1)).reshape(flat.shape)
    safe = torch.clamp(idx7, min=0).long()
    ok7 = inside & (idx7 >= 0) & usable[safe]
    if approx_centers:
        ref = ((cand + dense.lo - half).to(torch.float32) + 0.5) \
            * grid.voxel_size + grid.origin
    else:
        ref = grid.mean[safe]                                  # (7, P, 3)
    d = pts[None] - ref
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(ok7, d2, float("inf"))
    best = torch.argmin(d2, dim=0)                             # (P,)
    sel = best[None, :] == torch.arange(7, device=best.device)[:, None]
    idx = torch.sum(torch.where(sel, idx7, 0), dim=0, dtype=torch.int32)
    return torch.where(ok7.any(dim=0), idx, -1)


def window_coverage(grid: VoxelGrid, usable, lo, shape,
                    bits: int = 10) -> torch.Tensor:
    """Fraction of usable voxels inside the index window [lo, lo+shape):
    makes the silent truncation of the dense table observable.  1.0 for
    grids with no usable voxel."""
    rel = _grid_coords(grid.keys, bits) - lo
    want = grid.occupied & usable
    inside = want & _in_box(rel, shape)
    denom = torch.clamp(want.sum(), min=1)
    return torch.where(want.any(),
                       inside.sum().to(torch.float32)
                       / denom.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=lo.device))


class DilatedIndex(NamedTuple):
    """Dense index whose cells are PRE-DILATED over the 7-cell face
    neighbourhood: `table[x, y, z]` holds the row of a usable voxel in the
    cell itself or (fixed priority: self, ±z, ±y, ±x) one of its face
    neighbours, or −1."""

    table: torch.Tensor     # (X, Y, Z) int32 — usable row for the cell, or −1
    lo: torch.Tensor        # (3,) int32 — key-space coords of table[0,0,0]


def _shift_fill(a: torch.Tensor, axis: int, d: int, fill) -> torch.Tensor:
    """Shift along `axis` by d (±1), filling the vacated edge (no wrap):
    out[i] = a[i − d]."""
    n = a.shape[axis]
    out = torch.full_like(a, fill)
    if d > 0:
        out.narrow(axis, 1, n - 1).copy_(a.narrow(axis, 0, n - 1))
    else:
        out.narrow(axis, 0, n - 1).copy_(a.narrow(axis, 1, n - 1))
    return out


def build_dilated_index(grid: VoxelGrid, usable, *, shape=(256, 256, 32),
                        bits: int = 10) -> DilatedIndex:
    """Build a DilatedIndex for the USABLE voxels of `grid` (usable is the
    per-row gate from gicp.plane_grid_from)."""
    base = build_dense_index(grid, shape=shape, bits=bits)
    t = base.table
    ok = (t >= 0) & usable[torch.clamp(t, min=0).long()]
    src = torch.where(ok, t, -1)      # usable cells only (dilation source)
    sel_t, sel_ok = src, ok
    # ±z first: vertical neighbours usually continue the same surface.
    for axis, d in ((2, 1), (2, -1), (1, 1), (1, -1), (0, 1), (0, -1)):
        ct = _shift_fill(src, axis, d, -1)
        cok = _shift_fill(ok, axis, d, False)
        take = ~sel_ok & cok
        sel_t = torch.where(take, ct, sel_t)
        sel_ok = sel_ok | take
    return DilatedIndex(table=sel_t, lo=base.lo)


def lookup_dilated(grid: VoxelGrid, dil: DilatedIndex, pts, mask,
                   bits: int = 10) -> torch.Tensor:
    """Row of a usable voxel for each point via the pre-dilated table: one
    kernel gather per point (−1 for misses)."""
    half = 1 << (bits - 1)
    g = (torch.floor((pts - grid.origin) / grid.voxel_size).to(torch.int32)
         + half - dil.lo)                                       # (..., 3)
    X, Y, Z = dil.table.shape
    inside = _in_box(g, (X, Y, Z)) & mask
    flat = ((torch.clamp(g[..., 0], 0, X - 1) * Y
             + torch.clamp(g[..., 1], 0, Y - 1)) * Z
            + torch.clamp(g[..., 2], 0, Z - 1))
    idx = gather_i32(dil.table.reshape(-1), flat.reshape(-1))
    return torch.where(inside, idx.reshape(flat.shape), -1)


# --- closed-form 3x3 symmetric eigen-analysis --------------------------------

def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor determinant of (..., 3, 3) (no batched LU launch)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def eigvals3(cov: torch.Tensor, eps: float = 1e-12):
    """Cardano eigenvalues of batched symmetric (..., 3, 3), descending
    (λ1 ≥ λ2 ≥ λ3)."""
    q = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = cov - q[..., None, None] * _eye3(cov)
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=eps * eps))
    r = torch.clamp(_det3(b) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    return l1, l2, l3


def smallest_eigenvector(cov: torch.Tensor, eps: float = 1e-9):
    """Unit eigenvector of the smallest eigenvalue for batched symmetric
    (..., 3, 3) matrices — the plane normal of a voxel Gaussian
    (Cardano eigenvalue + largest row cross product; +z when isotropic)."""
    eye = _eye3(cov)
    a = cov + eps * eye
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(b) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    c = a - lam_min[..., None, None] * eye
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(n > 1e-12, v / torch.clamp(n, min=1e-12), fallback)


# --- weights of the distribution-matching costs (D2D, NDT) -------------------

def _nullspace_dir(c: torch.Tensor) -> torch.Tensor:
    """Largest row cross product of (..., 3, 3): an approximate null
    direction (unnormalized); the first of equal norms wins, as
    jnp.argmax."""
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    best = torch.argmax(torch.linalg.vector_norm(cands, dim=-1), dim=-1)
    return torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)


def _frame(cov: torch.Tensor, l1: torch.Tensor):
    """Orthonormal eigenvectors (v1, v2, v3) of the largest, middle and
    smallest eigenvalue: v3 from `smallest_eigenvector`, v1 the null
    direction of cov − λ1·I orthogonalized against v3 (any perpendicular
    when that vanishes), v2 = v3 × v1."""
    v3 = smallest_eigenvector(cov)
    v1 = _nullspace_dir(cov - l1[..., None, None] * _eye3(cov))
    v1 = v1 - torch.sum(v1 * v3, -1, keepdim=True) * v3
    n1 = torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    ex = torch.zeros_like(v3)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v3)
    ey[..., 1] = 1.0
    alt = torch.linalg.cross(v3, torch.where(torch.abs(v3[..., :1]) < 0.9,
                                             ex, ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    v1 = torch.where(n1 > 1e-12, v1 / torch.clamp(n1, min=1e-12), alt)
    return v1, torch.linalg.cross(v3, v1), v3


def _outer(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return w[..., None, None] * v[..., :, None] * v[..., None, :]


def clamped_inverse(cov: torch.Tensor, floor_ratio: float = 0.01,
                    eps: float = 1e-9) -> torch.Tensor:
    """Eigenvalue-clamped inverse for classic NDT weighting:
    W = Σᵢ vᵢvᵢᵀ / max(λᵢ, floor_ratio·λ₁), so the condition number is at
    most 1/floor_ratio.  Closed form; where eigenvalues tie, the clamped
    weights tie too and the ill-defined directions do not change W."""
    l1, l2, l3 = eigvals3(cov)
    l1 = torch.clamp(l1, min=eps)
    v1, v2, v3 = _frame(cov, l1)
    floor = floor_ratio * l1
    return (_outer(v1, 1.0 / torch.maximum(l1, floor))
            + _outer(v2, 1.0 / torch.maximum(l2, floor))
            + _outer(v3, 1.0 / torch.maximum(l3, floor)))


def normalized_cov(cov: torch.Tensor, floor: float = 1e-3,
                   plane_inflation: float = 100.0) -> torch.Tensor:
    """Scale-normalized covariance for D2D and robust NDT weighting: each
    eigenvalue becomes max(λᵢ/λ₁, floor), the two in-plane ones plus
    planarity²·plane_inflation, eigenvectors kept.  Normalizing by λ₁
    makes the weight scale-free; the inflation lets a planar voxel act
    point-to-plane (its in-plane mean follows the sensor's sampling, not
    the surface) while corner and edge voxels keep their 3-D shape."""
    l1, l2, l3 = eigvals3(cov)
    l1 = torch.clamp(l1, min=1e-12)
    v1, v2, v3 = _frame(cov, l1)
    planarity = torch.clamp((l2 - l3) / l1, 0.0, 1.0)
    infl = planarity * planarity * plane_inflation
    return (_outer(v1, torch.clamp(l1 / l1, min=floor) + infl)
            + _outer(v2, torch.clamp(l2 / l1, min=floor) + infl)
            + _outer(v3, torch.clamp(l3 / l1, min=floor)))


def structure_usable(grid: VoxelGrid, *, min_points: float = 4.0,
                     max_linearity: float = 0.9) -> torch.Tensor:
    """Target gate of the distribution-matching costs: occupied, at least
    `min_points`, and not line-like (linearity (λ₁ − λ₂)/λ₁ below
    `max_linearity`; a one-ring arc's mean follows the sensor)."""
    l1, l2, _ = eigvals3(grid.cov)
    linearity = (l1 - l2) / torch.clamp(l1, min=1e-12)
    return (grid.occupied & (grid.count >= min_points)
            & (linearity < max_linearity))


def regularized_inverse(cov: torch.Tensor, eps: float = 1e-3
                        ) -> torch.Tensor:
    """Batched (Σ + εI)⁻¹ of (..., 3, 3) by the closed-form adjugate over
    the cofactor determinant (the JAX original divides by an LU
    determinant: the two agree to float32 rounding)."""
    a = cov + eps * _eye3(cov)
    adj = torch.stack([
        a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
        a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
        a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
        a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
        a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
        a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
        a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
        a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
        a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
    ], dim=-1).reshape(a.shape)
    return adj / _det3(a)[..., None, None]
