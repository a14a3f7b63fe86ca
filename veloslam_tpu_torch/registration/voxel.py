"""Device voxel-Gaussian grids and the dilated dense correspondence index.

Port of veloslam_tpu/registration/voxel.py (grids, the dilated dense
index, the binary-search lookups).  Scans and maps are fixed-capacity
tables of voxel Gaussians (count / mean / covariance per occupied voxel)
sorted by packed int32 key, built with a stable sort + segment sums; F
scans build F stacked grids in one pass.  Correspondences come from a
dense (256, 256, 32) table pre-dilated over each cell's face neighbours
(one kernel gather per point), or, for stacked per-scan targets, from
seven batched binary searches (`lookup_nearest`).

Torch differs from JAX in a few ways this module handles explicitly:
sorts are `stable=True` where JAX's were stable; writes JAX dropped under
mode="drop" go to a trash row that is cut off; `jnp.median` averages the
two middle values where `torch.median` takes the lower one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from veloslam_tpu_torch.core.segment import segment_min, segment_sum
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
    (count, first and second moments about the voxel centre).  Voxels past
    `capacity` in key order are dropped.

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
    sums = segment_sum(payload.reshape(-1, 13), seg, F * n_seg
                       ).reshape(F, n_seg, 13)[:, :capacity]
    seg_keys = segment_min(torch.where(valid, sk, INVALID_KEY).reshape(-1),
                           seg, F * n_seg).reshape(F, n_seg)[:, :capacity]
    seg_keys = seg_keys.contiguous()    # searched row by row by lookup()
    count, mean, cov = _stats(sums, seg_keys, o, vs, bits)
    return VoxelGrid(keys=seg_keys, count=count, mean=mean, cov=cov,
                     origin=origin, voxel_size=voxel_size)


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
    d2 = torch.sum((pts[:, None] - mu7) ** 2, dim=-1)
    d2 = torch.where(ok7, d2, float("inf"))
    best = torch.argmin(d2, dim=1, keepdim=True)                 # (F, 1, P)
    idx = torch.gather(idx7, 1, best)[:, 0]
    return torch.where(ok7.any(dim=1), idx, -1)


def merge_stats(grid: VoxelGrid, other: VoxelGrid, *,
                capacity: int) -> VoxelGrid:
    """Merge two grids' sufficient statistics into a new grid of the given
    capacity (both must share origin and voxel size)."""
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
    sums = segment_sum(payload[order], seg_id, capacity + 1)[:capacity]
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
