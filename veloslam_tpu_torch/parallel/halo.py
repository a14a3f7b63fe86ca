"""Cross-shard halo exchange for spatially-sharded correspondence search.

Port of veloslam_tpu/parallel/halo.py.  The default distributed
registration (parallel.sharded) replicates the scan and shards the map.
This module is the complementary pattern for when the *queries* are also
sharded: each rank owns a contiguous key range of the sorted voxel table,
and the ±1-voxel neighbour lookups of points near a range boundary need
the neighbour shard's edge voxels.  A ring exchange (two sends and two
receives per rank, `dist.ring_exchange`) gives each shard its
neighbours' boundary bands once per target.

Production entry points:
  * `register_halo_sharded` — Gauss-Newton registration with BOTH the map
    and the query points sharded: points routed to the rank owning their
    voxel key range (`partition_points_by_key_ranges`), each rank matching
    only its haloed local table, and per GN iteration the normal-equations
    kernel's NE-only pass on the rank's points, one all_reduce of H, b,
    err·n and n, and the replicated step.
  * `required_halo` — the exact per-side band width that makes boundary
    lookups equal to the unsharded oracle for a given table and shard
    count.

The host helpers (`required_halo`, `halo_is_exact`, `_clamp_halo`,
`_pack_keys_np`, `partition_points_by_key_ranges`) are numpy copies of
the JAX package's, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.parallel import dist
from veloslam_tpu_torch.parallel.mesh import Mesh
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.gicp import PlaneGrid, make_plane_grid
from veloslam_tpu_torch.registration.normal_equations import (
    _gn_delta_shifted)

HALO = 256          # default boundary rows exchanged per side


def _pack_band(shard: PlaneGrid, sl: slice) -> torch.Tensor:
    """Rows `sl` of a shard as one (rows, 18) float32 buffer [key's int32
    bits, count, μ, Σ, normal, usable], so a band is one message."""
    g = shard.grid
    rows = g.keys[sl].shape[0]
    return torch.cat([g.keys[sl].view(torch.float32)[:, None],
                      g.count[sl][:, None], g.mean[sl],
                      g.cov[sl].reshape(rows, 9), shard.normal[sl],
                      shard.usable[sl].to(torch.float32)[:, None]], dim=1)


def _unpack_band(buf: torch.Tensor):
    rows = buf.shape[0]
    return (buf[:, 0].contiguous().view(torch.int32), buf[:, 1],
            buf[:, 2:5], buf[:, 5:14].reshape(rows, 3, 3), buf[:, 14:17],
            buf[:, 17] > 0.5)


def exchange_and_extend(mesh: Mesh, target: PlaneGrid, axis: str = "map",
                        halo: int = HALO) -> PlaneGrid:
    """Given this rank's shard of a row-sharded PlaneGrid, return it
    extended by its ring neighbours' boundary bands (capacity grows by
    2·halo rows): the previous rank's last `halo` rows and the next rank's
    first `halo` rows, concatenated and re-sorted by key (stable).

    After this, a point whose voxel lies within `halo` rows of a shard
    boundary finds its ±1-neighbour voxels locally.  Ring wrap: shard 0's
    "left neighbour" is the last shard, whose keys are all larger —
    harmless (lookups never match them).  A request above rows-per-shard
    is clamped WITH a RuntimeWarning (one hop fetches immediate
    neighbours only) — check `halo_is_exact` when it matters."""
    n_shards = mesh.shape[axis]
    rows = target.grid.keys.shape[0]
    halo = _clamp_halo(halo, rows * n_shards, n_shards,
                       "exchange_and_extend")
    lo_band = _pack_band(target, slice(0, halo))
    hi_band = _pack_band(target, slice(rows - halo, rows))
    from_left, from_right = dist.ring_exchange(mesh, hi_band, lo_band,
                                               axis=axis)
    L, R = _unpack_band(from_left), _unpack_band(from_right)
    g = target.grid
    own = (g.keys, g.count, g.mean, g.cov, target.normal, target.usable)
    keys, count, mean, cov, normal, usable = (
        torch.cat([a, b, c]) for a, b, c in zip(L, own, R))
    order = torch.sort(keys, stable=True).indices
    grid = vx.VoxelGrid(keys=keys[order], count=count[order],
                        mean=mean[order].contiguous(),
                        cov=cov[order].contiguous(), origin=g.origin,
                        voxel_size=g.voxel_size)
    return make_plane_grid(grid, normal[order].contiguous(), usable[order])


def _pack_keys_np(pts: np.ndarray, mask: np.ndarray, origin: np.ndarray,
                  voxel_size: float, bits: int = 10) -> np.ndarray:
    """Host-numpy mirror of voxel.pack_keys (int64 to dodge overflow).

    The quotient is computed in float32 to MATCH the device semantics
    bit-for-bit: a point whose coordinate rounds differently across
    precisions would be routed to a different shard than the one whose
    haloed table contains its device-packed voxel."""
    g = np.floor((np.asarray(pts, np.float32) - np.asarray(origin,
                                                           np.float32))
                 / np.float32(voxel_size)).astype(np.int64)
    return np.where(np.asarray(mask, bool), vx.pack_coords_np(g, bits),
                    np.int64(vx.INVALID_KEY))


def required_halo(table_keys, n_shards: int, bits: int = 10) -> int:
    """Smallest per-side band width for which every ±1-voxel neighbour
    lookup resolves inside the querying point's haloed shard.

    The ±x neighbour is `1 << (2*bits)` away in key space — up to a full
    x-plane of occupied voxels away in ROW space.  Per shard boundary,
    this counts the neighbour rows within one key stride of the boundary
    key `right_first` (the routing split point): a query may sit in an
    unoccupied voxel anywhere in the key gap spanning the boundary, so the
    left shard's probes reach up to `right_first - 1 + stride` and the
    right shard's down to `right_first - stride`.  Returns the max; add a
    few rows of slack if the pose will move points across voxel
    boundaries during optimization."""
    keys = np.asarray(table_keys).astype(np.int64)
    per = keys.shape[0] // n_shards
    stride = np.int64(1 << (2 * bits))
    need = 1
    for s in range(1, n_shards):
        b = s * per
        right_first = keys[b]
        if right_first >= vx.INVALID_KEY:
            continue                      # right side is padding only
        n_right = int(np.searchsorted(keys[b:], right_first + stride,
                                      side="left"))
        n_left = b - int(np.searchsorted(keys[:b], right_first - stride,
                                         side="left"))
        need = max(need, n_right, n_left)
    return need


def halo_is_exact(table_keys, n_shards: int, halo: int,
                  bits: int = 10) -> bool:
    """Whether a per-side band of `halo` rows (after the per-shard-row
    clamp of `exchange_and_extend` / `register_halo_sharded`) covers every
    boundary lookup — i.e. the sharded result equals the unsharded
    oracle."""
    per = np.asarray(table_keys).shape[0] // n_shards
    return min(int(halo), per) >= required_halo(table_keys, n_shards, bits)


def _clamp_halo(halo: int, rows: int, n_shards: int, where: str) -> int:
    """One ring hop can fetch at most a full neighbour shard; warn when the
    requested band is reduced below what the caller asked for."""
    import warnings
    per = rows // n_shards
    if halo > per:
        warnings.warn(
            f"{where}: requested halo {halo} exceeds rows-per-shard {per}; "
            f"clamped — boundary lookups may diverge from the unsharded "
            f"oracle (check halo_is_exact/required_halo)",
            RuntimeWarning, stacklevel=3)
    return min(int(halo), per)


def partition_points_by_key_ranges(table_keys, pts, mask, origin,
                                   voxel_size, n_shards: int, *,
                                   bits: int = 10, pad_multiple: int = 128):
    """Host-side query router: group points by the shard owning their
    voxel key range (shard s owns table rows [s·V/D, (s+1)·V/D)).

    Returns (pts_out (D·C, 3), mask_out (D·C,)) laid out shard-major and
    padded to a common per-shard capacity C — rank s takes block s.
    Invalid/out-of-range points land on shard 0 with mask False."""
    pts = np.asarray(pts, np.float32)
    mask = np.asarray(mask, bool)
    keys = _pack_keys_np(pts, mask, origin, voxel_size, bits)
    valid = mask & (keys != vx.INVALID_KEY)
    tkeys = np.asarray(table_keys).astype(np.int64)
    per_rows = tkeys.shape[0] // n_shards
    boundaries = tkeys[per_rows * np.arange(1, n_shards)]
    owner = np.searchsorted(boundaries, keys, side="right")
    owner = np.where(valid, owner, 0)
    counts = np.bincount(owner[valid], minlength=n_shards)
    cap = max(int(counts.max()), 1)
    cap = -(-cap // pad_multiple) * pad_multiple
    out_p = np.zeros((n_shards, cap, 3), np.float32)
    out_m = np.zeros((n_shards, cap), bool)
    for s in range(n_shards):
        idx = np.nonzero(valid & (owner == s))[0]
        out_p[s, :len(idx)] = pts[idx]
        out_m[s, :len(idx)] = True
    return out_p.reshape(-1, 3), out_m.reshape(-1)


def register_halo_sharded(mesh: Mesh, pts, mask, target: PlaneGrid,
                          init_pose: se3.Pose, *, axis: str = "map",
                          iterations: int = 16, damping: float = 1e-6,
                          huber_delta: float = 0.5, max_dist: float = 2.0,
                          halo: int = HALO,
                          reassociate_every: int = 1) -> gicp.GicpResult:
    """Gauss-Newton registration with the map AND the scan sharded.

    `pts` / `mask` are this rank's block of the routed points
    (`partition_points_by_key_ranges`), `target` this rank's row block.
    One halo exchange extends the shard; then, with the production
    association schedule (shard-local binary search every
    `reassociate_every` iterations against the haloed table), each GN
    iteration is the normal-equations kernel's NE-only pass on this
    rank's points, ONE all_reduce of H, b, err·n and n (44 floats), and
    the replicated damped step H + (damping + 1e-6·trace H)·I, guard,
    clamp and retraction, as the JAX package writes it.  Exactness
    requires halo ≥ required_halo(...) plus slack for the pose
    correction; a request above rows-per-shard is clamped WITH a
    RuntimeWarning."""
    n_shards = mesh.shape[axis]
    halo = _clamp_halo(halo, target.grid.keys.shape[0] * n_shards,
                       n_shards, "register_halo_sharded")
    ext = exchange_and_extend(mesh, target, axis=axis, halo=halo)
    dev = pts.device
    pose = se3.Pose(init_pose.q[None].contiguous(),
                    init_pose.t[None].contiguous())
    pts_f, mask_f = pts[None].contiguous(), mask[None]
    err = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    n_hit = torch.zeros((), dtype=torch.int32, device=dev)
    k = max(int(reassociate_every), 1)
    done = 0
    while done < iterations:
        n_block = min(k, iterations - done)
        mu, n, hit = gicp.associate(pts_f, mask_f, pose, ext)
        for _ in range(n_block):
            H, b, err_l, n_l = gicp.normal_equations_fixed(
                pts_f, pose, mu, n, hit, huber_delta=huber_delta,
                max_dist=max_dist)
            sums = dist.all_reduce(mesh, torch.cat([
                H.reshape(-1), b.reshape(-1), err_l * n_l,
                n_l.to(torch.float32)]), axis=axis)
            n_all = sums[43:44]
            err = sums[42] / torch.clamp(n_all[0], min=1.0)
            n_hit = n_all[0].to(torch.int32)
            delta = _gn_delta_shifted(sums[:36].reshape(1, 6, 6),
                                      sums[36:42].reshape(1, 6),
                                      n_all.to(torch.int32), damping)[0]
            pose = se3.retract(pose, delta)
        done += n_block
    return gicp.GicpResult(pose=se3.Pose(pose.q[0], pose.t[0]),
                           n_matched=n_hit, mean_error=err,
                           iterations=iterations,
                           H=sums[:36].reshape(6, 6) if iterations else
                           torch.zeros((6, 6), device=dev))


def sharded_query_local(mesh: Mesh, extended: PlaneGrid, pts, mask,
                        axis: str = "map"):
    """Raw sharded lookup: this rank's block of points matched only
    against its (haloed) local table.  Returns this block's voxel means
    (0 where missed) and hit mask."""
    del mesh, axis
    idx = vx.lookup_nearest(vx.stack1(extended.grid), pts[None], mask[None],
                            extended.usable[None])[0]
    hit = idx >= 0
    mu = extended.grid.mean[torch.clamp(idx, min=0).long()]
    return torch.where(hit[:, None], mu, 0.0), hit
