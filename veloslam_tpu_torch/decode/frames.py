"""Streaming frame assembly and gather-based frame sampling.

Port of veloslam_tpu/decode/frames.py:

  * `assemble_frames` (the per-frame pipeline): each call consumes one
    decoded batch plus the open-frame carry and scatters every point into
    dense per-beam frame slots (S, L, MAX_F): wrap flags → cumsum frame
    ids → one scatter per channel.  The JAX original's scatter lets a
    repeated index write in an undefined order; here the last write of
    each cell wins, chosen by an integer max, so the result is the same on
    every device.  Per-frame reductions are integer or min/max, which no
    order changes.
  * `sample_frames` (the bulk-odometry fast path): decode output is
    frame-contiguous (firing blocks in time order), so a frame is a block
    range of the (N*12, 32) decode array plus the open-frame carry.  Per
    frame, the `points_per_frame` valid points with the smallest 16-bit
    multiplicative hash of their assembled flat index (laser·max_firings +
    firing position) are selected with one stable (slot | hash) key sort
    and a rank gather.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.core.segment import segment_min, take
from veloslam_tpu_torch.decode.decode import DecodedBatch, frame_break_flags
from veloslam_tpu_torch.utils.profiling import sync_span

_HASH_MUL = 2654435761      # Fibonacci hashing constant (uint32)


class FrameBatch(NamedTuple):
    """`max_frames` padded frame slots (leading axis = slot)."""

    xyz: torch.Tensor        # (S, L, MAX_F, 3)
    intensity: torch.Tensor  # (S, L, MAX_F)
    rel_s: torch.Tensor      # (S, L, MAX_F) — relative to the frame start
    azimuth: torch.Tensor    # (S, L, MAX_F)
    mask: torch.Tensor       # (S, L, MAX_F)
    n_points: torch.Tensor   # (S,) int32


class AssemblyCarry(NamedTuple):
    """Open-frame state threaded between assemble_frames calls."""

    xyz: torch.Tensor           # (L, MAX_F, 3)
    intensity: torch.Tensor     # (L, MAX_F)
    rel_s: torch.Tensor         # (L, MAX_F) — frame-relative
    azimuth: torch.Tensor       # (L, MAX_F)
    mask: torch.Tensor          # (L, MAX_F)
    n_firings: torch.Tensor     # () int32 — firing positions consumed
    last_azimuth: torch.Tensor  # () int32

    @staticmethod
    def init(n_beams: int, max_firings: int = C.MAX_FIRINGS_PER_FRAME, *,
             device) -> "AssemblyCarry":
        L, F = n_beams, max_firings
        f32 = dict(dtype=torch.float32, device=device)
        return AssemblyCarry(
            xyz=torch.zeros((L, F, 3), **f32),
            intensity=torch.zeros((L, F), **f32),
            rel_s=torch.zeros((L, F), **f32),
            azimuth=torch.zeros((L, F), **f32),
            mask=torch.zeros((L, F), dtype=torch.bool, device=device),
            n_firings=torch.zeros((), dtype=torch.int32, device=device),
            last_azimuth=torch.full((), -1, dtype=torch.int32,
                                    device=device))


def _segment_reduce(data: torch.Tensor, ids: torch.Tensor, n: int,
                    reduce: str, ident) -> torch.Tensor:
    """jax.ops.segment_{max,min,sum} over `n` segments of 1-D `data`:
    rows with an id ≥ n are dropped (they go to one trash segment, cut
    off), empty segments take `ident`."""
    out = torch.full((n + 1,), ident, dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, torch.clamp(ids, max=n).long(), data, reduce,
                        include_self=True)
    return out[:n]


def assemble_frames(decoded: DecodedBatch, xyz_world: torch.Tensor,
                    pkt_rel_s: torch.Tensor, carry: AssemblyCarry,
                    carry_start_rel_s: torch.Tensor, *, model: str,
                    n_beams: int, max_frames: int = 8,
                    max_firings: int = C.MAX_FIRINGS_PER_FRAME,
                    lean: bool = False
                    ) -> Tuple[FrameBatch, torch.Tensor, torch.Tensor,
                               AssemblyCarry, torch.Tensor]:
    """One assembly step.

    Args:
      decoded: decode_packets output, (N, 12, 32) leading shape.
      xyz_world: compensated points (N, 12, 32, 3) (decoded.xyz to skip
        compensation).
      pkt_rel_s: (N,) packet times (float32 s, batch time base).
      carry: open-frame state from the previous call.
      carry_start_rel_s: () float32 — the open frame's start in this
        batch's time base (ignored when carry.n_firings == 0).
    Returns (frames with max_frames slots, n_completed () int32 — valid
    slots, the excess of a batch that completes more being lost,
    start_rel_s (max_frames,) float32 per slot, new carry,
    open_start_rel_s () float32).  The scatter's winner mask is read once
    (a boolean index).

    `lean=True` skips the intensity, rel_s and azimuth scatters and
    returns zeros in those fields, for the odometry, which reads only
    xyz and mask.  A stream is lean all or nothing: a lean step zeroes
    those fields in the carried open frame too, so mixing lean and full
    steps on one carry would corrupt the boundary frame's channels."""
    lasers = C.HDL_LASERS_PER_FIRING
    N = decoded.xyz.shape[0]
    B = N * C.HDL_FIRINGS_PER_PACKET        # firing blocks in batch
    L, F, S = n_beams, max_firings, max_frames
    TRASH = S + 1                            # slot of the dropped writes
    ppb = 2 if model == "vlp16" else 1       # positions per block
    dev = xyz_world.device
    i32 = torch.int32

    breaks, last_az = frame_break_flags(decoded.az_ticks, carry.last_azimuth)
    fid = torch.cumsum(breaks.to(i32), 0, dtype=i32)        # (B,) 0..K
    n_frames = fid[-1] + 1

    # Firing-position units per block (HDL-64 pairs share one position).
    if model == "hdl64":
        unit = decoded.is_upper.reshape(-1).to(i32)
    else:
        unit = torch.ones((B,), dtype=i32, device=dev)
    cum = torch.cumsum(unit, 0, dtype=i32)                   # inclusive
    # Units consumed before each frame's first block.
    seg_base = _segment_reduce(torch.where(breaks, cum - unit, -1), fid,
                               S + 2, "amax", torch.iinfo(i32).min)
    fid_c = torch.clamp(fid, max=S + 1).long()
    base = torch.where(fid == 0, -carry.n_firings, seg_base[fid_c])
    pos = torch.clamp(cum - 1 - base, min=0)                 # block position

    # Block time (batch base) and per-frame start time.
    rel_block = pkt_rel_s.repeat_interleave(C.HDL_FIRINGS_PER_PACKET) + \
        decoded.dt_s[:, :, 0].reshape(-1)                     # (B,)
    seg_start = _segment_reduce(rel_block, fid, S + 2, "amin", float("inf"))
    seg_start[0] = torch.where(carry.n_firings > 0, carry_start_rel_s,
                               seg_start[0])
    frame_start = seg_start[fid_c]                           # (B,)

    # Per-point scatter indices: (slot, laser, position).
    slot_b = torch.clamp(fid, max=TRASH)
    pos_pt = pos[:, None] * ppb + decoded.subfiring.reshape(B, lasers)
    ok = decoded.valid.reshape(B, lasers) & (pos_pt < F)
    sl = torch.where(ok, slot_b[:, None], TRASH)
    pp = torch.where(ok, torch.clamp(pos_pt, max=F - 1), F - 1)
    lp = torch.clamp(decoded.laser_id.reshape(B, lasers), 0, L - 1)
    flat_idx = ((sl * L + lp) * F + pp).reshape(-1).long()   # (B*32,)
    M = (S + 2) * L * F
    # The last write of each cell wins (the source order, as a sequential
    # scatter writes); only the winners are written, so no two writes
    # meet in one cell on any device.
    src = torch.arange(B * lasers, device=dev)
    last = torch.full((M,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat_idx, src, "amax", include_self=True)
    win = last[flat_idx] == src
    with sync_span(win):
        cells = flat_idx[win]
    with sync_span(win):
        rows = src[win]

    def scatter(carry_arr, vals, extra=()):
        buf = torch.zeros((S + 2, L, F, *extra), dtype=carry_arr.dtype,
                          device=dev)
        buf[0] = carry_arr
        buf.view(M, *extra)[cells] = vals.reshape(-1, *extra)[rows]
        return buf

    xyz_buf = scatter(carry.xyz, xyz_world.reshape(B, lasers, 3), (3,))
    if lean:
        int_buf, rel_buf, az_buf = (
            torch.zeros((S + 2, L, F), dtype=c.dtype, device=dev)
            for c in (carry.intensity, carry.rel_s, carry.azimuth))
    else:
        rel_pt = (rel_block[:, None]
                  + (decoded.dt_s.reshape(B, lasers)
                     - decoded.dt_s[:, :, :1].reshape(B, 1)))
        rel_frame_pt = rel_pt - frame_start[:, None]         # frame-relative
        int_buf = scatter(carry.intensity,
                          decoded.intensity.reshape(B, lasers))
        rel_buf = scatter(carry.rel_s, rel_frame_pt)
        az_buf = scatter(carry.azimuth,
                         decoded.az_pt_ticks.reshape(B, lasers))
    mask_buf = scatter(carry.mask, torch.ones_like(ok))
    mask_buf[TRASH] = False

    # Per-slot bookkeeping.
    units_per_frame = _segment_reduce(unit, fid, S + 2, "sum", 0)
    units_per_frame[0] += carry.n_firings

    n_completed = torch.clamp(n_frames - 1, max=S)
    open_slot = n_completed

    mask_out = mask_buf[:S]
    frames = FrameBatch(
        xyz=xyz_buf[:S], intensity=int_buf[:S], rel_s=rel_buf[:S],
        azimuth=az_buf[:S], mask=mask_out,
        n_points=mask_out.sum(dim=(1, 2)).to(i32))
    new_carry = AssemblyCarry(
        xyz=take(xyz_buf, open_slot), intensity=take(int_buf, open_slot),
        rel_s=take(rel_buf, open_slot), azimuth=take(az_buf, open_slot),
        mask=take(mask_buf, open_slot),
        n_firings=take(units_per_frame, open_slot), last_azimuth=last_az)
    return (frames, n_completed, seg_start[:S], new_carry,
            take(seg_start, open_slot))


def frame_points(frame_xyz: torch.Tensor, frame_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a frame's (L, MAX_F, 3)+mask into (L·MAX_F, 3)+mask."""
    return frame_xyz.reshape(-1, 3), frame_mask.reshape(-1)


class SampleCarry(NamedTuple):
    """Open-frame compensated blocks carried between batches,
    RIGHT-ALIGNED: occupied rows are [Fc - n_blocks, Fc)."""

    xyz: torch.Tensor           # (Fc, 32, 3) float32, world frame
    valid: torch.Tensor         # (Fc, 32) bool
    laser: torch.Tensor         # (Fc, 32) int32 — output beam row (hash key)
    n_blocks: torch.Tensor      # () int32
    last_azimuth: torch.Tensor  # () int32

    @staticmethod
    def init(max_firings: int = C.MAX_FIRINGS_PER_FRAME, *,
             device) -> "SampleCarry":
        F, L = max_firings, C.HDL_LASERS_PER_FIRING
        return SampleCarry(
            xyz=torch.zeros((F, L, 3), dtype=torch.float32, device=device),
            valid=torch.zeros((F, L), dtype=torch.bool, device=device),
            laser=torch.zeros((F, L), dtype=torch.int32, device=device),
            n_blocks=torch.zeros((), dtype=torch.int32, device=device),
            last_azimuth=torch.full((), -1, dtype=torch.int32,
                                    device=device))


class SampledFrames(NamedTuple):
    """Per-slot sampled points (leading axis = frame slot)."""

    xyz: torch.Tensor      # (S, P, 3) float32 — world frame (compensated)
    mask: torch.Tensor     # (S, P) bool


def hash16(flat: torch.Tensor) -> torch.Tensor:
    """16-bit multiplicative hash of non-negative int32 indices:
    (flat · 2654435761 mod 2³²) >> 16, computed in int64 because torch has
    no uint32 shifts on the CPU."""
    return (((flat.long() * _HASH_MUL) & 0xFFFFFFFF) >> 16).to(torch.int32)


def sample_frames(decoded: DecodedBatch, xyz_world: torch.Tensor,
                  pkt_rel_s: torch.Tensor, carry: SampleCarry,
                  carry_start_rel_s: torch.Tensor, *, model: str,
                  max_frames: int, points_per_frame: int,
                  max_firings: int = C.MAX_FIRINGS_PER_FRAME
                  ) -> Tuple[SampledFrames, torch.Tensor, torch.Tensor,
                             SampleCarry, torch.Tensor]:
    """Segment the batch into frames and select `points_per_frame` points
    per completed frame.

    Returns (frames, n_completed () int32, start_rel_s (S,), new carry,
    open_start_rel_s ()).  Output points are ordered by ascending hash, so
    any prefix of the P axis is itself a uniform subsample.  Frames longer
    than `max_firings` positions contribute only their first positions;
    the carry keeps the open frame's newest `max_firings` blocks.
    """
    lasers = C.HDL_LASERS_PER_FIRING
    N = decoded.xyz.shape[0]
    B = N * C.HDL_FIRINGS_PER_PACKET
    Fc, S = max_firings, max_frames
    P = points_per_frame
    ppb = 2 if model == "vlp16" else 1
    dev = xyz_world.device
    i32 = torch.int32

    breaks, last_az = frame_break_flags(decoded.az_ticks, carry.last_azimuth)
    fid = torch.cumsum(breaks.to(i32), 0, dtype=i32)          # (B,)
    n_frames = fid[-1] + 1
    n_completed = torch.clamp(n_frames - 1, max=S)
    fid_c = torch.clamp(fid, max=S + 1)

    row = torch.arange(B, dtype=i32, device=dev) + Fc          # block units
    seg_first = segment_min(row, fid_c, S + 2)
    # Frame 0 may extend back into the carry (and may be carry-only when
    # the batch's first block opens a new frame).  The JAX original also
    # builds each segment's last row, which nothing reads.
    has_carry = carry.n_blocks > 0
    first0 = Fc - torch.clamp(carry.n_blocks, max=Fc)
    seg_first[0] = torch.where(has_carry, first0, seg_first[0])

    rel_block = pkt_rel_s.repeat_interleave(C.HDL_FIRINGS_PER_PACKET) + \
        decoded.dt_s[:, :, 0].reshape(-1)                       # (B,)
    seg_start = segment_min(rel_block, fid_c, S + 2)
    seg_start[0] = torch.where(has_carry, carry_start_rel_s, seg_start[0])

    # --- per-point hash keys over the CONCAT (carry ++ batch) order --------
    blk_in_frame = row - seg_first[fid_c.long()]
    if model == "hdl64":
        pos_b = torch.div(blk_in_frame, 2, rounding_mode="floor")
    else:
        pos_b = blk_in_frame
    pos_pt = pos_b[:, None] * ppb + decoded.subfiring.reshape(B, lasers)
    # Beam rows go to 63 on HDL-64; the hash key only needs distinctness.
    las_b = torch.clamp(decoded.laser_id.reshape(B, lasers), 0, 63)
    ok_b = decoded.valid.reshape(B, lasers) & (pos_pt < Fc)

    # Carry points: frame 0, position = row − first0 (block units).
    cpos_b = torch.arange(Fc, dtype=i32, device=dev) - first0
    if model == "hdl64":
        cpos_b = torch.div(cpos_b, 2, rounding_mode="floor")
    dsr = torch.arange(lasers, dtype=i32, device=dev)
    csub = (torch.div(dsr, 16, rounding_mode="floor") if model == "vlp16"
            else torch.zeros_like(dsr))[None, :]
    cpos_pt = cpos_b[:, None] * ppb + csub
    ok_c = carry.valid & (cpos_pt >= 0) & (cpos_pt < Fc)

    flat_c = carry.laser * Fc + torch.clamp(cpos_pt, 0, Fc - 1)
    flat_b = las_b * Fc + torch.clamp(pos_pt, 0, Fc - 1)
    slot_b = fid_c[:, None].expand(B, lasers)
    flat = torch.cat([flat_c.reshape(-1), flat_b.reshape(-1)])
    slot = torch.cat([torch.zeros(Fc * lasers, dtype=i32, device=dev),
                      slot_b.reshape(-1)])
    ok = torch.cat([ok_c.reshape(-1), ok_b.reshape(-1)])
    # Sort key: (slot | hash); invalid points sort last (slot sentinel).
    key = torch.where(ok, (torch.clamp(slot, max=S + 1) << 16) | hash16(flat),
                      (S + 2) << 16)
    Ncat = (Fc + B) * lasers
    skeys, order = torch.sort(key, stable=True)

    # Slot boundaries in the sorted key space.
    slot_starts = torch.searchsorted(
        skeys, torch.arange(S + 1, dtype=i32, device=dev) << 16,
        out_int32=True)
    counts = slot_starts[1:] - slot_starts[:-1]                 # (S,)
    slot_done = torch.arange(S, device=dev) < n_completed
    r = torch.arange(P, dtype=i32, device=dev)
    take_idx = slot_starts[:S, None] + r[None, :]               # (S, P)
    sel_ok = (r[None, :] < torch.clamp(counts[:, None], max=P)) \
        & slot_done[:, None]
    pick = order[torch.clamp(take_idx, 0, Ncat - 1).long()]     # (S, P)

    cat_xyz = torch.cat([carry.xyz.reshape(Fc * lasers, 3),
                         xyz_world.reshape(B * lasers, 3)])
    frames = SampledFrames(xyz=cat_xyz[pick], mask=sel_ok)

    # New carry: the open frame's BLOCKS, right-aligned into (Fc,) buffers.
    open_id = torch.clamp(n_frames - 1, max=S + 1)
    open_first_blk = torch.clamp(take(seg_first, open_id), min=B)
    cat_valid_blk = torch.cat([carry.valid,
                               decoded.valid.reshape(B, lasers)])
    cat_laser_blk = torch.cat([carry.laser, las_b])
    keep = (torch.arange(Fc, dtype=i32, device=dev) + B) >= open_first_blk
    new_carry = SampleCarry(
        xyz=cat_xyz.reshape(Fc + B, lasers, 3)[B:].clone(),
        valid=cat_valid_blk[B:] & keep[:, None],
        laser=cat_laser_blk[B:].clone(),
        n_blocks=(Fc + B) - open_first_blk,
        last_azimuth=last_az)
    open_start = take(seg_start, open_id)
    return frames, n_completed, seg_start[:S], new_carry, open_start
