"""Segment reductions and a sync-free scalar gather — the torch
counterparts of jax.ops.segment_sum / segment_min and of indexing by a
traced scalar — and segment sums in a fixed order: over rows already
sorted by segment, or over a plan made once for ids that many sums
share.

Empty segments take the reduction's identity (0 for a sum, the dtype's
max for a min), as jax.ops does; callers read those values for empty
segments, so the identity is part of the contract.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of `data` (leading axis) into `num_segments` segments;
    every id must lie in [0, num_segments)."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


class SegmentPlan(NamedTuple):
    """A segment-id vector prepared for repeated sums in a fixed order:
    its rows sorted stably by segment, and each segment's row count.
    index_add_ on the card adds floats by atomics in no fixed order; an
    iterative solver that sums over the same ids hundreds of times turns
    that into answers that differ from run to run."""

    order: torch.Tensor    # (N,) int64: rows by segment, ties in row order
    lengths: torch.Tensor  # (num_segments + trash segments,) int64
    num_segments: int


# Rows left out of a plan go to trash segments of at most this many rows:
# segment_reduce sums each segment in one thread, so no segment may grow
# with the padding.
_TRASH_ROWS = 32


def segment_plan(ids: torch.Tensor, num_segments: int,
                 valid: torch.Tensor = None) -> SegmentPlan:
    """The plan of `ids` (every valid id in [0, num_segments)); rows where
    `valid` is False are in no segment.  No host read."""
    ids = ids.long()
    if valid is not None:
        ids = torch.where(valid, ids, num_segments)
    counts = torch.zeros(num_segments + 1, dtype=torch.int64,
                         device=ids.device).index_add_(
                             0, ids, torch.ones_like(ids))
    return SegmentPlan(torch.argsort(ids, stable=True),
                       torch.cat([counts[:-1],
                                  _trash_lengths(counts[-1], ids.shape[0])]),
                       num_segments)


def _trash_lengths(n_trash_rows: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., ceil(rows / _TRASH_ROWS)) lengths of trash segments that hold
    n_trash_rows (...,) rows, _TRASH_ROWS each and the rest in the last."""
    n = -(-rows // _TRASH_ROWS)
    return torch.clamp(n_trash_rows[..., None] - _TRASH_ROWS * torch.arange(
        n, device=n_trash_rows.device), 0, _TRASH_ROWS)


def segment_sum_planned(data: torch.Tensor, plan: SegmentPlan
                        ) -> torch.Tensor:
    """segment_sum over the plan's segments, each segment's rows added in
    row order: the same sums on every run and device; empty segments 0.
    `unsafe` skips segment_reduce's checks of the lengths, which read them
    on the host (segment_plan makes them add up to the rows)."""
    out = torch.segment_reduce(data.index_select(0, plan.order), "sum",
                               lengths=plan.lengths, axis=0, unsafe=True)
    return out[:plan.num_segments]


def segment_sum_sorted(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """segment_sum of rows already in segment order, row by row of a
    batch, each segment's rows added in row order: the same sums on every
    run and device, where index_add_ on the card adds by atomics in no
    fixed order.  data (F, P, ...), ids (F, P) never decreasing along P,
    each in [0, num_segments]; rows with id num_segments are in no
    segment (they come last in their row).  Returns (F, num_segments, ...),
    empty segments 0.  The left-out rows go to trash segments of at most
    _TRASH_ROWS rows, so no segment grows with them."""
    F, P = ids.shape
    S = num_segments
    ids = ids.long()
    counts = torch.zeros((F, S + 1), dtype=torch.int64,
                         device=ids.device).scatter_add_(
                             1, ids, torch.ones_like(ids))
    lengths = torch.cat([counts[:, :S], _trash_lengths(counts[:, S], P)], 1)
    out = torch.segment_reduce(data.reshape(F * P, *data.shape[2:]), "sum",
                               lengths=lengths.reshape(-1), axis=0,
                               unsafe=True)
    return out.reshape(F, lengths.shape[1], *data.shape[2:])[:, :S]


def segment_min(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment minimum of 1-D `data`; empty segments give the dtype's
    max (+inf for floats), as jax.ops.segment_min does."""
    if data.dtype.is_floating_point:
        ident = float("inf")
    else:
        ident = torch.iinfo(data.dtype).max
    out = torch.full((num_segments,), ident, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, ids.long(), data, "amin",
                               include_self=True)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index tensor without a host round trip
    (Python indexing with a 0-d tensor reads it back to the host)."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)
