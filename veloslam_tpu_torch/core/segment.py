"""Segment reductions and a sync-free scalar gather — the torch
counterparts of jax.ops.segment_sum / segment_min and of indexing by a
traced scalar.

Empty segments take the reduction's identity (0 for a sum, the dtype's
max for a min), as jax.ops does; callers read those values for empty
segments, so the identity is part of the contract.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of `data` (leading axis) into `num_segments` segments;
    every id must lie in [0, num_segments)."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


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
