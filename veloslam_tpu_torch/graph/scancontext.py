"""Scan-context global descriptors: drift-independent place recognition.

Port of veloslam_tpu/graph/scancontext.py.  Each keyframe scan becomes
a polar bird's-eye descriptor (rings × sectors, the max height per cell);
all keyframe pairs are scored at once by cosine similarity maximized over
sector shifts (rotation about z), one matmul per shift.  The best shift
doubles as the yaw prior of the geometric verifier.  `propose` (the
per-frame pipeline's host proposal from a score matrix) is numpy, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

N_RINGS = 16
N_SECTORS = 60


def scan_context_batch(pts, mask, *, n_rings: int = N_RINGS,
                       n_sectors: int = N_SECTORS, max_range: float = 80.0,
                       z_floor: float = -2.0) -> torch.Tensor:
    """(F, P, 3) scans + (F, P) masks → (F, n_rings, n_sectors) max-height
    descriptors: cell value max(z − z_floor, 0) over the cell's points,
    empty cells 0 (a scatter-max into a zero buffer with a trash cell)."""
    F = pts.shape[0]
    r = torch.linalg.vector_norm(pts[..., :2], dim=-1)
    ring = torch.floor(r / (max_range / n_rings)).to(torch.int32)
    sector = torch.floor((torch.atan2(pts[..., 1], pts[..., 0]) + math.pi)
                         / (2.0 * math.pi / n_sectors)).to(torch.int32)
    sector = torch.clamp(sector, 0, n_sectors - 1)
    ok = mask & (ring < n_rings)
    cells = n_rings * n_sectors
    cell = torch.where(ok, ring * n_sectors + sector, cells)
    h = torch.clamp(pts[..., 2] - z_floor, min=0.0)
    out = torch.zeros((F, cells + 1), dtype=torch.float32, device=pts.device)
    out.scatter_reduce_(1, cell.long(), torch.where(ok, h, 0.0), "amax",
                        include_self=True)
    return out[:, :cells].reshape(F, n_rings, n_sectors)


def scan_context(pts, mask, **kw) -> torch.Tensor:
    """One scan (P, 3) + mask (P,) → (n_rings, n_sectors)."""
    return scan_context_batch(pts[None], mask[None], **kw)[0]


def descriptor_scores(desc: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs rotation-invariant similarity of (K, R, S) descriptors →
    (scores (K, K) float32 in [−1, 1], shifts (K, K) int32).

    scores[i, j] is the cosine similarity of roll(desc[i], shift) and
    desc[j], maximized over the S shifts; the update is strict, so the
    first shift wins a tie.  Zero-norm (empty) descriptors score 0."""
    K, R, S = desc.shape
    flat = desc.reshape(K, R * S)
    norm = torch.linalg.vector_norm(flat, dim=-1)
    denom = torch.clamp(norm[:, None] * norm[None, :], min=1e-9)
    best = torch.full((K, K), float("-inf"), dtype=torch.float32,
                      device=desc.device)
    arg = torch.zeros((K, K), dtype=torch.int32, device=desc.device)
    for s in range(S):
        rolled = torch.roll(desc, s, dims=2).reshape(K, R * S)
        sim = torch.matmul(rolled, flat.T) / denom
        upd = sim > best
        best = torch.where(upd, sim, best)
        arg = torch.where(upd, s, arg)
    ok = (norm[:, None] > 1e-6) & (norm[None, :] > 1e-6)
    return torch.where(ok, best, 0.0), arg


def relative_yaw(shift, n_sectors: int = N_SECTORS):
    """Yaw of T_i⁻¹ ∘ T_j implied by the best sector shift of
    scores[i, j] (host numpy): the vehicle heading rotated by −shift·Δ,
    wrapped to (−π, π]."""
    yaw = -np.asarray(shift) * (2.0 * np.pi / n_sectors)
    return (yaw + np.pi) % (2.0 * np.pi) - np.pi


def propose(scores: np.ndarray, shifts: np.ndarray, *, n_valid: int,
            min_score: float = 0.6, min_gap: int = 20,
            max_per_keyframe: int = 1,
            max_candidates: Optional[int] = None,
            exclude=()) -> List[Tuple[int, int, float, int]]:
    """Host-side proposal from an all-pairs score matrix (numpy).

    Returns [(i, j, score, shift)] with i < j − min_gap, best-first,
    at most `max_per_keyframe` uses of any keyframe, skipping `exclude`
    pairs.  `n_valid` bounds the real keyframes (the matrix may be
    padded)."""
    s = np.asarray(scores[:n_valid, :n_valid])
    ii, jj = np.nonzero(np.triu(np.ones_like(s, bool), k=max(min_gap, 1))
                        & (s >= min_score))
    order = np.argsort(-s[ii, jj])
    taken = np.zeros(n_valid, np.int64)
    excl = set(exclude)
    out: List[Tuple[int, int, float, int]] = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if (i, j) in excl:
            continue
        if taken[i] >= max_per_keyframe or taken[j] >= max_per_keyframe:
            continue
        taken[i] += 1
        taken[j] += 1
        out.append((i, j, float(s[i, j]), int(shifts[i, j])))
        if max_candidates is not None and len(out) >= max_candidates:
            break
    return out
