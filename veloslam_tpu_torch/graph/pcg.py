"""Solver choice by graph size.

Port of the dispatch in veloslam_tpu/graph/pcg.py: up to DENSE_MAX_POSES
keyframes the dense (6K, 6K) Gauss-Newton solves (graph.optimize.solve,
and solve_with_landmarks with landmarks Schur-eliminated) run; above it
the JAX package switches to matrix-free PCG solvers, which the port does
not have yet (ROADMAP.md, slice 2), so that size raises instead of
degrading quietly.
"""

from __future__ import annotations

from typing import Tuple

from veloslam_tpu_torch.graph import optimize
from veloslam_tpu_torch.graph.posegraph import GraphArrays

# Above this many poses the dense (6K,6K) assembly/Cholesky is replaced
# by the matrix-free PCG path in the JAX package.
DENSE_MAX_POSES = 2048


def solve_auto(g: GraphArrays, *, max_poses: int, iterations: int = 8,
               prior_weight: float = 1e6, damping: float = 1e-4
               ) -> Tuple[GraphArrays, optimize.SolveStats]:
    """Dense pose-only solve up to DENSE_MAX_POSES poses."""
    if max_poses <= DENSE_MAX_POSES:
        return optimize.solve(g, max_poses=max_poses, iterations=iterations,
                              prior_weight=prior_weight, damping=damping)
    raise _too_large(max_poses, "solve_pcg")


def solve_auto_landmarks(g: GraphArrays, *, max_poses: int,
                         max_landmarks: int, iterations: int = 8,
                         prior_weight: float = 1e6, damping: float = 1e-4
                         ) -> Tuple[GraphArrays, optimize.SolveStats]:
    """Dense landmark-Schur solve up to DENSE_MAX_POSES poses."""
    if max_poses <= DENSE_MAX_POSES:
        return optimize.solve_with_landmarks(
            g, max_poses=max_poses, max_landmarks=max_landmarks,
            iterations=iterations, prior_weight=prior_weight,
            damping=damping)
    raise _too_large(max_poses, "solve_pcg_landmarks")


def _too_large(max_poses: int, solver: str) -> NotImplementedError:
    return NotImplementedError(
        f"pose graph of {max_poses} keyframes: above DENSE_MAX_POSES = "
        f"{DENSE_MAX_POSES} the JAX package solves by matrix-free PCG "
        f"(graph/pcg.py::{solver}), which the port has not ported yet "
        "(ROADMAP.md, slice 2)")
