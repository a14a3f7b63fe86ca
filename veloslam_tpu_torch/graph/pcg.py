"""Matrix-free preconditioned-CG pose-graph solvers, and the solver
choice by graph size.

Port of veloslam_tpu/graph/pcg.py, the JAX package's unbounded-K back
end.  Up to DENSE_MAX_POSES keyframes the dense (6K, 6K) Gauss-Newton
solves of graph.optimize run; above it, where the dense normal matrix no
longer fits, the same Gauss-Newton step is solved without forming H:

  * per-edge residuals and Jacobians come from the dense path's
    optimize.edge_r_and_J (observations: optimize._obs_terms, with its
    Huber weights);
  * H·v is two row gathers, batched (E, 6, 12) products and two segment
    sums: O(E) memory.  Every segment sum of a solve runs on plans made
    once per solve (core.segment.segment_plan), adding rows in a fixed
    order, so a solve on the card repeats to the bit;
  * the preconditioner is the odometry chain, the block-tridiagonal part
    of H, solved exactly by a block-Thomas factorisation
    (graph.chain: a hand-written CUDA kernel on the card), so a closure
    correction crosses the whole chain in one application; block-Jacobi
    remains as precond="jacobi";
  * conjugate gradients run a fixed iteration count with the guards as
    device `torch.where`s: no host read anywhere in a solve.

Landmarks are eliminated matrix-free inside each H·v (All is (3, 3)
block-diagonal, inverted by the adjugate), so landmark sessions scale to
the same 16k+ poses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.segment import (SegmentPlan, segment_plan,
                                             segment_sum_planned)
from veloslam_tpu_torch.graph import chain, optimize
from veloslam_tpu_torch.graph.optimize import SolveStats, _obs_terms
from veloslam_tpu_torch.graph.posegraph import GraphArrays

# Above this many poses the dense (6K,6K) assembly/Cholesky is replaced
# by the matrix-free PCG path (dense is faster below it).  solve_auto
# reads it at call time.
DENSE_MAX_POSES = 2048


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


class _Segments(NamedTuple):
    """The segment plans of one solve (its graph's topology is fixed):
    every segment sum of the solve adds its rows in a fixed order, so a
    solve on the card repeats to the bit, where index_add_'s float
    atomics would move its ~800 H·v products by rounding and the poses
    by up to centimetres from run to run."""

    e_i: SegmentPlan                   # valid edges' sources into K
    e_j: SegmentPlan                   # valid edges' targets into K
    link: SegmentPlan                  # chain links k -> k+1 into K
    o_i: Optional[SegmentPlan] = None  # observing poses into K
    o_l: Optional[SegmentPlan] = None  # observed landmarks into M


def _segments(g: GraphArrays, K: int, M: int = 0) -> _Segments:
    """The plans of g's edges (and, with M, its observations).  Invalid
    edges and observations, weighted 0, are left out: the JAX package
    adds their zeros into row 0; the other edges are left out of the
    chain links, as its trash segment K drops them."""
    link = g.e_valid & (g.e_j == g.e_i + 1)
    obs = {}
    if M:
        obs = dict(o_i=segment_plan(g.o_i, K, g.o_valid),
                   o_l=segment_plan(g.o_l, M, g.o_valid))
    return _Segments(e_i=segment_plan(g.e_i, K, g.e_valid),
                     e_j=segment_plan(g.e_j, K, g.e_valid),
                     link=segment_plan(g.e_i, K, link), **obs)


def _edge_terms(g: GraphArrays):
    """Per-edge (r (E, 6), J (E, 6, 12), w (E, 6)) at the current
    estimate."""
    ei, ej = g.e_i.long(), g.e_j.long()
    r, J = optimize.edge_r_and_J(g.q[ei], g.t[ei], g.q[ej], g.t[ej],
                                 g.e_q, g.e_t)
    w = g.e_valid.to(r.dtype)[:, None] * g.e_info
    return r, J, w


def _assemble_rhs_diag(seg: _Segments, r, J, w, damping: float,
                       prior_weight: float):
    """b = Jᵀ W r (K, 6) (the sign is folded in later), the block
    diagonal of H (K, 6, 6) with damping and the gauge prior on pose 0,
    and the scalar cost, by segment sums over the edge endpoints."""
    Jw = J * w[:, :, None]                                   # (E, 6, 12)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    Jwi, Jwj = Jw[:, :, :6], Jw[:, :, 6:]
    bi = torch.einsum("eri,er->ei", Jwi, r)                  # (E, 6)
    bj = torch.einsum("eri,er->ei", Jwj, r)
    b = segment_sum_planned(bi, seg.e_i) + segment_sum_planned(bj, seg.e_j)
    Dii = torch.einsum("eri,erj->eij", Jwi, Ji)              # (E, 6, 6)
    Djj = torch.einsum("eri,erj->eij", Jwj, Jj)
    D = (segment_sum_planned(Dii, seg.e_i)
         + segment_sum_planned(Djj, seg.e_j))
    D = D + damping * _eye(6, D)
    D[0].diagonal().add_(prior_weight)                       # gauge
    cost = torch.sum(w * r * r)
    return b, D, cost


def _make_hv(g: GraphArrays, seg: _Segments, J, w, damping: float,
             prior_weight: float):
    """Returns v ↦ H·v for v of shape (K, 6), matrix-free."""
    ei, ej = g.e_i.long(), g.e_j.long()
    Jw = J * w[:, :, None]
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    Jwi, Jwj = Jw[:, :, :6], Jw[:, :, 6:]

    def hv(v):
        u = (torch.einsum("eri,ei->er", Ji, v[ei])
             + torch.einsum("eri,ei->er", Jj, v[ej]))        # (E, 6)
        yi = torch.einsum("eri,er->ei", Jwi, u)
        yj = torch.einsum("eri,er->ei", Jwj, u)
        y = (segment_sum_planned(yi, seg.e_i)
             + segment_sum_planned(yj, seg.e_j))
        y = y + damping * v
        y[0].add_(prior_weight * v[0])                       # gauge
        return y
    return hv


def _chain_terms(seg: _Segments, J, w):
    """Consecutive-pose coupling blocks B_k = Σ_{edges k→k+1} J_iᵀ W J_j
    (K, 6, 6), the off-diagonals of the odometry chain; other edges sum
    into a trash segment K that is dropped."""
    Jw = J * w[:, :, None]
    blocks = torch.einsum("eri,erj->eij", Jw[:, :, :6], J[:, :, 6:])
    return segment_sum_planned(blocks, seg.link)


def _chain_floor(D):
    """D + 2% of its mean diagonal on every block's diagonal.

    The floor stabilises the f32 elimination over K sequential steps:
    without it the recursion's conditioning (the 1e6 gauge at pose 0
    against 1e-4 damping in the tails) compounds and the preconditioner
    silently turns indefinite (the JAX package measured a diverged CG,
    cost → 5e9, on a 10k chain).  It goes into M only, not into H."""
    scale = torch.mean(torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)) / 6.0
    return D + 0.02 * scale * _eye(6, D)


def _chain_preconditioner(D, B):
    """apply_M for the chain: the block-Thomas factors of (the floored D,
    B), and r ↦ M⁻¹ r by the chain kernel's two sweeps."""
    Uinv, L = chain.chain_factor(_chain_floor(D), B)
    return lambda rr: chain.chain_solve(Uinv, L, B, rr)


def _jacobi_preconditioner(D):
    """apply_M for block-Jacobi: r ↦ D_k⁻¹ r_k (inv_ex: no host check)."""
    Dinv = torch.linalg.inv_ex(D)[0]
    return lambda rr: torch.einsum("kij,kj->ki", Dinv, rr)


def _pcg(hv, b, apply_M, cg_iters: int):
    """Solve H x = b by preconditioned CG, a fixed iteration count; the
    guards on |pᵀHp| and |rᵀz| are device selects."""
    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        hp = hv(p)
        denom = torch.sum(p * hp)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * hp
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def _masked_step(delta: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Zero the step on padding rows (index ≥ n) and non-finite entries."""
    mask = (torch.arange(delta.shape[0], device=delta.device) < n)[:, None]
    return torch.where(mask & torch.isfinite(delta), delta, 0.0)


def _stats(costs, iterations: int, device) -> SolveStats:
    """Iteration 0's cost and the last one (inf without iterations)."""
    if not costs:
        costs = [torch.full((), float("inf"), device=device)]
    return SolveStats(initial_cost=costs[0], final_cost=costs[-1],
                      iterations=iterations)


def solve_pcg(g: GraphArrays, *, max_poses: int, iterations: int = 8,
              cg_iters: int = 96, prior_weight: float = 1e6,
              damping: float = 1e-4, precond: str = "chain"
              ) -> Tuple[GraphArrays, SolveStats]:
    """Pose-only Gauss-Newton with a matrix-free PCG inner solve: the
    contract of optimize.solve in O(E) memory instead of O(K²).

    cg_iters sizing: block-Jacobi needs roughly O(graph diameter) inner
    iterations to carry a closure correction end to end; the chain
    preconditioner makes convergence depend on the closures only, and an
    under-converged inner solve still descends, later GN iterations
    absorbing the rest."""
    if precond not in ("chain", "jacobi"):
        raise ValueError(f"precond {precond!r}: 'chain' or 'jacobi'")
    seg = _segments(g, max_poses)
    costs = []
    for _ in range(iterations):
        r, J, w = _edge_terms(g)
        b, D, cost = _assemble_rhs_diag(seg, r, J, w, damping, prior_weight)
        if precond == "chain":
            apply_M = _chain_preconditioner(D, _chain_terms(seg, J, w))
        else:
            apply_M = _jacobi_preconditioner(D)
        delta = -_pcg(_make_hv(g, seg, J, w, damping, prior_weight), b,
                      apply_M, cg_iters)
        new = se3.retract(se3.Pose(g.q, g.t), _masked_step(delta, g.n_poses))
        g = g._replace(q=new.q, t=new.t)
        costs.append(cost)
    return g, _stats(costs, iterations, g.q.device)


def _landmark_elimination(g: GraphArrays, seg: _Segments, r_o, Jp, Jl,
                          w_o, damping: float):
    """Matrix-free pieces of the Schur-reduced system.

    All is block-diagonal (3, 3), one block per landmark (a segment sum
    over its observations), so eliminating the landmarks inside each CG
    application is two observation-indexed product sweeps and one batched
    3×3 inverse apply: O(O + M) memory, no (M, 3, 6K) tensor.

    Returns (obs rhs (K, 6), obs diagonal (K, 6, 6), All⁻¹ (M, 3, 3),
    b_l (M, 3), T·, Tᵀ·, schur_apply: v (K, 6) → (K, 6), obs cost)."""
    oi, ol = g.o_i.long(), g.o_l.long()
    Jpw = Jp * w_o[:, :, None]                               # (O, 3, 6)
    Jlw = Jl * w_o[:, :, None]                               # (O, 3, 3)
    cost = torch.sum(w_o * r_o * r_o)
    # Pose-side gradient and block diagonal of App from observations.
    b_p = segment_sum_planned(torch.einsum("ori,or->oi", Jpw, r_o), seg.o_i)
    D_o = segment_sum_planned(torch.einsum("ori,orj->oij", Jpw, Jp),
                              seg.o_i)
    # Landmark normal blocks and rhs.
    M = seg.o_l.num_segments
    land_mask = torch.arange(M, device=oi.device) < g.n_landmarks
    All = segment_sum_planned(torch.einsum("ori,orj->oij", Jlw, Jl),
                              seg.o_l)
    All = All + (damping + 1e-3) * _eye(3, All)
    All_inv = torch.where(land_mask[:, None, None], optimize._inv3(All),
                          0.0)
    b_l = segment_sum_planned(torch.einsum("ori,or->oi", Jlw, r_o), seg.o_l)

    def coupling_T(v):
        """T·v = Alp·v (M, 3) for a pose-space vector v (K, 6)."""
        u = torch.einsum("ori,oi->or", Jp, v[oi])            # (O, 3)
        return segment_sum_planned(torch.einsum("ora,or->oa", Jlw, u),
                                   seg.o_l)

    def coupling_Tt(y):
        """Tᵀ·y = Apl·y (K, 6) for a landmark-space vector y (M, 3)."""
        u = torch.einsum("ora,oa->or", Jl, y[ol])            # (O, 3)
        return segment_sum_planned(torch.einsum("ori,or->oi", Jpw, u),
                                   seg.o_i)

    def schur_apply(v):
        """(App_obs − Tᵀ All⁻¹ T)·v, the landmark part of S·v."""
        direct = segment_sum_planned(
            torch.einsum("ori,or->oi", Jpw,
                         torch.einsum("ori,oi->or", Jp, v[oi])), seg.o_i)
        y = torch.einsum("lab,lb->la", All_inv, coupling_T(v))
        return direct - coupling_Tt(y)

    return (b_p, D_o, All_inv, b_l, coupling_T, coupling_Tt, schur_apply,
            cost)


def solve_pcg_landmarks(g: GraphArrays, *, max_poses: int,
                        max_landmarks: int, iterations: int = 8,
                        cg_iters: int = 96, prior_weight: float = 1e6,
                        damping: float = 1e-4
                        ) -> Tuple[GraphArrays, SolveStats]:
    """Landmark-aided Gauss-Newton with matrix-free PCG on the Schur-
    reduced pose system: the estimation problem of
    optimize.solve_with_landmarks with nothing bigger than O(E + O + M +
    K) materialised.  Preconditioner: the chain factorisation over the
    block diagonal of App (edges and observation pose blocks); the Schur
    correction is left out of M (it only subtracts PSD mass, so M ⪰ S
    stays SPD)."""
    seg = _segments(g, max_poses, max_landmarks)
    land_n = g.n_landmarks
    costs = []
    for _ in range(iterations):
        r, J, w = _edge_terms(g)
        b_e, D_e, cost_e = _assemble_rhs_diag(seg, r, J, w, damping,
                                              prior_weight)
        r_o, Jp, Jl, w_o = _obs_terms(g)
        (b_o, D_o, All_inv, b_l, coupling_T, coupling_Tt, schur_apply,
         cost_o) = _landmark_elimination(g, seg, r_o, Jp, Jl, w_o, damping)
        # Reduced rhs: b_red = b_p − Tᵀ All⁻¹ b_l.
        b = (b_e + b_o
             - coupling_Tt(torch.einsum("lab,lb->la", All_inv, b_l)))
        apply_M = _chain_preconditioner(D_e + D_o,
                                        _chain_terms(seg, J, w))
        hv_e = _make_hv(g, seg, J, w, damping, prior_weight)
        delta_p = -_pcg(lambda v: hv_e(v) + schur_apply(v), b, apply_M,
                        cg_iters)
        delta_p = _masked_step(delta_p, g.n_poses)
        # Landmark back-substitution: δl = −All⁻¹ (b_l + Alp·δp).
        delta_l = -torch.einsum("lab,lb->la", All_inv,
                                b_l + coupling_T(delta_p))
        new = se3.retract(se3.Pose(g.q, g.t), delta_p)
        g = g._replace(q=new.q, t=new.t,
                       l_pos=g.l_pos + _masked_step(delta_l, land_n))
        costs.append(cost_e + cost_o)
    return g, _stats(costs, iterations, g.q.device)


def solve_auto(g: GraphArrays, *, max_poses: int, iterations: int = 8,
               prior_weight: float = 1e6, damping: float = 1e-4,
               cg_iters: int = 96) -> Tuple[GraphArrays, SolveStats]:
    """Dense solve for small graphs, PCG beyond DENSE_MAX_POSES."""
    if max_poses <= DENSE_MAX_POSES:
        return optimize.solve(g, max_poses=max_poses, iterations=iterations,
                              prior_weight=prior_weight, damping=damping)
    return solve_pcg(g, max_poses=max_poses, iterations=iterations,
                     cg_iters=cg_iters, prior_weight=prior_weight,
                     damping=damping)


def solve_auto_landmarks(g: GraphArrays, *, max_poses: int,
                         max_landmarks: int, iterations: int = 8,
                         prior_weight: float = 1e6, damping: float = 1e-4,
                         cg_iters: int = 96
                         ) -> Tuple[GraphArrays, SolveStats]:
    """Landmark-aided solve: dense Schur below DENSE_MAX_POSES, the
    matrix-free landmark-Schur PCG beyond it."""
    if max_poses <= DENSE_MAX_POSES:
        return optimize.solve_with_landmarks(
            g, max_poses=max_poses, max_landmarks=max_landmarks,
            iterations=iterations, prior_weight=prior_weight,
            damping=damping)
    return solve_pcg_landmarks(g, max_poses=max_poses,
                               max_landmarks=max_landmarks,
                               iterations=iterations, cg_iters=cg_iters,
                               prior_weight=prior_weight, damping=damping)
