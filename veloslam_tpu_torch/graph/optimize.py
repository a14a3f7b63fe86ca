"""Gauss-Newton pose-graph solver (pose-only).

Port of veloslam_tpu/graph/optimize.py::solve.  Each edge's residual
r = log(Z⁻¹ ∘ (Tᵢ⁻¹ ∘ Tⱼ)) and its (6, 12) Jacobian at zero retraction
deltas (written out; the JAX original takes `jax.jacfwd` under vmap);
the normal equations are assembled dense, (6K, 6K) for K keyframes, by
one accumulating scatter of the (12, 12) edge blocks; a strong prior on
keyframe 0 fixes the gauge and damping regularizes padding rows, so one
static-shape program serves any graph up to capacity.

The solve is `cholesky_ex` plus two triangular solves, with no host
read: `torch.cholesky_solve` would synchronize the stream.  A matrix
that is not positive definite gives NaN poses, as JAX's Cholesky does,
and the caller (runtime.devfinalize.solve_and_correct) rejects them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.graph.posegraph import GraphArrays


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int


def _edge_residual(qi, ti, qj, tj, mq, mt, di, dj):
    """Residual of pose-pose edges at retraction deltas (di, dj)
    ((E, 6) each: rotation vector, translation)."""
    Pi = se3.retract(se3.Pose(qi, ti), di)
    Pj = se3.retract(se3.Pose(qj, tj), dj)
    pred = se3.compose(se3.inverse(Pi), Pj)
    meas = se3.Pose(mq, mt)
    return se3.log(se3.compose(se3.inverse(meas), pred))


def _skew(v):
    """(..., 3) → (..., 3, 3) cross-product matrices: skew(a) @ b = a × b."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(*v.shape[:-1], 3, 3)


def edge_r_and_J(qi, ti, qj, tj, mq, mt):
    """For E edges: (r (E, 6), J (E, 6, 12)) at zero deltas.

    The JAX package differentiates the residual with jax.jacfwd; here
    the Jacobian is written out (tests/test_torch_graph.py holds it equal
    to jax.jacfwd), which costs a few dozen batched ops where forward-mode
    autodiff under vmap costs over a thousand.  With A = (Ri Rm)ᵀ and
    θ = r_rot, perturbing Pᵢ ← exp(dᵢ) ∘ Pᵢ (dᵢ = (ωᵢ, vᵢ)):

      r_t = A (Exp(−ωi)(vj − vi + Exp(ωj) tj) − ti) − Rmᵀ tm
        ∂r_t/∂ωi = A [tj]×,  ∂r_t/∂vi = −A,
        ∂r_t/∂ωj = −A [tj]×, ∂r_t/∂vj = A;
      r_rot = Log(E0 Exp(Rjᵀ(ωj − ωi)))
        ∂r_rot/∂ωj = −∂r_rot/∂ωi = Jr⁻¹(θ) Rjᵀ,
        Jr⁻¹(θ) = I + ½[θ]× + c(θ)[θ]×², c = 1/θ² − (1 + cos θ)/(2θ sin θ)
    (c by its series below 0.5 rad, where the difference cancels)."""
    zero = ti.new_zeros((ti.shape[0], 6))
    r = _edge_residual(qi, ti, qj, tj, mq, mt, zero, zero)
    A = (se3.quat_to_matrix(qi) @ se3.quat_to_matrix(mq)).transpose(-2, -1)
    At = A @ _skew(tj)
    th = r[:, :3]
    a2 = torch.sum(th * th, dim=-1)
    a = torch.sqrt(a2)
    big = a >= 0.5
    safe = torch.where(big, a, 1.0)
    c = torch.where(big, 1.0 / (safe * safe) - (1.0 + torch.cos(safe))
                    / (2.0 * safe * torch.sin(safe)),
                    1.0 / 12.0 + a2 / 720.0 + a2 * a2 / 30240.0)
    S = _skew(th)
    eye = torch.eye(3, dtype=ti.dtype, device=ti.device)
    jr_inv = eye + 0.5 * S + c[:, None, None] * (S @ S)
    Jw = jr_inv @ se3.quat_to_matrix(qj).transpose(-2, -1)
    z3 = torch.zeros_like(A)
    J = torch.cat([torch.cat([-Jw, z3, Jw, z3], dim=-1),
                   torch.cat([At, -A, -At, A], dim=-1)], dim=-2)
    return r, J


def _assemble_pose_system(g: GraphArrays, max_poses: int):
    """Dense H (6K, 6K), b (6K,) from the pose-pose edges, and the cost."""
    K = max_poses
    ei, ej = g.e_i.long(), g.e_j.long()
    r, J = edge_r_and_J(g.q[ei], g.t[ei], g.q[ej], g.t[ej], g.e_q, g.e_t)
    w = g.e_valid.to(r.dtype)[:, None] * g.e_info               # (E, 6)
    Jw = J * w[:, :, None]                                      # (E, 6, 12)
    blocks = torch.einsum("eri,erj->eij", Jw, J)                # (E, 12, 12)
    bvec = torch.einsum("eri,er->ei", Jw, r)                    # (E, 12)
    cost = torch.sum(w * r * r)
    six = torch.arange(6, device=ei.device)
    rows = torch.cat([ei[:, None] * 6 + six, ej[:, None] * 6 + six], dim=1)
    E = rows.shape[0]
    H = r.new_zeros((6 * K, 6 * K))
    H.index_put_((rows[:, :, None].expand(E, 12, 12),
                  rows[:, None, :].expand(E, 12, 12)), blocks,
                 accumulate=True)
    b = r.new_zeros(6 * K).index_put_((rows,), bvec, accumulate=True)
    return H, b, cost


def solve(g: GraphArrays, *, max_poses: int, iterations: int = 8,
          prior_weight: float = 1e6, damping: float = 1e-4
          ) -> Tuple[GraphArrays, SolveStats]:
    """Pose-only Gauss-Newton over odometry + loop-closure edges; a fixed
    iteration count with no host read."""
    K = max_poses
    pose_mask = (torch.arange(K, device=g.q.device) < g.n_poses)[:, None]
    c0 = c1 = None
    for it in range(iterations):
        H, b, cost = _assemble_pose_system(g, K)
        H.diagonal().add_(damping)
        H[:6, :6].diagonal().add_(prior_weight)                 # gauge
        L, info = torch.linalg.cholesky_ex(H)
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        delta = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        delta = torch.where(info == 0, delta, float("nan")).reshape(K, 6)
        delta = torch.where(pose_mask, delta, 0.0)
        new = se3.retract(se3.Pose(g.q, g.t), delta)
        g = g._replace(q=new.q, t=new.t)
        c0 = cost if it == 0 else c0
        c1 = cost
    if c0 is None:
        c0 = c1 = torch.full((), float("inf"), device=g.q.device)
    return g, SolveStats(initial_cost=c0, final_cost=c1,
                         iterations=iterations)
