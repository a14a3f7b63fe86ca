"""Gauss-Newton pose-graph solver with Schur landmark elimination.

Port of veloslam_tpu/graph/optimize.py.  Each edge's residual
r = log(Z⁻¹ ∘ (Tᵢ⁻¹ ∘ Tⱼ)) and its (6, 12) Jacobian at zero retraction
deltas, and each landmark observation's residual Tᵢ⁻¹(l) − z with its
(3, 6) pose and (3, 3) landmark Jacobians, are written out (the JAX
original takes `jax.jacfwd` under vmap); the normal equations are
assembled dense, (6K, 6K) for K keyframes, by one accumulating scatter of
the (12, 12) edge blocks; a strong prior on keyframe 0 fixes the gauge
and damping regularizes padding rows, so one static-shape program serves
any graph up to capacity.

Landmarks are eliminated by Schur complement: All is block-diagonal
(3, 3) (closed-form adjugate inverse), the reduced system
S = App − Apl·All⁻¹·Alp couples only poses, and the landmarks
back-substitute in one batched product.

The solves are `cholesky_ex` plus two triangular solves, with no host
read: `torch.cholesky_solve` and `torch.linalg.inv` would synchronize
the stream.  A matrix that is not positive definite gives NaN poses, as
JAX's Cholesky does, and the callers reject them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.core.segment import segment_plan, segment_sum_planned
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


def _obs_residual(qi, ti, lpos, z, di, dl):
    """Landmark observations at retraction deltas (di (O, 6), dl (O, 3)):
    the landmark's position in keyframe i's frame, minus the measurement."""
    Pi = se3.retract(se3.Pose(qi, ti), di)
    return se3.apply(se3.inverse(Pi), lpos + dl) - z


def obs_r_and_J(qi, ti, lpos, z):
    """For O observations: (r (O, 3), Jp (O, 3, 6), Jl (O, 3, 3)) at zero
    deltas, written out (tests/test_torch_graph.py holds them equal to
    jax.jacfwd).  With Pᵢ ← exp(dᵢ) ∘ Pᵢ, dᵢ = (ω, v):

      r = Rᵀ(Exp(−ω)(l + dl − v) − t) − z,
      ∂r/∂ω = Rᵀ [l]×,  ∂r/∂v = −Rᵀ,  ∂r/∂dl = Rᵀ."""
    zero = ti.new_zeros((ti.shape[0], 6))
    r = _obs_residual(qi, ti, lpos, z, zero, zero[:, :3])
    Rt = se3.quat_to_matrix(qi).transpose(-2, -1)
    Jp = torch.cat([Rt @ _skew(lpos), -Rt], dim=-1)
    return r, Jp, Rt


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 inverse by the adjugate (no host read, unlike
    torch.linalg.inv, which checks its result on the host)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                      f * g - d * i, a * i - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d],
                     dim=-1).reshape(A.shape)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def _cho_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b by Cholesky; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return torch.where(info == 0, x, float("nan"))


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
    # index_put_(accumulate=True) on a CUDA tensor sorts the indices
    # stably and adds each index's values in that order, so it repeats to
    # the bit (tests/test_torch_cuda.py holds two solves equal), unlike
    # index_add_'s float atomics.
    H = r.new_zeros((6 * K, 6 * K))
    H.index_put_((rows[:, :, None].expand(E, 12, 12),
                  rows[:, None, :].expand(E, 12, 12)), blocks,
                 accumulate=True)
    b = r.new_zeros(6 * K).index_put_((rows,), bvec, accumulate=True)
    return H, b, cost


def _obs_terms(g: GraphArrays, obs_huber_delta: float = 0.5):
    """Per observation (r (O, 3), Jp (O, 3, 6), Jl (O, 3, 3), w (O, 3)) at
    the current estimate.  Observations get a Huber influence weight
    (delta in metres on the 3-D residual norm): post detections are
    ~0.3 m noisy and occasional cross-associations reach a metre."""
    oi, ol = g.o_i.long(), g.o_l.long()
    r, Jp, Jl = obs_r_and_J(g.q[oi], g.t[oi], g.l_pos[ol], g.o_z)
    rn = torch.linalg.vector_norm(r, dim=-1)
    hub = torch.where(rn <= obs_huber_delta, 1.0,
                      obs_huber_delta / torch.clamp(rn, min=1e-9))
    w = g.o_valid.to(r.dtype)[:, None] * g.o_info * hub[:, None]
    return r, Jp, Jl, w


def _assemble_landmark_terms(g: GraphArrays, max_poses: int,
                             max_landmarks: int,
                             obs_huber_delta: float = 0.5):
    """Landmark-coupled terms: App-add (6K, 6K), b_p-add (6K,), All
    (M, 3, 3), b_l (M, 3), the pose-coupling tensor T (M, 3, 6K) and the
    cost, with _obs_terms' Huber weights.  Every sum runs in a fixed order
    (see _assemble_pose_system); All and b_l on a plan of the observed
    landmarks."""
    K, M = max_poses, max_landmarks
    oi, ol = g.o_i.long(), g.o_l.long()
    r, Jp, Jl, w = _obs_terms(g, obs_huber_delta)
    Jpw = Jp * w[:, :, None]
    Jlw = Jl * w[:, :, None]
    cost = torch.sum(w * r * r)

    O = oi.shape[0]
    rows_p = oi[:, None] * 6 + torch.arange(6, device=oi.device)  # (O, 6)
    app = torch.einsum("ori,orj->oij", Jpw, Jp)                   # (O, 6, 6)
    H_pp = r.new_zeros((6 * K, 6 * K)).index_put_(
        (rows_p[:, :, None].expand(O, 6, 6),
         rows_p[:, None, :].expand(O, 6, 6)), app, accumulate=True)
    b_p = r.new_zeros(6 * K).index_put_(
        (rows_p,), torch.einsum("ori,or->oi", Jpw, r), accumulate=True)
    plan = segment_plan(ol, M)
    All = segment_sum_planned(torch.einsum("ori,orj->oij", Jlw, Jl), plan)
    b_l = segment_sum_planned(torch.einsum("ori,or->oi", Jlw, r), plan)
    Apl = torch.einsum("ori,orj->oij", Jpw, Jl)                   # (O, 6, 3)
    # T_l = Σ_o [rows_o ⊗ Apl_o]: one accumulating scatter.
    three = torch.arange(3, device=oi.device)
    T = r.new_zeros((M, 3, 6 * K)).index_put_(
        (ol[:, None, None].expand(O, 3, 6),
         three[None, :, None].expand(O, 3, 6),
         rows_p[:, None, :].expand(O, 3, 6)), Apl.transpose(1, 2),
        accumulate=True)
    return H_pp, b_p, All, b_l, T, cost


def _schur_step(g: GraphArrays, H_ee, b_ee, H_po, b_po, All, b_l, T,
                max_poses: int, max_landmarks: int, damping: float,
                prior_weight: float) -> GraphArrays:
    """One Gauss-Newton step from the assembled terms: Schur-eliminate
    the landmarks, solve the poses, back-substitute the landmarks."""
    K, M = max_poses, max_landmarks
    dev = g.q.device
    App = H_ee + H_po
    App.diagonal().add_(damping)
    App[:6, :6].diagonal().add_(prior_weight)                   # gauge
    b_p = b_ee + b_po

    land_mask = torch.arange(M, device=dev) < g.n_landmarks
    All = All + (damping + 1e-3) * torch.eye(3, device=dev)
    All_inv = torch.where(land_mask[:, None, None], _inv3(All), 0.0)

    U = torch.einsum("lab,lbk->lak", All_inv, T)                # (M, 3, 6K)
    S = App - T.reshape(3 * M, 6 * K).T @ U.reshape(3 * M, 6 * K)
    b_red = b_p - torch.einsum("lak,la->k", T,
                               torch.einsum("lab,lb->la", All_inv, b_l))
    delta_p = -_cho_solve(S, b_red)
    Alp_dp = torch.einsum("lak,k->la", T, delta_p)
    delta_l = -torch.einsum("lab,lb->la", All_inv, b_l + Alp_dp)

    pose_mask = (torch.arange(K, device=dev) < g.n_poses)[:, None]
    delta_p = torch.where(pose_mask, delta_p.reshape(K, 6), 0.0)
    delta_l = torch.where(land_mask[:, None], delta_l, 0.0)
    new = se3.retract(se3.Pose(g.q, g.t), delta_p)
    return g._replace(q=new.q, t=new.t, l_pos=g.l_pos + delta_l)


def _pose_step(g: GraphArrays, H, b, max_poses: int, damping: float,
               prior_weight: float) -> GraphArrays:
    """One pose-only Gauss-Newton step from the assembled H, b (H is
    damped and gauged in place): the dense Cholesky solve, retracted on
    the first n_poses poses."""
    K = max_poses
    H.diagonal().add_(damping)
    H[:6, :6].diagonal().add_(prior_weight)                     # gauge
    delta = -_cho_solve(H, b).reshape(K, 6)
    pose_mask = (torch.arange(K, device=g.q.device) < g.n_poses)[:, None]
    delta = torch.where(pose_mask, delta, 0.0)
    new = se3.retract(se3.Pose(g.q, g.t), delta)
    return g._replace(q=new.q, t=new.t)


def solve(g: GraphArrays, *, max_poses: int, iterations: int = 8,
          prior_weight: float = 1e6, damping: float = 1e-4
          ) -> Tuple[GraphArrays, SolveStats]:
    """Pose-only Gauss-Newton over odometry + loop-closure edges; a fixed
    iteration count with no host read."""
    K = max_poses
    c0 = c1 = None
    for it in range(iterations):
        H, b, cost = _assemble_pose_system(g, K)
        g = _pose_step(g, H, b, K, damping, prior_weight)
        c0 = cost if it == 0 else c0
        c1 = cost
    if c0 is None:
        c0 = c1 = torch.full((), float("inf"), device=g.q.device)
    return g, SolveStats(initial_cost=c0, final_cost=c1,
                         iterations=iterations)


def solve_with_landmarks(g: GraphArrays, *, max_poses: int,
                         max_landmarks: int, iterations: int = 8,
                         prior_weight: float = 1e6, damping: float = 1e-4
                         ) -> Tuple[GraphArrays, SolveStats]:
    """Bundle-style solve: pose-pose edges + pose-landmark observations,
    landmarks eliminated by Schur complement; a fixed iteration count
    with no host read."""
    K, M = max_poses, max_landmarks
    c0 = c1 = None
    for it in range(iterations):
        H_ee, b_ee, cost_e = _assemble_pose_system(g, K)
        H_po, b_po, All, b_l, T, cost_o = _assemble_landmark_terms(g, K, M)
        cost = cost_e + cost_o
        g = _schur_step(g, H_ee, b_ee, H_po, b_po, All, b_l, T, K, M,
                        damping, prior_weight)
        c0 = cost if it == 0 else c0
        c1 = cost
    if c0 is None:
        c0 = c1 = torch.full((), float("inf"), device=g.q.device)
    return g, SolveStats(initial_cost=c0, final_cost=c1,
                         iterations=iterations)
