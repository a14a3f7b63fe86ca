"""Batched quaternion / SE(3) math on torch tensors.

Port of veloslam_tpu/core/se3.py (device half).  Quaternions are unit
(w, x, y, z); a pose is the pair (q (..., 4), t (..., 3)).  Every function
broadcasts over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Pose(NamedTuple):
    """SE(3) element: unit quaternion (..., 4) wxyz + translation (..., 3)."""

    q: torch.Tensor
    t: torch.Tensor


# --- quaternions -------------------------------------------------------------

def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a, b):
    """Cross product with broadcasting (torch.linalg.cross broadcasts too,
    but spelled out it matches the JAX formula term for term)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def _safe_norm(v, eps=1e-24):
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=eps))


def quat_exp(rotvec):
    """so(3) rotation vector (..., 3) -> unit quaternion."""
    angle = _safe_norm(rotvec)
    small = angle < 1e-6
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(0.5 * angle) / angle)
    return torch.cat([torch.cos(0.5 * angle), k * rotvec], dim=-1)


def quat_log(q):
    """Unit quaternion -> so(3) rotation vector (..., 3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)   # the short way round
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = _safe_norm(q[..., 1:])
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), angle / vn)
    return k * q[..., 1:]


def quat_slerp(q0, q1, u):
    """Spherical interpolation; u (...,) in [0, 1]."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    near = sin_t < 1e-6
    u = u[..., None]
    safe_sin = torch.where(near, 1.0, sin_t)
    w0 = torch.where(near, 1.0 - u, torch.sin((1.0 - u) * theta) / safe_sin)
    w1 = torch.where(near, u, torch.sin(u * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


# --- SE(3) -------------------------------------------------------------------

def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(quat_mul(a.q, b.q), a.t + quat_rotate(a.q, b.t))


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(qi, -quat_rotate(qi, p.t))


def apply(p: Pose, pts):
    """Transform points (..., 3)."""
    return quat_rotate(p.q, pts) + p.t


def interp(a: Pose, b: Pose, u) -> Pose:
    """Slerp/lerp interpolation between poses at fraction u in [0, 1]."""
    return Pose(quat_slerp(a.q, b.q, u), a.t + u[..., None] * (b.t - a.t))


def exp(tangent) -> Pose:
    """Decoupled SO(3)×R³ exponential of (..., 6) = (rotvec, translation)."""
    return Pose(quat_exp(tangent[..., :3]), tangent[..., 3:])


def log(p: Pose):
    """Inverse of `exp`: (..., 6) tangent (rotvec, translation)."""
    return torch.cat([quat_log(p.q), p.t], dim=-1)


def retract(p: Pose, delta) -> Pose:
    """Left-multiplicative update: exp(delta) ∘ p (delta: (..., 6))."""
    return compose(exp(delta), p)


# --- host copy (numpy) -------------------------------------------------------

def euler_deg_to_quat_np(roll_deg, pitch_deg, yaw_deg) -> np.ndarray:
    """Numpy copy of veloslam_tpu.core.se3.euler_deg_to_quat_np: the
    reference's R = Ry(roll)·Rx(pitch)·Rz(yaw) convention, degrees, for
    host code that builds pose tracks."""

    def axis_angle(ax, ang):
        half = 0.5 * ang
        return np.concatenate([np.cos(half)[..., None],
                               np.sin(half)[..., None] * ax], -1)

    def mul(a, b):
        w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
        w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
        return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                         w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)

    r = np.deg2rad(np.asarray(roll_deg, np.float64))
    p = np.deg2rad(np.asarray(pitch_deg, np.float64))
    y = np.deg2rad(np.asarray(yaw_deg, np.float64))
    zero, one = np.zeros_like(r), np.ones_like(r)
    qy = axis_angle(np.stack([zero, one, zero], -1), r)
    qx = axis_angle(np.stack([one, zero, zero], -1), p)
    qz = axis_angle(np.stack([zero, zero, one], -1), y)
    q = mul(qy, mul(qx, qz))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
