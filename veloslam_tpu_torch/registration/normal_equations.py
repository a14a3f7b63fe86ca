"""Fused point-to-plane normal equations and the whole Gauss-Newton step:
CUDA kernel wrappers, their plain torch versions, and the launch counter.

Counterpart of veloslam_tpu/registration/pallas_kernels.py and of the
step in veloslam_tpu/registration/gicp.py::register.  One call linearizes
all F frame slots of one Gauss-Newton iteration with FIXED
correspondences (μ, n, hit):

    p′ = R(q)p + t,  r = n·(p′ − μ),  hit &= |r| < max_dist,
    w = Huber(r)·hit,  J = [p′ × n | n],
    H = Σ w·JJᵀ (6×6),  b = Σ w·J·r,  err_sum = Σ w·|r|,  w_sum = Σ w,
    n_hit = Σ hit;

`gn_iteration` then takes the damped, guarded, clamped step and returns
the new poses (`_gn_step`).  On the card both are one wrapper call of two
launches (csrc/normal_equations.cu), whose arithmetic runs in float64 on
the float32 inputs: it matches these functions evaluated in float64,
which their float32 evaluation does not where b's terms cancel.

Tensor placement picks the path: CPU tensors take the plain version
(tests and CPU runs), CUDA tensors launch the kernel or raise.
`LAUNCHES` counts wrapper calls that launched the kernel, so a run can
show that its GN iterations went through it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from veloslam_tpu_torch import _build
from veloslam_tpu_torch.core import se3

LAUNCHES = 0          # kernel launches in this process (plain calls: none)

# Points per work item of the kernel's partial pass.  Fixed, so the order
# of the float sums (and the result) does not depend on the card.
POINTS_PER_CHUNK = 4096
_N_SUMS = 30              # partial sums per work item (csrc kSums)


class GnIteration(NamedTuple):
    pose: se3.Pose        # exp(δ) ∘ pose, (F, 4) / (F, 3)
    H: torch.Tensor       # (F, 6, 6) normal matrix at the old pose
    b: torch.Tensor       # (F, 6)
    err: torch.Tensor     # (F,) mean |r|: err_sum / max(w_sum, 1)
    n_hit: torch.Tensor   # (F,) int32
    step: torch.Tensor    # (F,) int32: 0 rejected, 1 taken, 2 clamped


def normal_equations_plain(pts, q, t, mu, n, hit, *, huber_delta=0.5,
                           max_dist=2.0):
    """Torch-op version (the einsum path of gicp.normal_equations_fixed)
    → (H (F,6,6), b (F,6), err_sum (F,), w_sum (F,), n_hit (F,) int32)."""
    p = se3.apply(se3.Pose(q[:, None], t[:, None]), pts)
    r = torch.sum(n * (p - mu), dim=-1)
    absr = torch.abs(r)
    hit = hit.to(torch.bool) & (absr < max_dist)
    w = torch.where(absr <= huber_delta, 1.0,
                    huber_delta / torch.clamp(absr, min=1e-12))
    w = torch.where(hit, w, 0.0)
    J = torch.cat([se3.cross(p, n), n], dim=-1)               # (F, P, 6)
    Jw = J * w[..., None]
    H = torch.einsum("fpi,fpj->fij", Jw, J)
    b = torch.einsum("fpi,fp->fi", Jw, r)
    return (H, b, torch.sum(absr * w, dim=-1), torch.sum(w, dim=-1),
            hit.sum(dim=-1, dtype=torch.int32))


def _damped_step(Hd, b, n_hit):
    """δ = −Hd⁻¹b by a Cholesky solve, guarded and clamped: (δ (F,6),
    ok (F,), scale (F,)); δ is already zeroed where not ok and scaled."""
    L, info = torch.linalg.cholesky_ex(Hd)
    # L Lᵀ x = b as two triangular solves: torch.cholesky_solve's batched
    # CUDA path synchronizes the stream on every call (16 host stalls per
    # batch, measured on an H100); solve_triangular does not.
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    delta = -torch.linalg.solve_triangular(L.transpose(-2, -1), y,
                                           upper=True)[..., 0]
    # JAX's Cholesky of a non-PD matrix yields NaN that isfinite rejects;
    # cholesky_ex leaves a partial factor and sets info instead.
    ok = (torch.all(torch.isfinite(delta), dim=-1) & (n_hit > 10)
          & (info == 0))
    delta = torch.where(ok[:, None], delta, 0.0)
    # Clamp runaway steps (> 1 m or > 0.3 rad per iteration).
    tn = torch.linalg.vector_norm(delta[:, 3:], dim=-1)
    rn = torch.linalg.vector_norm(delta[:, :3], dim=-1)
    scale = torch.clamp(torch.minimum(
        1.0 / torch.clamp(tn, min=1e-12), 0.3 / torch.clamp(rn, min=1e-12)),
        max=1.0)
    return delta * scale[:, None], ok, scale


def _gn_delta(H, b, n_hit, damping: float):
    """The GICP step: Hd = H + damping·I + 1e-6·trace(H)·I, then
    `_damped_step`."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    Hd = H + damping * eye + 1e-6 * trace[:, None, None] * eye
    return _damped_step(Hd, b, n_hit)


def _gn_delta_shifted(H, b, n_hit, damping: float):
    """The D2D and NDT step: Hd = H + (damping + 1e-6·trace(H))·I, the
    shift added as one term as the JAX package's d2d.py and ndt.py write
    it (`_gn_delta` adds the two parts one after the other, which rounds
    differently in float32), then `_damped_step`."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    Hd = H + (damping + 1e-6 * trace)[:, None, None] * eye
    return _damped_step(Hd, b, n_hit)


def _gn_step(pose: se3.Pose, H, b, n_hit, damping: float) -> se3.Pose:
    """Damped Cholesky solve + guarded, clamped left retraction."""
    return se3.retract(pose, _gn_delta(H, b, n_hit, damping)[0])


def gn_iteration_plain(pts, pose: se3.Pose, mu, n, hit, *,
                       damping: float = 1e-6, huber_delta: float = 0.5,
                       max_dist: float = 2.0) -> GnIteration:
    """Torch-op version of `gn_iteration`: normal_equations_plain, then
    `_gn_step`'s solve, guard, clamp and retraction."""
    H, b, err_sum, w_sum, n_hit = normal_equations_plain(
        pts, pose.q, pose.t, mu, n, hit, huber_delta=huber_delta,
        max_dist=max_dist)
    delta, ok, scale = _gn_delta(H, b, n_hit, damping)
    step = torch.where(ok, torch.where(scale < 1.0, 2, 1), 0)
    return GnIteration(se3.retract(pose, delta), H, b,
                       err_sum / torch.clamp(w_sum, min=1.0), n_hit,
                       step.to(torch.int32))


def _check_inputs(pts, q, t, mu, n, hit):
    F, P = hit.shape[0], hit.shape[-1]
    want = {"pts": (pts, (F, P, 3), torch.float32),
            "q": (q, (F, 4), torch.float32),
            "t": (t, (F, 3), torch.float32),
            "mu": (mu, (F, P, 3), torch.float32),
            "n": (n, (F, P, 3), torch.float32),
            "hit": (hit, (F, P), torch.uint8)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, want {dtype}")
        if x.device != pts.device:
            raise ValueError(f"{name} on {x.device}, pts on {pts.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no normal-equations path for {pts.device}")
    if pts.device.type == "cuda":
        for name, x in (("pts", pts), ("mu", mu), ("n", n), ("hit", hit)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (the "
                                 "kernel loads 16-byte vectors)")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("normal_equations")
    fn = lib.veloslam_normal_equations
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 6 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float,
                                    ctypes.c_int] + [ptr] * 6
                       + [ctypes.c_float] + [ptr] * 5)
        fn.restype = ctypes.c_int
    return lib


def _launch(pts, q, t, mu, n, hit, huber_delta, max_dist, damping=None):
    """Both passes; with `damping` the finalize also takes the step.
    Returns (H, b, err_sum, w_sum, n_hit), or with `damping` a
    GnIteration."""
    global LAUNCHES
    F, P = hit.shape
    dev = pts.device
    k = max(1, -(-P // POINTS_PER_CHUNK))
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    partial = torch.empty((F, k, _N_SUMS), dtype=torch.float64, device=dev)
    H = torch.empty((F, 6, 6), **f32)
    b = torch.empty((F, 6), **f32)
    n_hit = torch.empty((F,), **i32)
    if damping is None:
        outs = (torch.empty((F,), **f32), torch.empty((F,), **f32))
        step_outs = (None,) * 4
        damping = 0.0
    else:
        outs = (None, None)
        step_outs = (torch.empty((F, 4), **f32), torch.empty((F, 3), **f32),
                     torch.empty((F,), **f32), torch.empty((F,), **i32))
    if F:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_lib().veloslam_normal_equations(
            pts.data_ptr(), q.data_ptr(), t.data_ptr(), mu.data_ptr(),
            n.data_ptr(), hit.data_ptr(), F, P, float(huber_delta),
            float(max_dist), POINTS_PER_CHUNK, partial.data_ptr(),
            H.data_ptr(), b.data_ptr(),
            *(x.data_ptr() if x is not None else None for x in outs),
            n_hit.data_ptr(), float(damping),
            *(x.data_ptr() if x is not None else None for x in step_outs),
            stream)
        if rc != 0:
            raise RuntimeError(f"normal_equations kernel launch failed: "
                               f"cudaError {rc}")
        LAUNCHES += 1
    if step_outs[0] is None:
        return (H, b, *outs, n_hit)
    q_out, t_out, err, step = step_outs
    return GnIteration(se3.Pose(q_out, t_out), H, b, err, n_hit, step)


def fused_normal_equations(pts, q, t, mu, n, hit, *, huber_delta=0.5,
                           max_dist=2.0):
    """Normal equations for F slots.  pts/mu/n (F,P,3) f32, q (F,4),
    t (F,3) f32, hit (F,P) uint8, all contiguous on one device (on the
    card pts, mu, n, hit 16-byte aligned) → (H (F,6,6), b (F,6),
    err_sum (F,), w_sum (F,), n_hit (F,) int32)."""
    _check_inputs(pts, q, t, mu, n, hit)
    if pts.device.type == "cpu":
        return normal_equations_plain(pts, q, t, mu, n, hit,
                                      huber_delta=huber_delta,
                                      max_dist=max_dist)
    return _launch(pts, q, t, mu, n, hit, huber_delta, max_dist)


def gn_iteration(pts, pose: se3.Pose, mu, n, hit, *, damping: float = 1e-6,
                 huber_delta: float = 0.5,
                 max_dist: float = 2.0) -> GnIteration:
    """One Gauss-Newton iteration of F slots with fixed correspondences:
    the normal equations at `pose` (leaves (F, 4) / (F, 3), contiguous
    float32), then Hd = H + damping·I + 1e-6·trace(H)·I, δ = −Hd⁻¹b, δ
    zeroed unless finite, n_hit > 10 and Hd positive definite, clamped to
    1 m and 0.3 rad, and pose′ = exp(δ) ∘ pose.  Inputs as
    `fused_normal_equations`."""
    _check_inputs(pts, pose.q, pose.t, mu, n, hit)
    if pts.device.type == "cpu":
        return gn_iteration_plain(pts, pose, mu, n, hit, damping=damping,
                                  huber_delta=huber_delta, max_dist=max_dist)
    return _launch(pts, pose.q, pose.t, mu, n, hit, huber_delta, max_dist,
                   damping)
