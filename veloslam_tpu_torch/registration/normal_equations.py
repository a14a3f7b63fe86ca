"""Fused point-to-plane normal equations: CUDA kernel wrapper, its plain
torch version, and the launch counter.

Counterpart of veloslam_tpu/registration/pallas_kernels.py.  One call
linearizes all F frame slots of one Gauss-Newton iteration with FIXED
correspondences (μ, n, hit):

    p′ = R(q)p + t,  r = n·(p′ − μ),  hit &= |r| < max_dist,
    w = Huber(r)·hit,  J = [p′ × n | n],
    H = Σ w·JJᵀ (6×6),  b = Σ w·J·r,  err_sum = Σ w·|r|,  w_sum = Σ w,
    n_hit = Σ hit.

Tensor placement picks the path: CPU tensors take the plain version
(tests and CPU runs), CUDA tensors launch csrc/normal_equations.cu or
raise.  `LAUNCHES` counts kernel launches, so a run can show that its
GN iterations went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from veloslam_tpu_torch import _build
from veloslam_tpu_torch.core import se3

LAUNCHES = 0          # kernel launches in this process (plain calls: none)

POINTS_PER_BLOCK = 2048   # share of P one thread block reduces
_N_SUMS = 30              # partial sums per block (csrc kSums)


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


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("normal_equations")
    fn = lib.veloslam_normal_equations
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 6 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float,
                                    ctypes.c_int] + [ptr] * 7)
        fn.restype = ctypes.c_int
    return lib


def _launch(pts, q, t, mu, n, hit, huber_delta, max_dist):
    global LAUNCHES
    F, P = hit.shape
    dev = pts.device
    k = max(1, -(-P // POINTS_PER_BLOCK))
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((F, k, _N_SUMS), **f32)
    H = torch.empty((F, 6, 6), **f32)
    b = torch.empty((F, 6), **f32)
    err_sum = torch.empty((F,), **f32)
    w_sum = torch.empty((F,), **f32)
    n_hit = torch.empty((F,), dtype=torch.int32, device=dev)
    if F == 0:
        return H, b, err_sum, w_sum, n_hit
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel_lib().veloslam_normal_equations(
        pts.data_ptr(), q.data_ptr(), t.data_ptr(), mu.data_ptr(),
        n.data_ptr(), hit.data_ptr(), F, P, float(huber_delta),
        float(max_dist), k, partial.data_ptr(), H.data_ptr(), b.data_ptr(),
        err_sum.data_ptr(), w_sum.data_ptr(), n_hit.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"normal_equations kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return H, b, err_sum, w_sum, n_hit


def fused_normal_equations(pts, q, t, mu, n, hit, *, huber_delta=0.5,
                           max_dist=2.0):
    """Normal equations for F slots.  pts/mu/n (F,P,3) f32, q (F,4),
    t (F,3) f32, hit (F,P) uint8, all contiguous on one device →
    (H (F,6,6), b (F,6), err_sum (F,), w_sum (F,), n_hit (F,) int32)."""
    _check_inputs(pts, q, t, mu, n, hit)
    if pts.device.type == "cpu":
        return normal_equations_plain(pts, q, t, mu, n, hit,
                                      huber_delta=huber_delta,
                                      max_dist=max_dist)
    if pts.device.type != "cuda":
        raise ValueError(f"no normal-equations path for {pts.device}")
    return _launch(pts, q, t, mu, n, hit, huber_delta, max_dist)
