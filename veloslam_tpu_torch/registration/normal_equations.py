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
the new poses (`_gn_step`).  On the card both are one wrapper call of one
launch (csrc/normal_equations.cu), whose arithmetic keeps b exact to
float32 rounding where its terms cancel (p′, r and the b sums in float64,
H's per-thread terms in float32: `normal_equations_mixed`): it matches
these functions evaluated in float64, which their float32 evaluation does
not.

Tensor placement picks the path: CPU tensors take the plain version
(tests and CPU runs), CUDA tensors launch the kernel or raise.
`LAUNCHES` counts wrapper calls that launched the kernel, so a run can
show that its GN iterations went through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from veloslam_tpu_torch import _build
from veloslam_tpu_torch.core import se3

LAUNCHES = 0          # kernel launches in this process (plain calls: none)

# The kernel's work items (`partition`): a block of 256 threads takes
# POINT_STEP points a step (4 a thread), an item 1 to MAX_STEPS steps of
# one slot, and a call at least TARGET_ITEMS items where the slots have
# that many steps, so that a few slots still spread over the card's SMs.
# A function of (F, P) alone, so the order of the float sums (and the
# result) does not depend on the card.
POINT_STEP = 1024
MAX_STEPS = 16
TARGET_ITEMS = 192
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


@functools.lru_cache(maxsize=None)
def partition(F: int, P: int) -> tuple:
    """The kernel's work items for F slots of P points: (chunk, k), k =
    ceil(P / chunk) ≥ 1 items a slot, item i covering points [i·chunk,
    min(P, (i+1)·chunk)).  chunk is 1 to MAX_STEPS POINT_STEPs (a multiple
    of 4).  A slot is cut into the fewest items that give F·k ≥
    TARGET_ITEMS, of near-equal size: a few slots still fill the card,
    and many slots stream long items with one reduction each."""
    steps = max(1, -(-P // POINT_STEP))
    k = min(steps, max(-(-TARGET_ITEMS // max(F, 1)),
                       -(-steps // MAX_STEPS)))
    chunk = -(-steps // k) * POINT_STEP
    return chunk, max(1, -(-P // chunk))


def _thread_points(P: int, chunk: int, k: int) -> torch.Tensor:
    """The points of one slot that each of the kernel's threads sums in
    float32, in its order: (k·256, n) indices into the slot's points, P
    where a thread has none, a row a thread in the order (item, warp,
    lane).  With P a multiple of 4, thread l of warp w
    takes points 4l..4l+3 of the warp's 128 of each 1024-point step of
    its item; otherwise point i of an item goes to thread i mod 256."""
    idx = torch.arange(k * chunk).clamp(max=P)
    if P % 4 == 0:
        steps = chunk // POINT_STEP
        idx = idx.reshape(k, steps, 8, 32, 4).permute(0, 2, 3, 1, 4)
    else:
        idx = idx.reshape(k, chunk // 256, 256).transpose(1, 2)
    return idx.reshape(k * 256, -1)


def normal_equations_mixed(pts, q, t, mu, n, hit, *, huber_delta=0.5,
                           max_dist=2.0):
    """The kernel's precision as a plain CPU function: p′, r, J and b's
    terms w·J·r in float64 from the float32 inputs (b's terms cancel); w,
    J and H's terms in float32, as are |r|·w and w, each summed in float32
    by each of the kernel's threads over its own points, in its order
    (`_thread_points` of `partition(F, P)`; H's terms fused as the
    kernel's fmaf), then in float32 over each warp's 32 lanes in the
    kernel's shuffle tree (a partial over 128 points a step: 128 to 2048),
    and in float64 across warps and items.  Outputs float32, as the
    kernel's: (H, b, err_sum, w_sum, n_hit)."""
    F, P = hit.shape
    rows = _thread_points(P, *partition(F, P))
    H = torch.empty(F, 6, 6)
    b = torch.empty(F, 6)
    err_sum, w_sum = torch.empty(F), torch.empty(F)
    n_hit = torch.empty(F, dtype=torch.int32)
    for f in range(F):                  # a slot at a time: bounded memory
        p = se3.apply(se3.Pose(q[f].double(), t[f].double()), pts[f].double())
        nd = n[f].double()
        r = torch.sum(nd * (p - mu[f].double()), dim=-1)
        absr = torch.abs(r)
        use = hit[f].to(torch.bool) & (absr < max_dist)
        # w·r: r inside the Huber radius, ±huber outside; 0·r (NaN where r
        # is) without a correspondence.
        wr = torch.where(use, torch.where(
            absr <= huber_delta, r,
            torch.copysign(torch.full_like(r, huber_delta), r)), 0.0 * r)
        cross = se3.cross(p, nd)
        b[f] = (torch.cat([cross, nd], dim=-1) * wr[:, None]).sum(0).float()
        arf = absr.float()
        w = torch.where(use, torch.where(arf <= huber_delta, 1.0,
                                         huber_delta / arf), 0.0)
        e = torch.where(use, torch.clamp(arf, max=huber_delta), 0.0 * arf)
        J = torch.cat([cross.float(), n[f]], dim=-1)               # (P, 6)
        # fmaf(w·J_a, J_c, h): the product exact in float64, one rounding.
        terms = torch.cat([((J * w[:, None]).double()[:, :, None]
                            * J.double()[:, None, :]).reshape(P, 36),
                           e.double()[:, None], w.double()[:, None]],
                          dim=-1)                                  # (P, 38)
        terms = torch.cat([terms, terms.new_zeros(1, 38)])[rows]
        acc = torch.zeros(rows.shape[0], 38)
        for i in range(rows.shape[1]):          # each thread's float32 sums
            acc = (acc.double() + terms[:, i]).float()
        lanes = acc.reshape(-1, 32, 38)         # (warps, lanes): the tree
        for off in (16, 8, 4, 2, 1):
            lanes = lanes[:, :off] + lanes[:, off:2 * off]
        sums = lanes[:, 0].double().sum(dim=0)
        H[f] = sums[:36].reshape(6, 6).float()
        err_sum[f], w_sum[f] = sums[36].float(), sums[37].float()
        n_hit[f] = use.sum()
    return H, b, err_sum, w_sum, n_hit


def _check_inputs(pts, q, t, mu, n, hit):
    F, P = hit.shape[0], hit.shape[-1]
    dev = pts.device
    f32 = torch.float32
    for name, x, shape, dtype in (
            ("pts", pts, (F, P, 3), f32), ("q", q, (F, 4), f32),
            ("t", t, (F, 3), f32), ("mu", mu, (F, P, 3), f32),
            ("n", n, (F, P, 3), f32), ("hit", hit, (F, P), torch.uint8)):
        if x.shape != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, want {dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, pts on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no normal-equations path for {dev}")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("normal_equations")
    fn = lib.veloslam_normal_equations
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 6 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float,
                                    ctypes.c_int] + [ptr] * 7
                       + [ctypes.c_float] + [ptr] * 5)
        fn.restype = ctypes.c_int
    return lib


# Per (device, stream): the kernel's tickets (one per slot, zero between
# launches: the slot's last block resets its own) and partial-sum scratch,
# grown as needed.  Launches on one stream run in order, so they share them.
_SCRATCH: dict = {}


def _scratch(dev, stream: int, F: int, n_partial: int):
    key = (dev.index, stream)
    tickets, partial = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < F:
        tickets = torch.zeros(max(F, 256), dtype=torch.int32, device=dev)
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(max(n_partial, 1 << 16), dtype=torch.float64,
                              device=dev)
    _SCRATCH[key] = (tickets, partial)
    return tickets, partial


def _launch(pts, q, t, mu, n, hit, huber_delta, max_dist, damping=None):
    """One launch; with `damping` the kernel also takes the step.
    Returns (H, b, err_sum, w_sum, n_hit), or with `damping` a
    GnIteration: views of one float32 buffer."""
    global LAUNCHES
    ptrs = [x.data_ptr() for x in (pts, q, t, mu, n, hit)]
    for name, ptr in zip(("pts", "mu", "n", "hit"), ptrs[:1] + ptrs[3:]):
        if ptr % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16-byte vectors)")
    F, P = hit.shape
    dev = pts.device
    # H, b, n_hit, then err_sum, w_sum or q, t, err, step (int32 as bits).
    sizes = [36 * F, 6 * F, F] + ([F, F] if damping is None
                                  else [4 * F, 3 * F, F, F])
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    parts = out.split_with_sizes(sizes)
    if F:
        chunk, k = partition(F, P)
        # torch's raw getter of the current stream's handle, which builds
        # no Stream object (torch.cuda.current_stream does).
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        tickets, partial = _scratch(dev, stream, F, F * k * _N_SUMS)
        o = [x.data_ptr() for x in parts]
        if damping is None:
            tail = [o[3], o[4], o[2], 0.0, None, None, None, None]
        else:
            tail = [None, None, o[2], float(damping), *o[3:]]
        rc = _kernel_lib().veloslam_normal_equations(
            *ptrs, F, P, float(huber_delta), float(max_dist), chunk,
            partial.data_ptr(), tickets.data_ptr(), o[0], o[1], *tail,
            stream)
        if rc != 0:
            raise RuntimeError(f"normal_equations kernel launch failed: "
                               f"cudaError {rc}")
        LAUNCHES += 1
    H, b = parts[0].view(F, 6, 6), parts[1].view(F, 6)
    n_hit = parts[2].view(torch.int32)
    if damping is None:
        return H, b, parts[3], parts[4], n_hit
    return GnIteration(se3.Pose(parts[3].view(F, 4), parts[4].view(F, 3)),
                       H, b, parts[5], n_hit, parts[6].view(torch.int32))


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
