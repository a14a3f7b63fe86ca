"""The odometry-chain preconditioner of the PCG pose-graph solvers: CUDA
kernel wrappers, their plain torch versions, and the launch counters.

Counterparts of veloslam_tpu/graph/pcg.py::_chain_precond and
::_chain_solve, which are lax.scan recurrences (no Pallas original):

    chain_factor(D (K, 6, 6), B (K, 6, 6)) -> (Uinv (K, 6, 6), L (K, 6, 6))
    chain_solve(Uinv, L, B, r (K, 6))      -> z (K, 6)

the block-Thomas factorisation of the block-tridiagonal matrix with
diagonal blocks D and couplings B (B[k] joins poses k and k + 1), and the
solve M z = r by a forward and a backward sweep (csrc/chain.cu states the
recurrences).

Tensor placement picks the path: CPU tensors take the plain version (a
Python loop over K), CUDA tensors launch csrc/chain.cu or raise.
`LAUNCHES` counts kernel launches per entry point, so a run can show that
its preconditioner went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from veloslam_tpu_torch import _build

# Kernel launches in this process (plain calls and K = 0: none).
LAUNCHES = {"chain_factor": 0, "chain_solve": 0}


def chain_factor_plain(D: torch.Tensor, B: torch.Tensor):
    """The factorisation step by step, any float dtype (float64 serves as
    a reference); torch.linalg.inv_ex inverts each U_k."""
    if D.shape[0] == 0:
        return torch.empty_like(D), torch.empty_like(D)
    Ds, Bs = D.unbind(0), B.unbind(0)
    Ls = [torch.zeros_like(Ds[0])]
    Us = [torch.linalg.inv_ex(Ds[0])[0]]
    for k in range(1, len(Ds)):
        Ls.append(Bs[k - 1].T @ Us[-1])
        Us.append(torch.linalg.inv_ex(Ds[k] - Ls[-1] @ Bs[k - 1])[0])
    return torch.stack(Us), torch.stack(Ls)


def chain_solve_plain(Uinv: torch.Tensor, L: torch.Tensor, B: torch.Tensor,
                      r: torch.Tensor) -> torch.Tensor:
    """The forward and backward sweeps step by step, any float dtype."""
    K = r.shape[0]
    if K == 0:
        return torch.empty_like(r)
    Us, Ls, Bs, rs = Uinv.unbind(0), L.unbind(0), B.unbind(0), r.unbind(0)
    ys = [rs[0]]                                  # L_0 = 0
    for k in range(1, K):
        ys.append(rs[k] - Ls[k] @ ys[-1])
    zs = [Us[K - 1] @ ys[K - 1]]                  # no coupling past K - 1
    for k in range(K - 2, -1, -1):
        zs.append(Us[k] @ (ys[k] - Bs[k] @ zs[-1]))
    return torch.stack(zs[::-1])


def _check(name: str, mats, vecs=()) -> None:
    first = mats[0]
    K = first.shape[0]
    for x in mats:
        if x.dim() != 3 or tuple(x.shape) != (K, 6, 6):
            raise ValueError(f"{name}: block shape {tuple(x.shape)}, want "
                             f"({K}, 6, 6)")
    for x in vecs:
        if tuple(x.shape) != (K, 6):
            raise ValueError(f"{name}: vector shape {tuple(x.shape)}, want "
                             f"({K}, 6)")
    for x in (*mats, *vecs):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, want torch.float32")
        if x.device != first.device:
            raise ValueError(f"{name}: tensors on {x.device} and "
                             f"{first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no path for {first.device}")
    if first.device.type == "cuda" and (
            any(x.data_ptr() % 16 for x in mats)
            or any(x.data_ptr() % 8 for x in vecs)):
        raise ValueError(f"{name}: blocks must be 16-byte aligned and "
                         "vectors 8-byte aligned (they move as float4 / "
                         "float2)")


def _kernel_lib() -> ctypes.CDLL:
    return bind(_build.load("chain"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a loaded build of csrc/chain.cu."""
    ptr = ctypes.c_void_p
    for fn, n_ptrs in ((lib.veloslam_chain_factor, 4),
                       (lib.veloslam_chain_solve, 5)):
        if fn.argtypes is None:
            fn.argtypes = [ptr] * n_ptrs + [ctypes.c_int64, ptr]
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, K: int, *tensors) -> None:
    if K == 0:
        return
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    fn = getattr(_kernel_lib(), f"veloslam_{name}")
    rc = fn(*(x.data_ptr() for x in tensors), K, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def chain_factor(D: torch.Tensor, B: torch.Tensor):
    """D, B (K, 6, 6) float32, contiguous, one device → (Uinv, L)."""
    _check("chain_factor", (D, B))
    if D.device.type == "cpu":
        return chain_factor_plain(D, B)
    Uinv, L = torch.empty_like(D), torch.empty_like(D)
    _launch("chain_factor", D.shape[0], D, B, Uinv, L)
    return Uinv, L


def chain_solve(Uinv: torch.Tensor, L: torch.Tensor, B: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """The factors and couplings (K, 6, 6), r (K, 6), float32, contiguous,
    one device → z (K, 6)."""
    _check("chain_solve", (Uinv, L, B), (r,))
    if r.device.type == "cpu":
        return chain_solve_plain(Uinv, L, B, r)
    z = torch.empty_like(r)
    _launch("chain_solve", r.shape[0], Uinv, L, B, r, z)
    return z
