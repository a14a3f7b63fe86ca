"""Table gathers of the association step: CUDA kernel wrappers, their
plain torch versions, and the launch counters.

Counterparts of the Pallas probes in scripts/bench_pallas_gather.py:

    gather_i32(table (N,) int32, idx (M,) int32)     -> table[idx]  (M,)
    gather_rows8(table (V, 8) f32, idx (M,) int32)   -> table[idx]  (M, 8)

The first serves the dilated-index lookup and the key check of the
binary-search lookup (registration.voxel), the second the plane fetch of
registration.gicp.associate (rows [μ, n, 0, 0]).  Indices are in range
by contract: callers clamp.

Tensor placement picks the path: CPU tensors take the plain version,
CUDA tensors launch csrc/gather.cu or raise.  `LAUNCHES` counts kernel
launches per kernel name, so a run can show that its association went
through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from veloslam_tpu_torch import _build

# Kernel launches in this process (plain calls and empty gathers: none).
LAUNCHES = {"gather_i32": 0, "gather_rows8": 0}


def gather_i32_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_rows8_plain(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    return table[idx.long()]


def _check(name, table, idx, table_shape, table_dtype):
    if table.dim() != len(table_shape) or any(
            want is not None and got != want
            for got, want in zip(table.shape, table_shape)):
        want = tuple("N" if s is None else s for s in table_shape)
        raise ValueError(f"{name}: table shape {tuple(table.shape)}, want "
                         f"{want}")
    if idx.dim() != 1:
        raise ValueError(f"{name}: idx shape {tuple(idx.shape)}, want (M,)")
    if table.dtype != table_dtype:
        raise TypeError(f"{name}: table dtype {table.dtype}, want "
                        f"{table_dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx dtype {idx.dtype}, want torch.int32")
    if idx.device != table.device:
        raise ValueError(f"{name}: idx on {idx.device}, table on "
                         f"{table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: table and idx must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no path for {table.device}")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    for fn in (lib.veloslam_gather_i32, lib.veloslam_gather_rows8):
        if fn.argtypes is None:
            ptr = ctypes.c_void_p
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ptr]
            fn.restype = ctypes.c_int
    return lib


def _launch(name, table, idx, out):
    m = idx.shape[0]
    if m == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    fn = getattr(_kernel_lib(), f"veloslam_{name}")
    rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def gather_i32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N,) int32, idx (M,) int32 (16-byte aligned on the card),
    contiguous, one device → (M,)."""
    _check("gather_i32", table, idx, (None,), torch.int32)
    if table.device.type == "cpu":
        return gather_i32_plain(table, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=table.device)
    if idx.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("gather_i32: idx and out must be 16-byte aligned "
                         "(indices move as int4)")
    return _launch("gather_i32", table, idx, out)


def gather_rows8(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (V, 8) float32, 16-byte aligned, idx (M,) int32, contiguous,
    one device → (M, 8)."""
    _check("gather_rows8", table, idx, (None, 8), torch.float32)
    if table.device.type == "cpu":
        return gather_rows8_plain(table, idx)
    if table.data_ptr() % 16:
        raise ValueError("gather_rows8: table must be 16-byte aligned (rows "
                         "move as float4)")
    out = torch.empty((idx.shape[0], 8), dtype=torch.float32,
                      device=table.device)
    return _launch("gather_rows8", table, idx, out)
