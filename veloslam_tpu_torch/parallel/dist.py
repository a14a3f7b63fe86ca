"""Multi-process runtime: process-group start-up, the collectives over a
mesh axis, tile-hash patch partitioning, and map shards from each rank's
own rows.

Port of veloslam_tpu/parallel/dist.py on torch.distributed.  One OS
process is one rank; the backend is the caller's choice and is never
swapped behind its back:

  * "nccl" (the default) on CUDA cards, one rank per card;
  * "gloo" when asked for: CPU ranks (`device="cpu"`), and several ranks
    sharing one card (NCCL refuses two ranks on one GPU).  Gloo reduces
    and gathers CUDA tensors itself (all_reduce and all_gather, checked
    on an H100 with torch 2.11), but its point-to-point send of a CUDA
    tensor aborts the process ("writev: Bad address"), so the ring
    exchange of a CUDA tensor over gloo is staged through pinned host
    memory here, explicitly and for that backend only.

A request that cannot be met raises: NCCL with more ranks than cards on
the host, NCCL on the CPU, a CUDA device without a card.  Every
process group carries a timeout, and `spawn_ranks` joins every rank
within its time limit and fails with the output of a rank that died,
raised or hung.

`COLLECTIVES` counts the collectives this process issued, by kind, so a
run can report collectives per registration or per frame.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from veloslam_tpu_torch.config import MeshConfig
from veloslam_tpu_torch.parallel import mesh as mesh_mod

DEFAULT_TIMEOUT_S = 600.0

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "ring": 0}


# --- start-up -----------------------------------------------------------------

def rank_device(device, backend: str, local_rank: int,
                local_ranks: int) -> torch.device:
    """The device a rank runs on.  "cuda" without an index is card
    `local_rank` under NCCL (one rank per card: more local ranks than
    cards raises) and card `local_rank % count` under gloo (ranks share
    cards); an explicit index is taken as it is.  A CUDA device without
    a card, or NCCL on the CPU, raises."""
    device = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' or 'gloo'")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("the NCCL backend runs on CUDA devices; pass "
                             "backend='gloo' for device='cpu'")
        return device
    if device.type != "cuda":
        raise ValueError(f"no multi-process path for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' and torch.cuda.is_available() is "
                           "False; pass device='cpu' and backend='gloo' to "
                           "run the ranks on the CPU")
    count = torch.cuda.device_count()
    if device.index is not None:
        if device.index >= count:
            raise ValueError(f"{device}: this host has {count} card(s)")
        return device
    if backend == "nccl":
        if local_ranks > count:
            raise ValueError(
                f"NCCL runs one rank per card: {local_ranks} ranks on this "
                f"host, {count} card(s) (NCCL refuses two ranks on one "
                f"GPU); ask for backend='gloo' to share a card")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


def start_process_group(coordinator_address: str, num_processes: int,
                        process_id: int, *, backend: str = "nccl",
                        device="cuda",
                        timeout_s: float = DEFAULT_TIMEOUT_S
                        ) -> torch.device:
    """Join a process group of `num_processes` ranks (1 included)
    through the TCP rendezvous at `coordinator_address` ("host:port");
    returns this rank's device (`rank_device`).  The local rank and the
    host's rank count come from LOCAL_RANK / LOCAL_WORLD_SIZE when a
    launcher sets them, else all ranks are on this host."""
    local = int(os.environ.get("LOCAL_RANK", process_id))
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dev = rank_device(device, backend, local, local_n)
    if tdist.is_initialized():
        if (tdist.get_world_size() != num_processes
                or tdist.get_rank() != process_id):
            raise RuntimeError(
                f"a process group of {tdist.get_world_size()} ranks (this "
                f"rank {tdist.get_rank()}) is already running")
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = coordinator_address.rsplit(":", 1)
    tdist.init_process_group(
        backend, init_method=f"tcp://{host}:{int(port)}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "nccl", device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start the multi-process runtime (idempotent); nothing to start for
    a single-process run, as in the JAX package.  Returns this rank's
    device.

    Arguments default from the environment (VELOSLAM_COORDINATOR /
    VELOSLAM_NUM_PROCESSES / VELOSLAM_PROCESS_ID).  Nothing on a machine
    tells a program of a cluster, so more than one process needs all
    three."""
    coordinator_address = coordinator_address or os.environ.get(
        "VELOSLAM_COORDINATOR")
    if num_processes is None and "VELOSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VELOSLAM_NUM_PROCESSES"])
    if process_id is None and "VELOSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VELOSLAM_PROCESS_ID"])
    if num_processes is None or num_processes <= 1:
        return rank_device(device, backend, 0, 1)
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and this process's id")
    return start_process_group(coordinator_address, num_processes,
                               process_id, backend=backend, device=device,
                               timeout_s=timeout_s)


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def global_mesh(device="cuda", data_axis: int = 1,
                map_axis: Optional[int] = None) -> mesh_mod.Mesh:
    """Mesh over ALL ranks (call after init_distributed)."""
    n = process_count()
    if map_axis is None:
        map_axis = n // data_axis
    if data_axis * map_axis != n:
        raise ValueError(f"mesh {data_axis}x{map_axis} != {n} ranks")
    return mesh_mod.make_mesh(MeshConfig(data_axis=data_axis,
                                         map_axis=map_axis), device)


# --- collectives over a mesh axis ---------------------------------------------

def all_reduce(mesh: mesh_mod.Mesh, x: torch.Tensor,
               axis: Optional[str] = "map") -> torch.Tensor:
    """Sum of `x` over the ranks of `axis` (None: all ranks), in place;
    returns `x`.  Every rank ends with the same bits."""
    group = mesh.group(axis)
    if group is not None:
        tdist.all_reduce(x, group=group)
        COLLECTIVES["all_reduce"] += 1
    return x


def all_gather(mesh: mesh_mod.Mesh, x: torch.Tensor,
               axis: Optional[str] = "map") -> torch.Tensor:
    """(S, *x.shape): `x` of each of the S ranks along `axis`, in axis
    order (None: all ranks, in rank order)."""
    group = mesh.group(axis)
    if group is None:
        return x[None].clone()
    n = len(mesh.axis_ranks(axis))
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    tdist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return out


def ring_exchange(mesh: mesh_mod.Mesh, to_right: torch.Tensor,
                  to_left: torch.Tensor, axis: str = "map"):
    """Ring point-to-point along `axis`: send `to_right` to the next rank
    and `to_left` to the previous one (wrapping); returns (from_left,
    from_right), the previous rank's `to_right` and the next rank's
    `to_left` — jax.lax.ppermute both ways.  One rank: local copies."""
    ranks = mesh.axis_ranks(axis)
    n = len(ranks)
    if mesh.group(axis) is None or n == 1:
        return to_right.clone(), to_left.clone()
    i = ranks.index(mesh.rank)
    right, left = ranks[(i + 1) % n], ranks[(i - 1) % n]
    bufs = [t.contiguous() for t in (to_right, to_left)]
    if mesh.backend == "gloo" and to_right.is_cuda:
        # Gloo's send of a CUDA tensor aborts: through pinned host memory.
        bufs = [torch.empty(b.shape, dtype=b.dtype,
                            pin_memory=True).copy_(b) for b in bufs]
    from_left = torch.empty_like(bufs[0])
    from_right = torch.empty_like(bufs[1])
    group = mesh.group(axis)
    # Tags keep the two messages apart where left and right are one rank
    # (two ranks); NCCL, which ignores tags, matches them in this order.
    ops = [tdist.P2POp(tdist.isend, bufs[0], right, group, tag=0),
           tdist.P2POp(tdist.isend, bufs[1], left, group, tag=1),
           tdist.P2POp(tdist.irecv, from_left, left, group, tag=0),
           tdist.P2POp(tdist.irecv, from_right, right, group, tag=1)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES["ring"] += 1
    dev = to_right.device
    return from_left.to(dev), from_right.to(dev)


def allgather(mesh: mesh_mod.Mesh, tree):
    """Every rank's leaves (numpy or tensors, the same shapes on every
    rank), concatenated along dim 0 in rank order, as numpy on every
    rank — jax's process_allgather(tiled=True)."""
    def one(leaf):
        x = torch.as_tensor(np.asarray(leaf), device=mesh.device)
        got = all_gather(mesh, x, axis=None)
        return got.reshape((-1,) + tuple(x.shape[1:])).cpu().numpy()
    return mesh_mod.tree_map(one, tree)


# --- map partitioning across ranks --------------------------------------------

def tile_owner(ix, iy, n_shards: int):
    """Deterministic shard id for map tile (ix, iy) — splitmix-style
    integer hash so neighboring tiles spread across ranks (load balance)
    rather than forming contiguous rank-sized blocks (hotspots under a
    moving sensor).  The JAX package's hash, bit for bit."""
    ix = np.asarray(ix, np.int64).astype(np.uint64)
    iy = np.asarray(iy, np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (ix * np.uint64(0x9E3779B97F4A7C15)
             + iy * np.uint64(0xC2B2AE3D27D4EB4F))
        h ^= (h >> np.uint64(33))
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= (h >> np.uint64(33))
    return (h % np.uint64(n_shards)).astype(np.int64)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def partition_plane_grid_rows(full, pid: int, n_shards: int,
                              tile_m: float = 16.0):
    """Host-local slice of a full PlaneGrid: the voxel rows whose TILE
    hashes to `pid` (tile_owner), key-sorted and padded back to the full
    capacity so every shard has equal row count.

    Returns ([keys, count, mean, cov, normal, usable], origin, voxel_size)
    as host numpy — feed them to `assemble_global_plane_grid`."""
    from veloslam_tpu_torch.registration import voxel as vx

    keys = _np(full.grid.keys)
    cap = keys.shape[0]
    centers = _np(vx.unpack_keys(torch.as_tensor(keys),
                                 torch.as_tensor(_np(full.grid.origin)),
                                 torch.as_tensor(_np(full.grid.voxel_size))))
    tile = np.floor(centers[:, :2] / tile_m).astype(np.int64)
    mine = ((tile_owner(tile[:, 0], tile[:, 1], n_shards) == pid)
            & (keys != vx.INVALID_KEY))

    def take(a, fill=0):
        a = _np(a)
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        sel = a[mine]
        out[:len(sel)] = sel
        return out

    my_keys = take(keys, fill=vx.INVALID_KEY)
    order = np.argsort(my_keys)        # binary-search invariant per shard
    rows = [my_keys[order], take(full.grid.count)[order],
            take(full.grid.mean)[order], take(full.grid.cov)[order],
            take(full.normal)[order], take(full.usable)[order]]
    return rows, _np(full.grid.origin), _np(full.grid.voxel_size)


def scatter_local_rows(mesh: mesh_mod.Mesh, tree, axis: str = "map"):
    """This rank's rows as its `axis` shard: each leaf (numpy or tensor,
    this rank's rows along dim 0) as a tensor on the mesh's device.  The
    block order is the ranks' order along `axis`, as
    jax.make_array_from_process_local_data assembles it."""
    del axis        # the rank's own rows are its block of any axis
    return mesh_mod.shard_to(mesh, mesh_mod.replicated(), tree)


def replicate(mesh: mesh_mod.Mesh, tree):
    """Identical host-local values as tensors on the mesh's device."""
    return mesh_mod.shard_to(mesh, mesh_mod.replicated(), tree)


def assemble_global_plane_grid(mesh: mesh_mod.Mesh, local_rows, origin,
                               voxel_size, axis: str = "map"):
    """This rank's `axis` shard of the map-sharded PlaneGrid: its own
    [keys, count, mean, cov, normal, usable] rows (key-sorted, as
    `partition_plane_grid_rows` gives them) with the shared origin and
    voxel size, its packed row table built on the mesh's device."""
    from veloslam_tpu_torch.registration import voxel as vx
    from veloslam_tpu_torch.registration.gicp import make_plane_grid

    keys, count, mean, cov, normal, usable = scatter_local_rows(
        mesh, list(local_rows), axis=axis)
    origin, voxel_size = replicate(mesh, [np.asarray(origin, np.float32),
                                          np.asarray(voxel_size,
                                                     np.float32)])
    grid = vx.VoxelGrid(keys=keys.to(torch.int32), count=count,
                        mean=mean.contiguous(), cov=cov.contiguous(),
                        origin=origin, voxel_size=voxel_size)
    return make_plane_grid(grid, normal.contiguous(), usable.to(torch.bool))


# --- launching ranks -------------------------------------------------------------

def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_entry(fn, rank: int, nprocs: int, port: int, backend: str,
                device: str, args: tuple, timeout_s: float, log_path: str,
                results) -> None:
    """Body of one spawned rank: output to its log file, the process
    group, fn(device, *args), the result (or the traceback) to the
    parent."""
    log = open(log_path, "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    try:
        dev = start_process_group(f"127.0.0.1:{port}", nprocs, rank,
                                  backend=backend, device=device,
                                  timeout_s=timeout_s)
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        results.put((rank, True, out))
    except BaseException:
        traceback.print_exc()
        results.put((rank, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        log.flush()


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "(no output)"


def spawn_ranks(fn, nprocs: int, *, backend: str, device="cuda",
                args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S,
                env: Optional[dict] = None) -> list:
    """Run `fn(device, *args)` on `nprocs` new processes (the "spawn"
    start method), one rank each of one process group over localhost
    (a group of one included); returns each rank's result in rank order.

    `fn` and its arguments are pickled (a module-level function).  Each
    rank's output goes to a log file.  A rank that raises, dies, or is
    not done within `timeout_s` fails the call with every rank's log
    tail, and every rank still running is terminated.  `env` entries are
    set in the ranks' environment (e.g. PYTHONPATH)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    results = ctx.Queue()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    logs = tempfile.mkdtemp(prefix="veloslam_ranks_")
    paths = [os.path.join(logs, f"rank{r}.log") for r in range(nprocs)]
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, r, nprocs, port, backend, str(device), args, timeout_s,
        paths[r], results)) for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < nprocs and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    # A result may still be in flight from a rank that
                    # exited cleanly: one more look before failing.
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = (f"rank(s) {dead} exited (codes "
                                   f"{[procs[r].exitcode for r in dead]}) "
                                   "without a result")
                        break
                elif time.monotonic() > deadline:
                    failure = f"not done within {timeout_s:.0f} s"
                    break
                else:
                    continue
            if ok:
                got[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0)
                   if failure is None else 5.0)
            if p.is_alive():
                failure = failure or f"rank {procs.index(p)} did not exit"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    try:
        if failure is not None:
            tails = "\n".join(f"--- rank {r} ({procs[r].exitcode}) ---\n"
                              f"{_tail(path)}"
                              for r, path in enumerate(paths))
            raise RuntimeError(f"{nprocs} {backend} rank(s) on {device}: "
                               f"{failure}\n{tails}")
        return [got[r] for r in range(nprocs)]
    finally:
        for path in paths:
            if os.path.exists(path):
                os.unlink(path)
        os.rmdir(logs)
