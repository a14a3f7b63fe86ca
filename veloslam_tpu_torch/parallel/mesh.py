"""Rank mesh for the multi-device port.

Port of veloslam_tpu/parallel/mesh.py.  JAX runs shard_map bodies over a
Mesh of devices; here one OS process is one position of the mesh, in a
torch.distributed process group, and the mesh lays the group's ranks out
as a ("data", "map") grid, row-major as the JAX mesh reshapes its
devices:

  * "data": data parallelism over packet batches / scans,
  * "map":  spatial parallelism over map voxels, keyframes and pose-graph
            edges.

Rank r sits at (data r // map_axis, map r % map_axis).  Each axis has its
own process group: the ranks of this rank's row ("map") or column
("data"), the whole world when the axis spans it.  A spec names the axis
a tensor is split over: `map_spec()` — this rank holds row block `i` of
`map_axis` equal blocks along dim 0, `i` its "map" coordinate;
`replicated()` — every rank holds the same tensor.  `shard_to` takes this
rank's block.  Collectives over an axis are in `parallel/dist.py`.

With no process group (one process, as the JAX package's
init_distributed leaves a single-process run) the mesh is 1 × 1 and the
collectives are local copies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from veloslam_tpu_torch.config import MeshConfig


class Mesh:
    """This rank's place in a data_axis × map_axis grid of ranks, its
    device, the group's backend (None without a process group) and one
    process group per axis (None where the axis is local: size 1)."""

    def __init__(self, data_axis: int, map_axis: int, device,
                 groups: dict, backend: Optional[str]):
        self.data_axis = int(data_axis)
        self.map_axis = int(map_axis)
        self.device = torch.device(device)
        self.backend = backend
        self.rank = tdist.get_rank() if backend is not None else 0
        self._groups = groups

    @property
    def size(self) -> int:
        return self.data_axis * self.map_axis

    @property
    def shape(self) -> dict:
        return {"data": self.data_axis, "map": self.map_axis}

    @property
    def coords(self) -> dict:
        return {"data": self.rank // self.map_axis,
                "map": self.rank % self.map_axis}

    def group(self, axis: Optional[str]):
        """The process group of `axis` ("data", "map", or None for all
        ranks); None when the collective is a local copy."""
        if axis is None:
            return tdist.group.WORLD if self.backend is not None else None
        return self._groups[axis]

    def axis_ranks(self, axis: Optional[str]) -> list:
        """Global ranks along `axis` through this rank, in axis order."""
        if axis is None:
            return list(range(self.size))
        d, m = self.coords["data"], self.coords["map"]
        if axis == "map":
            return [d * self.map_axis + i for i in range(self.map_axis)]
        return [i * self.map_axis + m for i in range(self.data_axis)]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data_axis}, map={self.map_axis}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> Mesh:
    """The ("data", "map") mesh over every rank of the process group
    (after dist.init_distributed), or the 1 × 1 mesh of a process with no
    group.  Every rank must call it, in the same order as any other group
    construction: each axis group is made with torch.distributed.new_group.
    Raises when the layout does not cover the ranks exactly, when `device`
    is CUDA and there is no card, or when the NCCL backend is asked to run
    on the CPU."""
    cfg = cfg or MeshConfig()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh's device is CUDA and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' (with the gloo backend)")
    if tdist.is_available() and tdist.is_initialized():
        backend = str(tdist.get_backend())
        world = tdist.get_world_size()
    else:
        backend, world = None, 1
    if cfg.n_devices != world:
        raise ValueError(f"mesh {cfg.data_axis}x{cfg.map_axis} needs "
                         f"{cfg.n_devices} ranks, the process group has "
                         f"{world}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend runs on CUDA devices, not "
                         f"{device}; use the gloo backend on the CPU")
    groups = {"data": None, "map": None}
    if backend is not None:
        rank = tdist.get_rank()
        grid = np.arange(world).reshape(cfg.data_axis, cfg.map_axis)
        for axis, lines in (("map", grid), ("data", grid.T)):
            if lines.shape[1] == world:
                groups[axis] = tdist.group.WORLD
            elif lines.shape[1] == 1:
                groups[axis] = None
            else:
                # new_group is collective over the world: every rank makes
                # every line's group and keeps its own.
                for line in lines:
                    g = tdist.new_group([int(r) for r in line])
                    if rank in line:
                        groups[axis] = g
    return Mesh(cfg.data_axis, cfg.map_axis, device, groups, backend)


def data_spec() -> str:
    return "data"


def map_spec() -> str:
    return "map"


def replicated() -> None:
    return None


def block(x, mesh: Mesh, axis: Optional[str]):
    """This rank's block of `x` along dim 0 for spec `axis` (the whole of
    `x` when replicated).  Raises when dim 0 does not split evenly."""
    if axis is None:
        return x
    n, i = mesh.shape[axis], mesh.coords[axis]
    rows = x.shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not split over the {n} ranks of "
                         f"the {axis!r} axis")
    per = rows // n
    return x[i * per:(i + 1) * per]


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float))


def tree_map(fn, tree, *rest):
    """fn over the leaves (tensors, arrays, numbers) of a tree of
    NamedTuples, tuples, lists and dicts; `rest` trees alongside (a spec
    tree may hold None or an axis name where `tree` holds a leaf)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def shard_to(mesh: Mesh, spec, tree):
    """Every leaf of `tree` as a tensor on the mesh's device, cut to this
    rank's block: `spec` is one axis name (or None) for every leaf, or a
    tree of them shaped like `tree`."""
    def put(leaf, axis):
        return block(torch.as_tensor(leaf, device=mesh.device), mesh, axis)
    if spec is None or isinstance(spec, str):
        return tree_map(lambda leaf: put(leaf, spec), tree)
    return tree_map(put, tree, spec)
