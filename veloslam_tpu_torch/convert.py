"""Carry calibration, odometry, full-SLAM and pose-graph state across
from the JAX package.

The JAX package's `DeviceCalib`, `OdometryState` (with the sampling
carry of the batched path or the assembly carry of the fused one),
`KeyframeRing`, `SlamState` and `GraphArrays` are NamedTuples; converted
leaf by leaf with `np.asarray`, they become trees of numpy arrays with the
same field names.  Its host `PoseGraph` crosses as the fields that
`PoseGraph.save` writes.  These functions turn such trees into the
port's tensors on a device, and the port's state back into numpy, so both
packages can start a step from one mid-drive state.  The port's ring
carries one trash row past its capacity (runtime.fullslam.KeyframeRing);
it is added on the way in and cut off on the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.decode.frames import AssemblyCarry, SampleCarry
from veloslam_tpu_torch.graph.posegraph import GraphArrays, PoseGraph
from veloslam_tpu_torch.registration.voxel import VoxelGrid
from veloslam_tpu_torch.runtime.fullslam import KeyframeRing, SlamState
from veloslam_tpu_torch.runtime.odometry import OdometryState

_RING_ROWS = ("q", "t", "time_rel_s", "desc", "pts", "msk")


def _tree_to_torch(cls, leaves, device):
    # np.array copies: arrays viewed from JAX buffers are read-only.
    return cls(**{f: torch.as_tensor(np.array(getattr(leaves, f)),
                                     device=device) for f in cls._fields})


def _tree_to_numpy(tree):
    return type(tree)(*(x.detach().cpu().numpy() for x in tree))


def calib_from_numpy(leaves, device) -> DeviceCalib:
    """A DeviceCalib-shaped tree of numpy arrays → the port's DeviceCalib."""
    return _tree_to_torch(DeviceCalib, leaves, device)


def odometry_state_from_numpy(leaves, device) -> OdometryState:
    """An OdometryState-shaped tree of numpy arrays → the port's
    OdometryState on `device`; the carry is an AssemblyCarry when it has
    the assembly's fields, else a SampleCarry."""
    rest = {f: torch.as_tensor(np.array(getattr(leaves, f)), device=device)
            for f in OdometryState._fields if f not in ("carry", "map_grid")}
    carry = (AssemblyCarry if hasattr(leaves.carry, "intensity")
             else SampleCarry)
    return OdometryState(
        carry=_tree_to_torch(carry, leaves.carry, device),
        map_grid=_tree_to_torch(VoxelGrid, leaves.map_grid, device), **rest)


def odometry_state_to_numpy(state: OdometryState) -> OdometryState:
    """The port's OdometryState with every leaf as a host numpy array."""
    rest = {f: getattr(state, f).detach().cpu().numpy()
            for f in OdometryState._fields if f not in ("carry", "map_grid")}
    return OdometryState(carry=_tree_to_numpy(state.carry),
                         map_grid=_tree_to_numpy(state.map_grid), **rest)


def ring_from_numpy(leaves, device) -> KeyframeRing:
    """A KeyframeRing-shaped tree of numpy arrays (capacity rows) → the
    port's ring (capacity + 1 rows, the last one the trash row)."""
    out = {}
    for f in KeyframeRing._fields:
        a = np.array(getattr(leaves, f))
        if f in _RING_ROWS:
            a = np.concatenate([a, np.zeros_like(a[:1])])
        out[f] = torch.as_tensor(a, device=device)
    return KeyframeRing(**out)


def ring_to_numpy(ring: KeyframeRing) -> KeyframeRing:
    """The port's ring as numpy leaves, trash row cut off."""
    K = ring.capacity
    return KeyframeRing(*(
        x[:K].detach().cpu().numpy() if f in _RING_ROWS
        else x.detach().cpu().numpy()
        for f, x in zip(KeyframeRing._fields, ring)))


def slam_state_from_numpy(leaves, device) -> SlamState:
    return SlamState(odom=odometry_state_from_numpy(leaves.odom, device),
                     kf=ring_from_numpy(leaves.kf, device))


def slam_state_to_numpy(state: SlamState) -> SlamState:
    return SlamState(odom=odometry_state_to_numpy(state.odom),
                     kf=ring_to_numpy(state.kf))


def graph_arrays_from_numpy(leaves, device) -> GraphArrays:
    """A GraphArrays-shaped tree of numpy arrays → the port's GraphArrays
    on `device`."""
    return _tree_to_torch(GraphArrays, leaves, device)


def posegraph_from_numpy(arrays) -> PoseGraph:
    """The fields of PoseGraph.save (an npz or a dict of numpy arrays) →
    the port's host PoseGraph."""
    return PoseGraph.from_arrays(arrays)
