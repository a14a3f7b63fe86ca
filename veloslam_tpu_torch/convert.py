"""Carry calibration and odometry state across from the JAX package.

The JAX package's `DeviceCalib` and `OdometryState` (sample-assembly
carry) are NamedTuples; converted leaf by leaf with `np.asarray`, they
become trees of numpy arrays with the same field names.  These functions
turn such trees into the port's tensors on a device, and the port's state
back into numpy, so both packages can start a step from one mid-drive
state.
"""

from __future__ import annotations

import numpy as np
import torch

from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.decode.frames import SampleCarry
from veloslam_tpu_torch.registration.voxel import VoxelGrid
from veloslam_tpu_torch.runtime.odometry import OdometryState


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
    """An OdometryState-shaped tree of numpy arrays (sample-assembly carry)
    → the port's OdometryState on `device`."""
    rest = {f: torch.as_tensor(np.array(getattr(leaves, f)), device=device)
            for f in OdometryState._fields if f not in ("carry", "map_grid")}
    return OdometryState(
        carry=_tree_to_torch(SampleCarry, leaves.carry, device),
        map_grid=_tree_to_torch(VoxelGrid, leaves.map_grid, device), **rest)


def odometry_state_to_numpy(state: OdometryState) -> OdometryState:
    """The port's OdometryState with every leaf as a host numpy array."""
    rest = {f: getattr(state, f).detach().cpu().numpy()
            for f in OdometryState._fields if f not in ("carry", "map_grid")}
    return OdometryState(carry=_tree_to_numpy(state.carry),
                         map_grid=_tree_to_numpy(state.map_grid), **rest)
