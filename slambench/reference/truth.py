"""The vehicle's true path: the drive recipe's circle, evaluated in
float64 at any time.  The program's frame
is the INS frame, whose origin and axes are the world's (the INS log is
the truth plus a drift that starts at 0); the log carries no height, so
heights are compared only as differences."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def poses(path, t0_us: int, times_us: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions (n, 3), yaw (n,)) of the truth at `times_us`; `path`
    is the drive's `gen.scene.Circle`, `t0_us` its time zero."""
    t = torch.as_tensor((np.asarray(times_us, np.float64) - t0_us) * 1e-6,
                        dtype=torch.float64)
    pos, yaw, _ = path(t)
    return pos.numpy(), yaw.numpy()


def rot_z(yaw: np.ndarray) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    z, o = np.zeros_like(yaw), np.ones_like(yaw)
    return np.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(
        *yaw.shape, 3, 3)

