"""Laser calibration tables (host, numpy).

A jax-free copy of the built-in profiles of
veloslam_tpu/decode/calibration.py (importing that module imports jax
through the decode package's __init__).  tests/test_torch_host.py holds
the copy equal to the original.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LaserCalib(NamedTuple):
    """Struct-of-arrays per-laser calibration, shape (n_lasers,) each."""

    rot_correction_deg: np.ndarray     # azimuth correction (deg)
    vert_correction_deg: np.ndarray    # vertical angle (deg)
    dist_correction_m: np.ndarray      # distance correction (m)
    vert_offset_m: np.ndarray          # vertical offset (m)
    horiz_offset_m: np.ndarray         # horizontal offset (m)

    @property
    def n_lasers(self) -> int:
        return self.rot_correction_deg.shape[0]

    @property
    def sin_vert(self) -> np.ndarray:
        return np.sin(np.deg2rad(self.vert_correction_deg))

    @property
    def cos_vert(self) -> np.ndarray:
        return np.cos(np.deg2rad(self.vert_correction_deg))

    def beam_order(self) -> np.ndarray:
        """Indices sorting lasers by ascending vertical angle."""
        return np.argsort(self.vert_correction_deg, kind="stable")


# HDL-32E: 32 beams, -30.67° .. +10.67°, interleaved low/high firing order.
_HDL32_VERT = np.array([
    -30.67, -9.33, -29.33, -8.00, -28.00, -6.66, -26.66, -5.33,
    -25.33, -4.00, -24.00, -2.67, -22.67, -1.33, -21.33, 0.00,
    -20.00, 1.33, -18.67, 2.67, -17.33, 4.00, -16.00, 5.33,
    -14.67, 6.67, -13.33, 8.00, -12.00, 9.33, -10.67, 10.67,
])

# VLP-16: 16 beams, ±15°, interleaved.
_VLP16_VERT = np.array([
    -15.0, 1.0, -13.0, 3.0, -11.0, 5.0, -9.0, 7.0,
    -7.0, 9.0, -5.0, 11.0, -3.0, 13.0, -1.0, 15.0,
])


def _flat(n: int, vert: np.ndarray) -> LaserCalib:
    z = np.zeros(n)
    return LaserCalib(z.copy(), vert.astype(np.float64), z.copy(), z.copy(),
                      z.copy())


def hdl32() -> LaserCalib:
    return _flat(32, _HDL32_VERT)


def vlp16() -> LaserCalib:
    return _flat(16, _VLP16_VERT)


def hdl64() -> LaserCalib:
    """Synthetic HDL-64 profile: upper block +2°..-8.33° (lasers 0-31),
    lower block -8.83°..-24.33° (lasers 32-63), evenly spaced."""
    upper = np.linspace(2.0, -8.33, 32)
    lower = np.linspace(-8.83, -24.33, 32)
    return _flat(64, np.concatenate([upper, lower]))


def default_for(model: str) -> LaserCalib:
    return {"hdl32": hdl32, "vlp16": vlp16, "hdl64": hdl64}[model]()
