"""Laser calibration tables (host, numpy): built-in profiles and the
Velodyne XML loader.

A jax-free copy of the built-in profiles and `from_xml` of
veloslam_tpu/decode/calibration.py (importing that module imports jax
through the decode package's __init__).  tests/test_torch_host.py holds
the copy equal to the original.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
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


def from_xml(path: str) -> LaserCalib:
    """Load a Velodyne XML calibration file: per laser item `px` the
    fields id_, rotCorrection_, vertCorrection_, distCorrection_,
    vertOffsetCorrection_ and horizOffsetCorrection_, centimetre fields
    converted to metres; the laser count is the number of enabled_ items
    equal to 1 (else the highest id + 1)."""
    root = ET.parse(path).getroot()
    db = root.find("DB")
    if db is None:
        raise ValueError(f"{path}: no <DB> element")
    enabled = db.find("enabled_")
    n_lasers = 0
    if enabled is not None:
        n_lasers = sum(1 for it in enabled.findall("item")
                       if it.text and it.text.strip() == "1")
    fields = {k: np.zeros(64) for k in
              ("rot", "vert", "dist", "voff", "hoff")}
    max_id = -1
    points = db.find("points_")
    if points is None:
        raise ValueError(f"{path}: no <points_> element")
    for item in points.findall("item"):
        px = item.find("px")
        if px is None:
            continue

        def get(tag, default=0.0):
            el = px.find(tag)
            return float(el.text) if el is not None and el.text else default

        idx = int(get("id_", -1))
        if idx < 0:
            continue
        max_id = max(max_id, idx)
        fields["rot"][idx] = get("rotCorrection_")
        fields["vert"][idx] = get("vertCorrection_")
        fields["dist"][idx] = get("distCorrection_") / 100.0
        fields["voff"][idx] = get("vertOffsetCorrection_") / 100.0
        fields["hoff"][idx] = get("horizOffsetCorrection_") / 100.0
    n = n_lasers if n_lasers > 0 else max_id + 1
    return LaserCalib(fields["rot"][:n], fields["vert"][:n],
                      fields["dist"][:n], fields["voff"][:n],
                      fields["hoff"][:n])
