"""Sensor models: the built-in calibration tables, a seeded per-unit
calibration and its Velodyne db.xml, and the firing timing.

Frozen copies of the port's `decode/calibration.py` tables and `to_xml`,
of `io/simulate.py::_block_timing`, of the constants they use, and of the
seeded per-unit calibration the port's chip smoke test simulates HDL-64
drives with (the built-in table with normal perturbations of the
rotational and the vertical correction of each laser).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import NamedTuple, Tuple

import numpy as np

PACKET_BYTES = 1206
BLOCKS_PER_PACKET = 12
BLOCK_ID_0_TO_31 = 0xEEFF
BLOCK_ID_32_TO_63 = 0xDDFF
TICKS_PER_REV = 36000
TICKS_PER_DEG = 100.0
DISTANCE_UNIT_M = 0.002
HDL32_BLOCK_US = 46.08
HDL32_LASER_US = 1.152
INS_PERIOD_S = 10 * 1e-3          # 100 Hz, as `INS_PERIOD_MS * 1e-3`


class Calib(NamedTuple):
    """Per-laser angles in degrees (the two terms the generator encodes;
    the distance and offset corrections of a db.xml are written as 0)."""

    rot_deg: np.ndarray
    vert_deg: np.ndarray

    @property
    def n_lasers(self) -> int:
        return len(self.vert_deg)


_HDL32_VERT = np.array([
    -30.67, -9.33, -29.33, -8.00, -28.00, -6.66, -26.66, -5.33,
    -25.33, -4.00, -24.00, -2.67, -22.67, -1.33, -21.33, 0.00,
    -20.00, 1.33, -18.67, 2.67, -17.33, 4.00, -16.00, 5.33,
    -14.67, 6.67, -13.33, 8.00, -12.00, 9.33, -10.67, 10.67,
])


def default_calib(model: str) -> Calib:
    """The built-in table of `model` (hdl32 or hdl64)."""
    if model == "hdl32":
        vert = _HDL32_VERT.astype(np.float64)
    elif model == "hdl64":
        vert = np.concatenate([np.linspace(2.0, -8.33, 32),
                               np.linspace(-8.83, -24.33, 32)])
    else:
        raise ValueError(f"unsupported sensor model {model!r}")
    return Calib(np.zeros(len(vert)), vert)


def unit_calib(model: str, seed: int, rot_sd_deg: float,
               vert_sd_deg: float) -> Calib:
    """A unit's calibration: the built-in table with seeded normal
    perturbations of each laser's rotational and vertical correction."""
    base = default_calib(model)
    rng = np.random.default_rng(int(seed) % (1 << 64))
    n = base.n_lasers
    return Calib(base.rot_deg + rng.normal(0.0, rot_sd_deg, n),
                 base.vert_deg + rng.normal(0.0, vert_sd_deg, n))


def write_db_xml(calib: Calib, path: str) -> None:
    """The calibration as a Velodyne db.xml (`to_xml`'s schema: every
    laser enabled, centimetre fields, values as Python's repr)."""
    root = ET.Element("boost_serialization")
    db = ET.SubElement(root, "DB")
    enabled = ET.SubElement(db, "enabled_")
    for _ in range(calib.n_lasers):
        ET.SubElement(enabled, "item").text = "1"
    points = ET.SubElement(db, "points_")
    for i in range(calib.n_lasers):
        px = ET.SubElement(ET.SubElement(points, "item"), "px")
        ET.SubElement(px, "id_").text = str(i)
        ET.SubElement(px, "rotCorrection_").text = repr(
            float(calib.rot_deg[i]))
        ET.SubElement(px, "vertCorrection_").text = repr(
            float(calib.vert_deg[i]))
        for tag in ("distCorrection_", "vertOffsetCorrection_",
                    "horizOffsetCorrection_"):
            ET.SubElement(px, tag).text = repr(0.0)
    ET.ElementTree(root).write(path)


def block_timing(model: str) -> Tuple[float, np.ndarray, np.ndarray]:
    """(block period µs, per-laser time offset µs, per-laser azimuth
    fraction of a block) of the 32 lasers of a block."""
    dsr = np.arange(32)
    if model == "hdl32":
        return (HDL32_BLOCK_US, dsr * HDL32_LASER_US,
                (dsr * HDL32_LASER_US) / HDL32_BLOCK_US)
    if model == "hdl64":
        return HDL32_BLOCK_US, np.zeros(32), np.zeros(32)
    raise ValueError(f"unsupported sensor model {model!r}")


def packets_per_second(model: str) -> float:
    """The sensor's packet rate: 12 blocks a packet, and the HDL-64's
    firings take two blocks each."""
    rate = 1e6 / HDL32_BLOCK_US / BLOCKS_PER_PACKET
    return 2.0 * rate if model == "hdl64" else rate
