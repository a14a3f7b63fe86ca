"""INS message handling: InsPVA wire messages → pose-track entries.

Port of veloslam_tpu/io/ins.py (host float64 numpy): LLH (degrees) →
local ENU against a configured origin, Euler angles and velocity copied
through, the timestamp fused from GPS week/ms and the fine position time
(core.timesync).  The ENU origin is a parameter, or the first message's
position.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from veloslam_tpu_torch.core import geodesy, se3, timesync


class InsConverter:
    """Stateful converter from InsPVA dict messages to pose samples."""

    def __init__(self, origin_llh_deg: Optional[Tuple[float, float, float]]
                 = None):
        """origin_llh_deg: ENU origin; if None, the first message's LLH
        becomes the origin."""
        self._origin_xyz: Optional[np.ndarray] = None
        if origin_llh_deg is not None:
            llh = np.array([np.deg2rad(origin_llh_deg[0]),
                            np.deg2rad(origin_llh_deg[1]),
                            origin_llh_deg[2]])
            self._origin_xyz = geodesy.llh2xyz_np(llh)

    def convert(self, msg: Dict) -> Tuple[int, np.ndarray, np.ndarray,
                                          np.ndarray]:
        """InsPVA dict (io.packets.unpack_inspva) → (t_us, q, t, v)."""
        llh = np.array([np.deg2rad(msg["llh_deg"][0]),
                        np.deg2rad(msg["llh_deg"][1]), msg["llh_deg"][2]])
        if self._origin_xyz is None:
            self._origin_xyz = geodesy.llh2xyz_np(llh)
        enu = geodesy.llh2enu_np(llh, self._origin_xyz)
        e = msg["eulr_deg"]
        q = se3.euler_deg_to_quat_np(e[0], e[1], e[2])
        t_us = timesync.ins_timestamp_us(
            msg["week_number"], msg["milliseconds"],
            msg["week_number_pos"], msg["seconds_pos"])
        v = np.asarray(msg["vel"], np.float64)
        return t_us, q, enu, v
