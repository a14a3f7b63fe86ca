"""Offline resolution of HDL µs-into-hour stamps to absolute time.

A copy of veloslam_tpu/core/timesync.py::resolve_hour_stamps (importing
the original runs the JAX package's __init__).  HDL data packets carry
only microseconds into the current hour; against a GPS-grounded hour
base they resolve to absolute Unix microseconds, with counter wraps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

HOUR_US = 3600 * 1_000_000


def resolve_hour_stamps(gps_us, hour_base_us: int,
                        ref_us: Optional[int] = None):
    """Offline bulk resolution: ordered µs-into-hour stamps → absolute µs
    against a grounded hour base, handling counter wraps within the array.

    `ref_us` (e.g. the first pcap record capture time) disambiguates which
    hour the FIRST stamp belongs to when the grounding packet arrived in a
    later hour than the start of the recording."""
    us = np.asarray(gps_us, np.int64)
    if len(us) == 0:
        return np.empty(0, np.int64)
    wraps = np.concatenate([[0], np.cumsum(us[1:] < us[:-1])])
    out = int(hour_base_us) + us + wraps * HOUR_US
    if ref_us is not None:
        k = int(round((int(ref_us) - int(out[0])) / HOUR_US))
        out = out + k * HOUR_US
    return out
