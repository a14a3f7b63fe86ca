"""Clock fusion between LiDAR, INS and wall-clock time bases (host).

A jax-free copy of veloslam_tpu/core/timesync.py (importing the original
runs the JAX package's __init__); tests/test_torch_host.py and
tests/test_torch_live.py hold it equal.

  * INS messages carry (GPS week, milliseconds into the week) plus a finer
    position time (week_pos, seconds_pos); the fine time, when present,
    replaces the coarse one.  Absolute time is GPS time as Unix µs.
  * HDL data packets carry only microseconds into the current hour;
    resolving them to absolute time needs an hour base plus wrap detection
    when the counter resets.  Live, `HdlClock` latches the base from a
    reference time (GPS grounding, the first INS datagram or the wall
    clock); offline, `resolve_hour_stamps` resolves a whole recording
    against a grounded base.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# GPS epoch (1980-01-06 00:00:00 UTC) in Unix microseconds.
GPS_EPOCH_UNIX_US = 315_964_800_000_000
WEEK_US = 7 * 24 * 3600 * 1_000_000
HOUR_US = 3600 * 1_000_000


def ins_timestamp_us(week_number: int, milliseconds: int,
                     week_number_pos: Optional[int] = None,
                     seconds_pos: Optional[float] = None) -> int:
    """INSPVA (week, ms[, fine pos time]) -> Unix microseconds.  When the
    fine position time is present it replaces the coarse one."""
    coarse = GPS_EPOCH_UNIX_US + week_number * WEEK_US + int(milliseconds) * 1000
    if week_number_pos is None or seconds_pos is None or seconds_pos < 0:
        return coarse
    fine = (GPS_EPOCH_UNIX_US + int(week_number_pos) * WEEK_US
            + int(round(float(seconds_pos) * 1e6)))
    return fine


class HdlClock:
    """Resolve HDL µs-into-hour stamps to absolute Unix microseconds.

    The hour base is taken from the first reference time provided (the
    wall clock or the first INS time live), or pinned to GPS truth by a
    position packet (`ground`), then advanced on counter wrap."""

    def __init__(self):
        self._hour_base_us: Optional[int] = None
        self._last_report: int = 0

    def resolve(self, us_into_hour: int, ref_time_us: Optional[int] = None) -> int:
        us_into_hour = int(us_into_hour)
        if self._hour_base_us is None:
            if ref_time_us is None:
                raise ValueError("first HDL stamp needs a reference time "
                                 "to establish the hour base")
            self._hour_base_us = ref_time_us - us_into_hour
        elif us_into_hour < self._last_report:
            self._hour_base_us += HOUR_US          # counter wrapped: new hour
        self._last_report = us_into_hour
        return self._hour_base_us + us_into_hour

    @property
    def grounded(self) -> bool:
        return self._hour_base_us is not None

    def resolve_batch(self, us_array, ref_time_us: Optional[int] = None):
        """Vectorized `resolve` over an ordered stamp array (int64);
        counter wraps within the array advance the hour base
        cumulatively."""
        us = np.asarray(us_array, np.int64)
        if len(us) == 0:
            return np.empty(0, np.int64)
        if self._hour_base_us is None:
            if ref_time_us is None:
                raise ValueError("first HDL stamp needs a reference time "
                                 "to establish the hour base")
            self._hour_base_us = int(ref_time_us) - int(us[0])
            self._last_report = int(us[0])
        prev = np.concatenate([[self._last_report], us[:-1]])
        wraps = np.cumsum(us < prev)
        out = self._hour_base_us + us + wraps * HOUR_US
        self._hour_base_us += int(wraps[-1]) * HOUR_US
        self._last_report = int(us[-1])
        return out

    def maybe_ground(self, us_into_hour: int, utc_us: int,
                     tolerance_us: int = 50_000) -> bool:
        """Ground the first time, or when the implied hour base drifted
        beyond `tolerance_us` from the current one (NMEA RMC time is
        quantized to ~10 ms, so re-grounding on every position packet
        would jitter resolved stamps).  Returns True if grounded."""
        new_base = int(utc_us) - int(us_into_hour)
        if self._hour_base_us is not None and \
                abs(new_base - self._hour_base_us) <= tolerance_us:
            return False
        self.ground(us_into_hour, utc_us)
        return True

    def ground(self, us_into_hour: int, utc_us: int) -> int:
        """Pin the hour base to GPS truth (a position packet's counter
        paired with its NMEA UTC fix).  Returns the correction applied in
        µs (0 on first grounding)."""
        us_into_hour = int(us_into_hour)
        new_base = int(utc_us) - us_into_hour
        old = self._hour_base_us
        self._hour_base_us = new_base
        self._last_report = us_into_hour
        return 0 if old is None else new_base - old


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
