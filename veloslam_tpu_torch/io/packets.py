"""Host packet encoders and decoders (numpy): HDL data packets, the INS
text log, and position packets with their NMEA $GPRMC sentence.

A jax-free copy of what the simulator, the pcap reader and the pipeline
use from veloslam_tpu/io/packets.py (importing the original imports jax
through the io package's __init__).  tests/test_torch_host.py holds the
copies equal to the originals.

INS text log: whitespace rows "x y yaw roll pitch v tv_sec tv_usec", angles
in radians, the yaw sign flipped on load (the reference's loadFromTxtFile
contract).  Position packets (512 B, port 8308): a little-endian
µs-into-hour counter at byte 198, the PPS status at 202 (0 absent,
1 attempting, 2 locked, 3 error) and a CR/LF-terminated NMEA sentence from
206; they ground the HDL hour clock to GPS UTC.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

from veloslam_tpu_torch import constants as C


def encode_lidar_packets(az_ticks: np.ndarray, dist_raw: np.ndarray,
                         intensity: np.ndarray, gps_us: np.ndarray,
                         block_ids: np.ndarray = None) -> np.ndarray:
    """Build (N, 1206) uint8 packets from per-block arrays.

    Args:
      az_ticks: (N, 12) int — azimuth in 0.01° ticks [0, 36000).
      dist_raw: (N, 12, 32) int — distance in 2 mm units (0 = no return).
      intensity: (N, 12, 32) int — 0..255.
      gps_us: (N,) int — µs-into-hour timestamp.
      block_ids: (N, 12) int or None — defaults to 0xeeff everywhere.
    """
    n = az_ticks.shape[0]
    if block_ids is None:
        block_ids = np.full((n, 12), C.BLOCK_ID_0_TO_31, np.uint32)
    pkts = np.zeros((n, C.HDL_PACKET_BYTES), np.uint8)
    blocks = pkts[:, :1200].reshape(n, 12, 100)
    bid = block_ids.astype(np.uint32)
    az = az_ticks.astype(np.uint32)
    blocks[..., 0] = bid & 0xFF
    blocks[..., 1] = (bid >> 8) & 0xFF
    blocks[..., 2] = az & 0xFF
    blocks[..., 3] = (az >> 8) & 0xFF
    rets = blocks[:, :, 4:].reshape(n, 12, 32, 3)
    d = dist_raw.astype(np.uint32)
    rets[..., 0] = d & 0xFF
    rets[..., 1] = (d >> 8) & 0xFF
    rets[..., 2] = np.clip(intensity, 0, 255).astype(np.uint8)
    g = gps_us.astype(np.uint32)
    for i in range(4):
        pkts[:, 1200 + i] = (g >> (8 * i)) & 0xFF
    return pkts


def idle_lidar_packets(template: np.ndarray, n: int) -> np.ndarray:
    """n packets that decode to nothing: every return blanked and every
    block azimuth pinned to `template`'s last block azimuth, so the
    azimuth neither advances nor wraps (no frame split).  Pads a trailing
    partial batch up to the batch size."""
    f = decode_lidar_packets_np(template[None])
    az = np.full((n, C.HDL_FIRINGS_PER_PACKET), f["az_ticks"][0, -1],
                 np.uint32)
    zeros = np.zeros((n, C.HDL_FIRINGS_PER_PACKET, C.HDL_LASERS_PER_FIRING),
                     np.uint32)
    gps = np.full(n, f["gps_us"][0], np.uint32)
    return encode_lidar_packets(az, zeros, zeros, gps,
                                np.repeat(f["block_id"][:1], n, axis=0))


def decode_lidar_packets_np(pkts: np.ndarray) -> Dict[str, np.ndarray]:
    """Numpy field extraction (the decode oracle)."""
    n = pkts.shape[0]
    blocks = pkts[:, :1200].reshape(n, 12, 100).astype(np.uint32)
    rets = pkts[:, :1200].reshape(n, 12, 100)[:, :, 4:].reshape(
        n, 12, 32, 3).astype(np.uint32)
    return {
        "block_id": blocks[..., 0] | (blocks[..., 1] << 8),
        "az_ticks": (blocks[..., 2] | (blocks[..., 3] << 8)) % 36000,
        "dist_raw": rets[..., 0] | (rets[..., 1] << 8),
        "intensity": rets[..., 2],
        "gps_us": (pkts[:, 1200].astype(np.uint32)
                   | (pkts[:, 1201].astype(np.uint32) << 8)
                   | (pkts[:, 1202].astype(np.uint32) << 16)
                   | (pkts[:, 1203].astype(np.uint32) << 24)),
    }


# --- INS text log ------------------------------------------------------------


def write_ins_txt(path: str, t_us: np.ndarray, pos_xy: np.ndarray,
                  yaw_rad: np.ndarray, roll_rad: np.ndarray = None,
                  pitch_rad: np.ndarray = None,
                  speed: np.ndarray = None) -> None:
    """Write rows "x y yaw roll pitch v sec usec".  The file stores
    counter-clockwise yaw and the loader negates it, so the yaw is negated
    here to make write → read the identity."""
    n = len(t_us)
    z = np.zeros(n)
    roll = z if roll_rad is None else roll_rad
    pitch = z if pitch_rad is None else pitch_rad
    v = z if speed is None else speed
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{pos_xy[i, 0]:.6f} {pos_xy[i, 1]:.6f} "
                    f"{-yaw_rad[i]:.9f} {roll[i]:.9f} {pitch[i]:.9f} "
                    f"{v[i]:.6f} {t_us[i] // 1_000_000} "
                    f"{t_us[i] % 1_000_000}\n")


def read_ins_txt(path: str) -> Dict[str, np.ndarray]:
    """Read the INS text format → dict of arrays: times in int64 µs,
    angles in degrees (rad → deg and the yaw negated)."""
    raw = np.loadtxt(path, ndmin=2)
    if raw.size == 0:
        raw = raw.reshape(0, 8)
    t_us = (raw[:, 6].astype(np.int64) * 1_000_000
            + raw[:, 7].astype(np.int64))
    return {
        "t_us": t_us,
        "pos_xy": raw[:, 0:2],
        "yaw_deg": -np.rad2deg(raw[:, 2]),
        "roll_deg": np.rad2deg(raw[:, 3]),
        "pitch_deg": np.rad2deg(raw[:, 4]),
        "speed": raw[:, 5],
    }


# --- LiDAR position packets (UDP port 8308, 512-byte payload) ----------------

POSITION_TIMESTAMP_OFFSET = 198
POSITION_PPS_OFFSET = 202
POSITION_NMEA_OFFSET = 206
PPS_STATUS = {0: "absent", 1: "attempting", 2: "locked", 3: "error"}


def make_gprmc(utc_us: int, lat_deg: float, lon_deg: float,
               speed_knots: float = 0.0, track_deg: float = 0.0,
               valid: bool = True) -> str:
    """Render a $GPRMC sentence (with checksum) for a Unix-UTC microsecond
    timestamp and WGS-84 position."""
    import datetime as _dt

    t = _dt.datetime.fromtimestamp(utc_us * 1e-6, _dt.timezone.utc)
    hhmmss = t.strftime("%H%M%S") + f".{t.microsecond // 10000:02d}"
    ddmmyy = t.strftime("%d%m%y")

    def dm(x, width):
        d = int(abs(x))
        m = (abs(x) - d) * 60.0
        return f"{d:0{width}d}{m:07.4f}"

    body = (f"GPRMC,{hhmmss},{'A' if valid else 'V'},"
            f"{dm(lat_deg, 2)},{'N' if lat_deg >= 0 else 'S'},"
            f"{dm(lon_deg, 3)},{'E' if lon_deg >= 0 else 'W'},"
            f"{speed_knots:05.1f},{track_deg:05.1f},{ddmmyy},,,A")
    cs = 0
    for ch in body:
        cs ^= ord(ch)
    return f"${body}*{cs:02X}"


def parse_gprmc(sentence: str) -> Dict[str, object]:
    """Parse a $GPRMC sentence → {utc_us, valid, lat_deg, lon_deg,
    speed_knots, track_deg}.  Raises ValueError on malformed input."""
    import datetime as _dt

    s = sentence.strip()
    if not s.startswith("$"):
        raise ValueError("not an NMEA sentence")
    if "*" in s:
        body, cs = s[1:].rsplit("*", 1)
        calc = 0
        for ch in body:
            calc ^= ord(ch)
        if int(cs, 16) != calc:
            raise ValueError("NMEA checksum mismatch")
    else:
        body = s[1:]
    f = body.split(",")
    if f[0] not in ("GPRMC", "GNRMC"):
        raise ValueError(f"not an RMC sentence: {f[0]}")
    hh, mm = int(f[1][0:2]), int(f[1][2:4])
    ss = float(f[1][4:])
    dd, mo, yy = int(f[9][0:2]), int(f[9][2:4]), 2000 + int(f[9][4:6])
    t = _dt.datetime(yy, mo, dd, hh, mm, int(ss), tzinfo=_dt.timezone.utc)
    utc_us = int(t.timestamp() * 1e6 + (ss - int(ss)) * 1e6)

    def deg(x, hemi, dlen):
        if not x:
            return float("nan")
        v = float(x[:dlen]) + float(x[dlen:]) / 60.0
        return -v if hemi in ("S", "W") else v

    return {
        "utc_us": utc_us, "valid": f[2] == "A",
        "lat_deg": deg(f[3], f[4], 2), "lon_deg": deg(f[5], f[6], 3),
        "speed_knots": float(f[7]) if f[7] else 0.0,
        "track_deg": float(f[8]) if f[8] else 0.0,
    }


def pack_position_packet(us_into_hour: int, utc_us: int,
                         lat_deg: float = 0.0, lon_deg: float = 0.0,
                         pps_status: int = 2) -> bytes:
    """Build a 512-byte position packet payload."""
    buf = bytearray(C.POSITION_PACKET_BYTES)
    struct.pack_into("<I", buf, POSITION_TIMESTAMP_OFFSET,
                     int(us_into_hour) & 0xFFFFFFFF)
    buf[POSITION_PPS_OFFSET] = pps_status & 0xFF
    nmea = (make_gprmc(utc_us, lat_deg, lon_deg) + "\r\n").encode("ascii")
    buf[POSITION_NMEA_OFFSET:POSITION_NMEA_OFFSET + len(nmea)] = nmea
    return bytes(buf)


def unpack_position_packet(data: bytes) -> Dict[str, object]:
    """Decode a 512-byte position packet → {us_into_hour, pps_status,
    pps_status_str, nmea, rmc (parsed dict or None)}."""
    if len(data) < POSITION_NMEA_OFFSET:
        raise ValueError(f"position packet too short: {len(data)}")
    us = struct.unpack_from("<I", data, POSITION_TIMESTAMP_OFFSET)[0]
    pps = data[POSITION_PPS_OFFSET]
    tail = data[POSITION_NMEA_OFFSET:]
    nmea = ""
    start = tail.find(b"$")
    if start >= 0:
        end = tail.find(b"\r", start)
        nmea = tail[start:end if end > 0 else None].decode(
            "ascii", errors="replace")
    rmc = None
    if nmea:
        try:
            rmc = parse_gprmc(nmea)
        except ValueError:
            rmc = None
    return {"us_into_hour": int(us), "pps_status": int(pps),
            "pps_status_str": PPS_STATUS.get(int(pps), "unknown"),
            "nmea": nmea, "rmc": rmc}
