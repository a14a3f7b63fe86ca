"""A drive as a user's files: the pcap (LiDAR packets with a position
packet every second) and the INS text log.

Frozen copies of the port's `io/pcap.py::PcapWriter` framing,
`io/simulate.py::write_sequence`'s position-packet schedule,
`io/packets.py`'s position packet, $GPRMC sentence and INS text rows,
and the WGS-84 conversions of `core/geodesy.py` they need.
The pcap is written in one pass from one byte array.
"""

from __future__ import annotations

import datetime as _dt
import struct
from typing import Dict, List, Tuple

import numpy as np

from slambench.gen.drive import Drive

SIM_ORIGIN_LLH = (31.0, 121.0, 10.0)   # WGS-84 origin of the pcap's fixes
LIDAR_PORT, POSITION_PORT = 2368, 8308
_WGS84_A = 6378137.0
_WGS84_B = 6356752.3142
_E2 = 1.0 - (_WGS84_B / _WGS84_A) ** 2
_EP2 = (_WGS84_A / _WGS84_B) ** 2 - 1.0


# --- geodesy (float64 numpy) -------------------------------------------------

def llh2xyz(llh: np.ndarray) -> np.ndarray:
    lat, lon, h = llh[..., 0], llh[..., 1], llh[..., 2]
    sl, cl = np.sin(lat), np.cos(lat)
    n = _WGS84_A / np.sqrt(1.0 - _E2 * sl * sl)
    return np.stack([(n + h) * cl * np.cos(lon), (n + h) * cl * np.sin(lon),
                     (n * (1.0 - _E2) + h) * sl], -1)


def xyz2llh(xyz: np.ndarray) -> np.ndarray:
    """Heikkinen's closed-form ECEF → geodetic."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    a, b, e2, ep2 = _WGS84_A, _WGS84_B, _E2, _EP2
    r2 = x * x + y * y
    r = np.sqrt(r2)
    z2 = z * z
    F = 54.0 * b * b * z2
    G = r2 + (1.0 - e2) * z2 - e2 * (a * a - b * b)
    c = e2 * e2 * F * r2 / (G * G * G)
    s = (1.0 + c + np.sqrt(c * c + 2.0 * c)) ** (1.0 / 3.0)
    P = F / (3.0 * (s + 1.0 / s + 1.0) ** 2 * G * G)
    Q = np.sqrt(1.0 + 2.0 * e2 * e2 * P)
    r0 = -(P * e2 * r) / (1.0 + Q) + np.sqrt(
        np.maximum(0.5 * a * a * (1.0 + 1.0 / Q)
                   - P * (1.0 - e2) * z2 / (Q * (1.0 + Q))
                   - 0.5 * P * r2, 0.0))
    t = (r - e2 * r0) ** 2
    U = np.sqrt(t + z2)
    V = np.sqrt(t + (1.0 - e2) * z2)
    z0 = b * b * z / (a * V)
    h = U * (1.0 - b * b / (a * V))
    return np.stack([np.arctan2(z + ep2 * z0, r), np.arctan2(y, x), h], -1)


def enu2llh(enu: np.ndarray, origin_llh_deg) -> np.ndarray:
    """ENU metres around the origin (degrees, degrees, m) → LLH radians."""
    org = np.array([np.deg2rad(origin_llh_deg[0]),
                    np.deg2rad(origin_llh_deg[1]), origin_llh_deg[2]])
    org_xyz = llh2xyz(org)
    lat, lon = xyz2llh(org_xyz)[:2]
    sl, cl, so, co = np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon)
    R = np.array([[-so, co, 0.0], [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return xyz2llh(org_xyz + np.einsum("ji,...j->...i", R, enu))


# --- position packets --------------------------------------------------------

def gprmc(utc_us: int, lat_deg: float, lon_deg: float) -> str:
    t = _dt.datetime.fromtimestamp(utc_us * 1e-6, _dt.timezone.utc)
    hhmmss = t.strftime("%H%M%S") + f".{t.microsecond // 10000:02d}"

    def dm(x, width):
        d = int(abs(x))
        return f"{d:0{width}d}{(abs(x) - d) * 60.0:07.4f}"

    body = (f"GPRMC,{hhmmss},A,{dm(lat_deg, 2)},"
            f"{'N' if lat_deg >= 0 else 'S'},{dm(lon_deg, 3)},"
            f"{'E' if lon_deg >= 0 else 'W'},000.0,000.0,"
            f"{t.strftime('%d%m%y')},,,A")
    cs = 0
    for ch in body:
        cs ^= ord(ch)
    return f"${body}*{cs:02X}"


def position_packet(us_into_hour: int, utc_us: int, lat_deg: float,
                    lon_deg: float) -> bytes:
    buf = bytearray(512)
    struct.pack_into("<I", buf, 198, int(us_into_hour) & 0xFFFFFFFF)
    buf[202] = 2                                   # PPS locked
    nmea = (gprmc(utc_us, lat_deg, lon_deg) + "\r\n").encode("ascii")
    buf[206:206 + len(nmea)] = nmea
    return bytes(buf)


# --- pcap ------------------------------------------------------------------

def _udp_header(payload_len: int, dport: int) -> bytes:
    eth = b"\xff" * 6 + b"\x60\x76\x88\x00\x00\x00" + b"\x08\x00"
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 28 + payload_len, 0x04D2,
                     0x4000, 0xFF, 17, 0, bytes([192, 168, 1, 201]),
                     bytes([255] * 4))
    return eth + ip + struct.pack(">HHHH", dport, dport, 8 + payload_len, 0)


def _records(payloads: np.ndarray, times_us: np.ndarray,
             dport: int) -> np.ndarray:
    """(n, 16 + 42 + size) uint8 pcap records of equal-size payloads."""
    n, size = payloads.shape
    rec = np.empty((n, 16 + 42 + size), np.uint8)
    hdr = np.empty((n, 4), "<u4")
    hdr[:, 0] = times_us // 1_000_000
    hdr[:, 1] = times_us % 1_000_000
    hdr[:, 2] = hdr[:, 3] = 42 + size
    rec[:, :16] = hdr.view(np.uint8).reshape(n, 16)
    rec[:, 16:58] = np.frombuffer(_udp_header(size, dport), np.uint8)
    rec[:, 58:] = payloads
    return rec


def position_schedule(times_us: np.ndarray, period_s: float = 1.0
                      ) -> np.ndarray:
    """Indices of the LiDAR packets a position packet precedes:
    `write_sequence`'s rule, the first packet and then the first packet
    at least `period_s` after the last position packet."""
    out: List[int] = []
    i = 0
    while i < len(times_us):
        out.append(i)
        nxt = times_us[i] * 1e-6 + period_s
        i = int(np.searchsorted(times_us * 1e-6, nxt, side="left"))
    return np.asarray(out, np.int64)


def write_pcap(drive: Drive, path: str, enu_pos: np.ndarray) -> None:
    """The drive's pcap: its LiDAR packets, each second a position packet
    with the vehicle's fix (`enu_pos`, the true positions (M, 3) at the
    INS times, around the SIM_ORIGIN_LLH origin) before the packet of its
    time."""
    t = drive.pkt_times_us
    at = position_schedule(t)
    ins_i = np.clip(np.searchsorted(drive.ins_t_us, t[at], side="right") - 1,
                    0, len(drive.ins_t_us) - 1)
    llh = enu2llh(np.asarray(enu_pos[ins_i], np.float64), SIM_ORIGIN_LLH)
    pos = np.stack([np.frombuffer(position_packet(
        int(t[i]) % 3_600_000_000, int(t[i]), float(np.rad2deg(la)),
        float(np.rad2deg(lo))), np.uint8) for i, (la, lo, _) in
        zip(at, llh)])
    lidar = _records(drive.packets, t, LIDAR_PORT)
    posr = _records(pos, t[at], POSITION_PORT)
    glob = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    bounds = list(at) + [len(t)]
    with open(path, "wb") as f:
        f.write(glob)
        for k in range(len(at)):
            f.write(posr[k].tobytes())
            f.write(lidar[bounds[k]:bounds[k + 1]].tobytes())


# --- INS -------------------------------------------------------------------

def ins_log(drive: Drive, drift_m_per_s: float) -> Dict[str, np.ndarray]:
    """The INS the vehicle reports: the truth with its y position drifting
    `drift_m_per_s` (bench.py's drive)."""
    ts = (drive.ins_t_us - drive.ins_t_us[0]) * 1e-6
    xy = drive.ins_pos[:, :2] + np.stack([np.zeros_like(ts),
                                          drift_m_per_s * ts], -1)
    return {"t_us": drive.ins_t_us, "xy": xy, "yaw": drive.ins_yaw,
            "speed": np.linalg.norm(drive.ins_vel, axis=-1)}


def write_ins_txt(ins: Dict[str, np.ndarray], path: str) -> None:
    """Rows "x y yaw roll pitch v sec usec" (`write_ins_txt`: the yaw
    stored negated, rounded as the log's text rounds it)."""
    t, xy = ins["t_us"], ins["xy"]
    with open(path, "w") as f:
        f.write("".join(
            f"{xy[i, 0]:.6f} {xy[i, 1]:.6f} {-ins['yaw'][i]:.9f} "
            f"{0.0:.9f} {0.0:.9f} {ins['speed'][i]:.6f} "
            f"{t[i] // 1_000_000} {t[i] % 1_000_000}\n"
            for i in range(len(t))))


def write_drive(drive: Drive, out_dir: str, drift_m_per_s: float
                ) -> Tuple[Dict[str, str], Dict[str, np.ndarray]]:
    """Write `<out_dir>/drive.pcap` and `drive_ins.txt`; returns the paths
    and the INS log."""
    import os
    ins = ins_log(drive, drift_m_per_s)
    paths = {"pcap": os.path.join(out_dir, "drive.pcap"),
             "ins": os.path.join(out_dir, "drive_ins.txt")}
    write_pcap(drive, paths["pcap"], drive.ins_pos)
    write_ins_txt(ins, paths["ins"])
    return paths, ins
