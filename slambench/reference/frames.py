"""The frame schedule of a packet stream, worked out from the packets.

A frame is one sensor revolution: it opens at the stream's first firing
block and again at each block whose azimuth is below the one before it
(the wrap), and it is complete when the next one opens.  A block fires at
its packet's time plus its place in the packet times the firing period
(the HDL-64 fires its 64 lasers as two blocks of one firing).
"""

from __future__ import annotations

import struct

import numpy as np

HDL_BLOCK_US = 46.08


def read_lidar(path: str):
    """(payloads (N, 1206) uint8, record times µs (N,)) of a pcap's
    1206-byte UDP payloads (Ethernet + IPv4 + UDP framing, 42 bytes)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic = struct.unpack_from("<I", buf)[0]
    scale = {0xA1B2C3D4: 1, 0xA1B23C4D: 1000}[magic]
    offs, times = [], []
    off = 24
    while off + 16 <= len(buf):
        sec, frac, incl, _ = struct.unpack_from("<IIII", buf, off)
        data = off + 16
        if data + incl > len(buf):
            break
        if incl == 42 + 1206 and buf[data + 23] == 17:
            offs.append(data + 42)
            times.append(sec * 1_000_000 + frac // scale)
        off = data + incl
    raw = np.frombuffer(buf, np.uint8)
    pkts = raw[np.asarray(offs, np.int64)[:, None] + np.arange(1206)]
    return pkts, np.asarray(times, np.int64)


def open_blocks(pkts: np.ndarray, times_us: np.ndarray, model: str
                ) -> tuple:
    """(index, start time µs float64) of the firing block that opens each
    frame of the stream, the last (still open at the stream's end)
    included; blocks are numbered packet by packet, 12 a packet."""
    blocks = pkts[:, :1200].reshape(len(pkts), 12, 100).astype(np.int64)
    az = ((blocks[..., 2] | (blocks[..., 3] << 8)) % 36000).reshape(-1)
    per_fire = 2 if model == "hdl64" else 1
    k = np.arange(12) // per_fire
    t = (times_us[:, None] + k[None, :] * HDL_BLOCK_US).reshape(-1)
    at = np.concatenate([[0], np.nonzero(az[1:] < az[:-1])[0] + 1])
    return at, t[at].astype(np.float64)


def opens(pkts: np.ndarray, times_us: np.ndarray, model: str
          ) -> np.ndarray:
    """Start times (µs, float64) of every frame the stream opens, the
    last (still open at the stream's end) included."""
    return open_blocks(pkts, times_us, model)[1]


def schedule(pkts: np.ndarray, times_us: np.ndarray, model: str
             ) -> np.ndarray:
    """Start times (µs, float64) of the complete frames of the stream."""
    return opens(pkts, times_us, model)[:-1]
