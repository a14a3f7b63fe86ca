"""pcap file read/write without libpcap (host, numpy).

A jax-free copy of veloslam_tpu/io/pcap.py's writer and bulk readers
(importing the original runs the JAX package's __init__): a 24-byte
global header plus 16-byte record headers; only UDP payloads are read,
with the 42-byte Ethernet/IPv4/UDP framing stripped; the writer
synthesizes that framing for 1206-byte LiDAR packets (port 2368) and
512-byte position packets (port 8308).  The readers index the whole file
in one pass over the record headers and cut the payloads out with one
numpy gather, where the original walks the records with file reads (or
its native pump); tests/test_torch_host.py holds the results equal.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from veloslam_tpu_torch import constants as C

PCAP_MAGIC_US = 0xA1B2C3D4
PCAP_MAGIC_NS = 0xA1B23C4D
GLOBAL_HEADER = struct.Struct("<IHHiIII")
RECORD_HEADER = struct.Struct("<IIII")
LINKTYPE_ETHERNET = 1

ETH_IP_UDP_HEADER_LEN = 42


def _udp_header(payload_len: int, dport: int) -> bytes:
    """Synthesize a 42-byte Ethernet+IPv4+UDP header."""
    eth = (b"\xff\xff\xff\xff\xff\xff"      # dst mac (broadcast)
           b"\x60\x76\x88\x00\x00\x00"      # src mac
           b"\x08\x00")                     # ethertype IPv4
    total_len = 20 + 8 + payload_len
    ip = struct.pack(">BBHHHBBH4s4s",
                     0x45, 0, total_len, 0x04D2, 0x4000, 0xFF, 17, 0,
                     bytes([192, 168, 1, 201]), bytes([255, 255, 255, 255]))
    # Header checksum left zero (the readers do not validate it).
    udp = struct.pack(">HHHH", dport, dport, 8 + payload_len, 0)
    return eth + ip + udp


class PcapWriter:
    """Write UDP payloads into a pcap file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(GLOBAL_HEADER.pack(PCAP_MAGIC_US, 2, 4, 0, 0, 65535,
                                         LINKTYPE_ETHERNET))

    def write(self, payload: bytes, t_us: int,
              dport: Optional[int] = None) -> None:
        if dport is None:
            dport = (C.LIDAR_DATA_PORT if len(payload) == C.HDL_PACKET_BYTES
                     else C.LIDAR_POSITION_PORT)
        pkt = _udp_header(len(payload), dport) + payload
        self._f.write(RECORD_HEADER.pack(t_us // 1_000_000, t_us % 1_000_000,
                                         len(pkt), len(pkt)))
        self._f.write(pkt)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _udp_records(path: str):
    """The file's bytes and, per UDP record, (payload start, payload
    length, time µs, record byte offset) as int64 arrays.  A truncated
    last record ends the scan, as in the original reader."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < GLOBAL_HEADER.size:
        raise ValueError(f"{path}: truncated pcap global header")
    magic = struct.unpack_from("<I", buf)[0]
    if magic == PCAP_MAGIC_US:
        t_scale = 1
    elif magic == PCAP_MAGIC_NS:
        t_scale = 1000
    else:
        raise ValueError(f"{path}: bad pcap magic {magic:#x}")
    rows = []
    off = GLOBAL_HEADER.size
    end = len(buf)
    while off + RECORD_HEADER.size <= end:
        sec, frac, incl, _ = RECORD_HEADER.unpack_from(buf, off)
        data = off + RECORD_HEADER.size
        if data + incl > end:
            break
        # Non-UDP records (IPv4 protocol byte at 23 ≠ 17) are skipped.
        if incl > ETH_IP_UDP_HEADER_LEN and buf[data + 23] == 0x11:
            rows.append((data + ETH_IP_UDP_HEADER_LEN,
                         incl - ETH_IP_UDP_HEADER_LEN,
                         sec * 1_000_000 + frac // t_scale, off))
        off = data + incl
    recs = np.asarray(rows, np.int64).reshape(-1, 4)
    return np.frombuffer(buf, np.uint8), recs


def _payloads(buf: np.ndarray, recs: np.ndarray, size: int,
              max_packets: Optional[int]):
    sel = recs[recs[:, 1] == size][:max_packets]
    pkts = buf[sel[:, 0, None] + np.arange(size)]
    return pkts, sel[:, 2].copy(), sel[:, 3].copy()


def read_lidar_packets(path: str, max_packets: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bulk-load all 1206-byte LiDAR payloads from a pcap.

    Returns (packets (N, 1206) uint8, times_us (N,) int64, offsets (N,)
    int64 — record byte offsets for random re-reads)."""
    buf, recs = _udp_records(path)
    return _payloads(buf, recs, C.HDL_PACKET_BYTES, max_packets)


def read_position_packets(path: str, max_packets: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk-load all 512-byte position-packet payloads from a pcap.

    Returns (packets (N, 512) uint8, times_us (N,) int64)."""
    buf, recs = _udp_records(path)
    pkts, times, _ = _payloads(buf, recs, C.POSITION_PACKET_BYTES,
                               max_packets)
    return pkts, times
