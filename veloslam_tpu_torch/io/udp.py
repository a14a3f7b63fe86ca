"""UDP ingest and replay: the live sensor plane (host).

Port of veloslam_tpu/io/udp.py:
  * `UdpReceiver`: receive into a bounded ring on a background thread,
    the C++ packet pump's (io.native) unless the caller asks for the
    pure-Python thread (`force_python=True`); exact-size (sensor data
    packets) or variable-size (the INS port's mixed message types);
  * `replay_packets`: paced UDP replay of a packet array (200 µs a
    packet on average by default, on an absolute clock: `paced`);
  * `send_struct`: one small struct to a port (INS simulation).

A failed build of the packet pump raises (io.native.load), and so does a
port the native receiver cannot bind: neither falls back to Python.
"""

from __future__ import annotations

import ctypes
import math
import socket
import threading
import time
from collections import deque
from typing import Tuple

import numpy as np

from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.io import native

DEFAULT_PACE_US = 200


def as_u8p(a: np.ndarray):
    """A C-contiguous uint8 array's data as the packet pump's pointer."""
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _llp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


class UdpReceiver:
    """Receive UDP payloads into a bounded ring buffer.

    Default (exact) mode accepts only datagrams of exactly `payload_size`
    bytes.  With `variable=True` any datagram up to `payload_size` is
    accepted and `poll_var` reports per-datagram lengths (the INS port
    multiplexes InsPVA, RawINS and BestGPSPos).  When the ring is full the
    oldest datagram is dropped and counted (`dropped`)."""

    def __init__(self, port: int, payload_size: int, capacity: int = 16384,
                 force_python: bool = False, variable: bool = False):
        self.port = port
        self.payload_size = payload_size
        self.capacity = capacity
        self.variable = variable
        self._native = None if force_python else native.load()
        self._handle = None
        self._py_dropped = 0
        if self._native is not None:
            opener = (self._native.pp_udp_open_any if variable
                      else self._native.pp_udp_open)
            self._handle = opener(port, payload_size, capacity)
            if not self._handle:
                raise OSError(f"the packet pump could not bind UDP port "
                              f"{port}")
            return
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Burst tolerance as the native receiver's (8 MB receive buffer):
        # replays arrive in bursts while the consumer runs device work.
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  8 * 1024 * 1024)
        except OSError:
            pass
        self._sock.settimeout(0.1)
        self._sock.bind(("0.0.0.0", port))
        self._queue: deque = deque(maxlen=capacity)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

    def _rx_loop(self):
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            ok = (len(data) <= self.payload_size if self.variable
                  else len(data) == self.payload_size)
            if ok and data:
                if len(self._queue) >= self.capacity:
                    self._py_dropped += 1     # deque(maxlen) evicts oldest
                self._queue.append((data, int(time.time() * 1e6)))

    @property
    def dropped(self) -> int:
        """Datagrams lost to ring overflow since open."""
        if self._native is not None:
            return int(self._native.pp_udp_dropped(self._handle))
        return self._py_dropped

    def _drain(self, max_packets: int) -> list:
        items = []
        while self._queue and len(items) < max_packets:
            items.append(self._queue.popleft())
        return items

    def poll(self, max_packets: int = 4096
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Drain up to max_packets; returns ((n, payload) uint8, times µs)."""
        if self._native is not None:
            out = np.empty((max_packets, self.payload_size), np.uint8)
            times = np.empty(max_packets, np.int64)
            n = self._native.pp_udp_poll(self._handle, as_u8p(out),
                                         _llp(times), max_packets)
            return out[:n], times[:n]
        items = self._drain(max_packets)
        if not items:
            return (np.empty((0, self.payload_size), np.uint8),
                    np.empty(0, np.int64))
        pkts = np.frombuffer(b"".join(d for d, _ in items),
                             np.uint8).reshape(len(items), self.payload_size)
        return pkts, np.asarray([t for _, t in items], np.int64)

    def poll_var(self, max_packets: int = 4096
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Drain up to max_packets from a variable-size receiver; returns
        ((n, payload_size) zero-padded uint8, (n,) int lengths, times µs)."""
        if self._native is not None:
            out = np.empty((max_packets, self.payload_size), np.uint8)
            times = np.empty(max_packets, np.int64)
            lens = np.empty(max_packets, np.int32)
            n = self._native.pp_udp_poll_lens(
                self._handle, as_u8p(out), _llp(times),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                max_packets)
            return out[:n], lens[:n], times[:n]
        items = self._drain(max_packets)
        pkts = np.zeros((len(items), self.payload_size), np.uint8)
        lens = np.empty(len(items), np.int32)
        for i, (d, _) in enumerate(items):
            pkts[i, :len(d)] = np.frombuffer(d, np.uint8)
            lens[i] = len(d)
        return pkts, lens, np.asarray([t for _, t in items], np.int64)

    def close(self):
        if self._native is not None:
            if self._handle:
                self._native.pp_udp_close(self._handle)
                self._handle = None
        else:
            self._stop.set()
            self._thread.join(timeout=1.0)
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def paced(n: int, gap_s: float, send, t0=None, stats=None,
          clock=time.monotonic, sleep=time.sleep) -> None:
    """Call `send(i, j)` for items [i, j) of `n` on an absolute clock:
    item k is due at t0 + k * gap_s (t0 defaults to now).  Each wake-up
    sends every item whose time has come in one call, then sleeps until
    the next is due, so a sleep that overshoots delays a burst but not
    the average rate (a sleep after each item would add its overshoot to
    every gap).  `stats`, when given, receives "send_s" (from t0 to the
    last send) and "max_late_ms" (the furthest an item went out behind
    its time)."""
    t0 = clock() if t0 is None else t0
    i, late = 0, 0.0
    while i < n:
        now = clock()
        due = n if gap_s <= 0 else min(n, math.floor((now - t0) / gap_s) + 1)
        if due > i:
            late = max(late, now - (t0 + i * gap_s))
            send(i, due)
            i = due
        else:
            sleep(t0 + i * gap_s - now)
    if stats is not None:
        stats.update(send_s=clock() - t0, max_late_ms=late * 1e3)


def replay_packets(packets: np.ndarray, dest_ip: str = "127.0.0.1",
                   port: int = C.LIDAR_DATA_PORT,
                   pace_us: float = DEFAULT_PACE_US,
                   force_python: bool = False, t0=None,
                   stats=None) -> int:
    """Send (n, payload) uint8 packets `pace_us` µs apart on average
    (`paced`: packet k at t0 + k·pace_us, the due ones in one burst, the
    packet pump's sender at no pause unless `force_python`); returns the
    count sent.  `t0` and `stats` as `paced`'s."""
    packets = np.ascontiguousarray(packets, np.uint8)
    n, size = packets.shape
    count = [0]
    if not force_python:
        lib = native.load()

        def send(i, j):
            got = lib.pp_udp_send(dest_ip.encode(), port,
                                  as_u8p(packets[i:j]), j - i, size, 0)
            if got < 0:
                raise OSError(f"the packet pump could not send to "
                              f"{dest_ip}:{port}")
            count[0] += got
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

        def send(i, j):
            for k in range(i, j):
                sock.sendto(packets[k].tobytes(), (dest_ip, port))
            count[0] += j - i
    try:
        paced(n, pace_us * 1e-6, send, t0, stats)
    finally:
        if force_python:
            sock.close()
    return count[0]


def send_struct(payload: bytes, dest_ip: str = "127.0.0.1",
                port: int = C.INS_PORT) -> None:
    """One-shot small-struct sender (at most 1200 bytes)."""
    if len(payload) > 1200:
        raise ValueError("payload exceeds 1200 bytes")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.sendto(payload, (dest_ip, port))
    finally:
        sock.close()
