"""HDL data-packet encoders (host, numpy).

A jax-free copy of what the simulator and StreamingOdometry.run_device
use from veloslam_tpu/io/packets.py (importing the original imports jax
through the io package's __init__).  tests/test_torch_host.py holds the
copies equal to the originals.
"""

from __future__ import annotations

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
