"""A simulated drive: the packet stream of a sensor swept through the
world along the vehicle's path, and the 100 Hz INS truth.

`generate` is `io/simulate.py::generate_sequence` (HDL-32 and HDL-64)
rewritten in torch float64 and cut into chunks of packets,
so a long drive is simulated on the card in a few large calls.  The
packets come back to the host once, as the bytes a pcap holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from slambench.gen import scene
from slambench.gen import sensor as S

T0_US = 1_700_000_000_000_000       # the drive's first packet, Unix µs
CHUNK_PACKETS = 16384


@dataclasses.dataclass
class Drive:
    model: str
    packets: np.ndarray             # (N, 1206) uint8
    pkt_times_us: np.ndarray        # (N,) int64
    ins_t_us: np.ndarray            # (M,) int64, 100 Hz
    ins_pos: np.ndarray             # (M, 3) truth
    ins_yaw: np.ndarray             # (M,)
    ins_vel: np.ndarray             # (M, 3)
    path: scene.Circle              # the truth as a function of time


def _encode(az: torch.Tensor, dist: torch.Tensor, inten: torch.Tensor,
            gps_us: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """(n, 1206) uint8 packets from per-block azimuth ticks (n, 12),
    distance codes and intensities (n, 12, 32), µs-into-hour stamps (n,)
    and block ids (n, 12): `io/packets.py::encode_lidar_packets`."""
    n = az.shape[0]
    pk = torch.zeros((n, S.PACKET_BYTES), dtype=torch.uint8,
                     device=az.device)
    blocks = pk[:, :1200].view(n, 12, 100)
    blocks[..., 0] = (block_ids & 0xFF).to(torch.uint8)
    blocks[..., 1] = ((block_ids >> 8) & 0xFF).to(torch.uint8)
    blocks[..., 2] = (az & 0xFF).to(torch.uint8)
    blocks[..., 3] = ((az >> 8) & 0xFF).to(torch.uint8)
    rets = blocks[:, :, 4:].reshape(n, 12, 32, 3)
    rets[..., 0] = (dist & 0xFF).to(torch.uint8)
    rets[..., 1] = ((dist >> 8) & 0xFF).to(torch.uint8)
    rets[..., 2] = inten.to(torch.uint8)
    blocks[:, :, 4:] = rets.reshape(n, 12, 96)
    for i in range(4):
        pk[:, 1200 + i] = ((gps_us >> (8 * i)) & 0xFF).to(torch.uint8)
    return pk


def generate(duration_s: float, model: str, world: scene.World,
             path: scene.Circle, calib: Optional[S.Calib] = None,
             rpm: float = 600.0, device="cpu", max_range: float = 120.0,
             noise_std: float = 0.0, seed: int = 0) -> Drive:
    """Simulate `duration_s` seconds of `model` on `device`, each return's
    range with normal noise of `noise_std` m drawn from `seed` (on the
    device's generator, chunk by chunk)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    calib = calib or S.default_calib(model)
    period_us, dsr_dt_us, dsr_frac = S.block_timing(model)
    hdl64 = model == "hdl64"
    per_fire = 2 if hdl64 else 1
    n_fire = int(duration_s * 1e6 / period_us)
    n_blocks = n_fire * per_fire
    n_blocks -= n_blocks % S.BLOCKS_PER_PACKET
    n_pkts = n_blocks // S.BLOCKS_PER_PACKET
    rate_ticks = rpm / 60.0 * S.TICKS_PER_REV
    step = period_us * 1e-6 * rate_ticks

    f64 = dict(dtype=torch.float64, device=dev)
    dsr_frac_t = torch.as_tensor(dsr_frac, **f64)
    dsr_dt_t = torch.as_tensor(dsr_dt_us, **f64)
    vert_all = torch.deg2rad(torch.as_tensor(calib.vert_deg, **f64))
    rot_all = torch.as_tensor(calib.rot_deg, **f64)
    lasers = torch.arange(32, device=dev)
    if hdl64:
        ids = torch.where(torch.arange(12, device=dev) % 2 == 0,
                          S.BLOCK_ID_0_TO_31, S.BLOCK_ID_32_TO_63)
    else:
        ids = torch.full((12,), S.BLOCK_ID_0_TO_31, device=dev)
    ids = ids.to(torch.int64)
    intensity_of = torch.tensor([0, 80, 200, 150, 255], dtype=torch.int64,
                                device=dev)

    packets = np.empty((n_pkts, S.PACKET_BYTES), np.uint8)
    times = np.empty(n_pkts, np.int64)
    for p0 in range(0, n_pkts, CHUNK_PACKETS):
        p1 = min(n_pkts, p0 + CHUNK_PACKETS)
        n = p1 - p0
        blk = torch.arange(p0 * 12, p1 * 12, device=dev)     # (n·12,)
        fire = blk // per_fire
        fire_t = fire.to(torch.float64) * period_us * 1e-6
        fire_az = torch.floor(fire_t * rate_ticks).to(torch.int64) \
            % S.TICKS_PER_REV
        az_pt = (fire_az[:, None] + step * dsr_frac_t[None, :]) \
            % S.TICKS_PER_REV                                 # (n·12, 32)
        t_pt = fire_t[:, None] + dsr_dt_t[None, :] * 1e-6
        laser = (lasers[None, :] + 32 * (blk % 2)[:, None] if hdl64
                 else lasers[None, :].expand(blk.shape[0], 32))
        vert = vert_all[laser]
        rot = rot_all[laser]
        az_rad = torch.deg2rad(az_pt / S.TICKS_PER_DEG - rot)
        dirs_s = torch.stack([torch.cos(vert) * torch.sin(az_rad),
                              torch.cos(vert) * torch.cos(az_rad),
                              torch.sin(vert)], -1)
        pos, yaw, _ = path(t_pt.reshape(-1))
        dirs_w = torch.einsum("rij,rj->ri", scene.yaw_matrix(yaw),
                              dirs_s.reshape(-1, 3))
        dist, kind = scene.raycast(world, pos, dirs_w, max_range=max_range)
        if noise_std > 0:
            noise = torch.randn(dist.shape, generator=gen, device=dev,
                                dtype=torch.float64)
            dist = torch.where(dist > 0, dist + noise_std * noise, 0.0)
        dist_raw = torch.round(torch.clamp(dist, min=0.0)
                               / S.DISTANCE_UNIT_M)
        dist_raw = torch.where((dist_raw > 0) & (dist_raw < 65536),
                               dist_raw, 0).to(torch.int64)
        inten = intensity_of[kind.long()]
        t_us = T0_US + (fire_t.view(n, 12)[:, 0] * 1e6).to(torch.int64)
        pk = _encode(fire_az.view(n, 12), dist_raw.view(n, 12, 32),
                     inten.view(n, 12, 32), t_us % (3600 * 1_000_000),
                     ids[None, :].expand(n, 12))
        packets[p0:p1] = pk.cpu().numpy()
        times[p0:p1] = t_us.cpu().numpy()

    ins_t = torch.from_numpy(np.arange(0.0, duration_s + 0.01,
                                       S.INS_PERIOD_S))
    ins_pos, ins_yaw, ins_vel = path(ins_t.to(dev))
    return Drive(model=model, packets=packets, pkt_times_us=times,
                 ins_t_us=T0_US + (ins_t.numpy() * 1e6).astype(np.int64),
                 ins_pos=ins_pos.cpu().numpy(),
                 ins_yaw=ins_yaw.cpu().numpy(),
                 ins_vel=ins_vel.cpu().numpy(), path=path)
