"""The synthetic world, the vehicle's path and the closed-form raycast.

A frozen copy of `World.demo`, `circle_trajectory` and `raycast` from the
port's `io/simulate.py`, with the raycast in torch float64 on any device.
Every seed drives the same world along the same path, so every seed
does the same work; the seed draws the range noise (`drive.generate`).
The drive always starts where the loop passes the origin: started
elsewhere on its loop, the port's bulk odometry can lose its map in the
first second and never recover.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class World:
    """Ground plane + posts (cx, cy, r, z0, z1) + walls (x0, y0, x1, y1,
    zlo, zhi), float64 numpy."""

    ground_z: float
    posts: np.ndarray
    walls: np.ndarray

    @staticmethod
    def demo(seed: int, extent: float = 80.0, n_posts: int = 24,
             n_walls: int = 8) -> "World":
        """`io/simulate.py::World.demo`, draw for draw."""
        rng = np.random.default_rng(seed)
        posts = np.column_stack([
            rng.uniform(-extent, extent, n_posts),
            rng.uniform(-extent, extent, n_posts),
            rng.uniform(0.15, 0.5, n_posts),
            np.zeros(n_posts),
            rng.uniform(3.0, 8.0, n_posts),
        ])
        walls = []
        for _ in range(n_walls):
            x0, y0 = rng.uniform(-extent, extent, 2)
            ang = rng.uniform(0, 2 * np.pi)
            ln = rng.uniform(10.0, 30.0)
            walls.append([x0, y0, x0 + ln * np.cos(ang),
                          y0 + ln * np.sin(ang), 0.0, rng.uniform(3.0, 6.0)])
        return World(0.0, posts, np.asarray(walls).reshape(-1, 6))


@dataclasses.dataclass(frozen=True)
class Circle:
    """Counter-clockwise circle through the origin, heading the tangent
    (`circle_trajectory`)."""

    radius: float
    speed: float
    z: float = 2.0

    def __call__(self, t: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pos (..., 3), yaw (...), vel (..., 3)) at times `t` (s,
        float64 tensor)."""
        w = self.speed / self.radius
        ang = w * t
        x = self.radius * torch.sin(ang)
        y = self.radius * (1 - torch.cos(ang))
        vx = self.speed * torch.cos(ang)
        vy = self.speed * torch.sin(ang)
        pos = torch.stack([x, y, torch.full_like(x, self.z)], -1)
        vel = torch.stack([vx, vy, torch.zeros_like(vx)], -1)
        return pos, ang, vel


def yaw_matrix(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(
        *yaw.shape, 3, 3)


def raycast(world: World, o: torch.Tensor, d: torch.Tensor,
            max_range: float = 120.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form ray intersection, `io/simulate.py::raycast` on one
    chunk: (dist (R,) float64, 0 where nothing is hit within max_range;
    kind (R,) uint8: 0 none, 1 ground, 2 post, 3 wall)."""
    best = torch.full(o.shape[:1], max_range, dtype=o.dtype,
                      device=o.device)
    k = torch.zeros(o.shape[:1], dtype=torch.uint8, device=o.device)

    dz = d[:, 2]
    tg = (world.ground_z - o[:, 2]) / dz
    hit = (dz != 0) & (tg > 0.1) & (tg < best)
    best = torch.where(hit, tg, best)
    k = torch.where(hit, 1, k)

    ax, ay = d[:, 0], d[:, 1]
    a = ax ** 2 + ay ** 2
    for cx, cy, r, z0, z1 in world.posts.tolist():
        ox, oy = o[:, 0] - cx, o[:, 1] - cy
        b = 2 * (ox * ax + oy * ay)
        c0 = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * c0
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
        z = o[:, 2] + t * d[:, 2]
        hit = (disc > 0) & (a > 0) & (t > 0.1) & (t < best) \
            & (z >= z0) & (z <= z1)
        best = torch.where(hit, t, best)
        k = torch.where(hit, 2, k)

    for x0, y0, x1, y1, zlo, zhi in world.walls.tolist():
        sx, sy = x1 - x0, y1 - y0
        ln = float(np.hypot(sx, sy))
        nx, ny = -sy / ln, sx / ln
        denom = ax * nx + ay * ny
        t = ((x0 - o[:, 0]) * nx + (y0 - o[:, 1]) * ny) / denom
        px = o[:, 0] + t * ax - x0
        py = o[:, 1] + t * ay - y0
        u = (px * sx + py * sy) / (ln * ln)
        z = o[:, 2] + t * d[:, 2]
        hit = (torch.abs(denom) > 1e-12) & (t > 0.1) & (t < best) \
            & (u >= 0) & (u <= 1) & (z >= zlo) & (z <= zhi)
        best = torch.where(hit, t, best)
        k = torch.where(hit, 3, k)

    return torch.where(k > 0, best, 0.0), k
