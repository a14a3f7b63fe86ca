"""WGS-84 geodesy: llh ↔ ECEF ↔ ENU, Euler → DCM.

The port of veloslam_tpu/core/geodesy.py, written as that module writes
it: one private implementation per function against a generic array
namespace, bound twice.  The `*_np` functions run it in float64 numpy on
the host (absolute coordinates: Earth-radius magnitudes need float64);
the unsuffixed ones run it on torch tensors, whose dtype and device
follow the inputs (array arguments that are not tensors are taken to the
first tensor argument's device and dtype).  Angles are radians.
`lever_arm_to_enu` has no caller, in this package or the JAX one: the
lever arm is not applied.  tests/test_torch_host.py and
tests/test_torch_geodesy.py hold both bindings to the JAX module's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# WGS-84 ellipsoid
WGS84_A = 6378137.0          # semi-major axis (m)
WGS84_B = 6356752.3142       # semi-minor axis (m)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2     # first eccentricity squared
WGS84_EP2 = (WGS84_A / WGS84_B) ** 2 - 1.0    # second eccentricity squared


def _llh2xyz(llh, xp):
    lat, lon, h = llh[..., 0], llh[..., 1], llh[..., 2]
    sin_lat, cos_lat = xp.sin(lat), xp.cos(lat)
    n = WGS84_A / xp.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)  # prime vertical
    x = (n + h) * cos_lat * xp.cos(lon)
    y = (n + h) * cos_lat * xp.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return xp.stack([x, y, z], axis=-1)


def _xyz2llh(xyz, xp):
    """Heikkinen's exact closed-form ECEF → geodetic solution."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    a, b, e2, ep2 = WGS84_A, WGS84_B, WGS84_E2, WGS84_EP2
    r2 = x * x + y * y
    r = xp.sqrt(r2)
    z2 = z * z
    F = 54.0 * b * b * z2
    G = r2 + (1.0 - e2) * z2 - e2 * (a * a - b * b)
    c = e2 * e2 * F * r2 / (G * G * G)
    s = (1.0 + c + xp.sqrt(c * c + 2.0 * c)) ** (1.0 / 3.0)
    P = F / (3.0 * (s + 1.0 / s + 1.0) ** 2 * G * G)
    Q = xp.sqrt(1.0 + 2.0 * e2 * e2 * P)
    r0 = -(P * e2 * r) / (1.0 + Q) + xp.sqrt(
        xp.maximum(0.5 * a * a * (1.0 + 1.0 / Q)
                   - P * (1.0 - e2) * z2 / (Q * (1.0 + Q))
                   - 0.5 * P * r2, 0.0))
    t = (r - e2 * r0) ** 2
    U = xp.sqrt(t + z2)
    V = xp.sqrt(t + (1.0 - e2) * z2)
    z0 = b * b * z / (a * V)
    h = U * (1.0 - b * b / (a * V))
    lat = xp.arctan2(z + ep2 * z0, r)
    lon = xp.arctan2(y, x)
    return xp.stack([lat, lon, h], axis=-1)


def _enu_rotation(orgllh, xp):
    """Rows transform ECEF deltas into (east, north, up) at the origin."""
    lat, lon = orgllh[..., 0], orgllh[..., 1]
    sl, cl = xp.sin(lat), xp.cos(lat)
    so, co = xp.sin(lon), xp.cos(lon)
    row_e = xp.stack([-so, co, xp.zeros_like(so)], -1)
    row_n = xp.stack([-sl * co, -sl * so, cl], -1)
    row_u = xp.stack([cl * co, cl * so, sl], -1)
    return xp.stack([row_e, row_n, row_u], -2)


def _xyz2enu(xyz, orgxyz, xp):
    R = _enu_rotation(_xyz2llh(orgxyz, xp), xp)
    d = xyz - orgxyz
    return xp.einsum("...ij,...j->...i", R, d)


def _enu2xyz(enu, orgxyz, xp):
    R = _enu_rotation(_xyz2llh(orgxyz, xp), xp)
    return orgxyz + xp.einsum("...ji,...j->...i", R, enu)


def _llh2enu(llh, orgxyz, xp):
    return _xyz2enu(_llh2xyz(llh, xp), orgxyz, xp)


def _enu2llh(enu, orgxyz, xp):
    return _xyz2llh(_enu2xyz(enu, orgxyz, xp), xp)


def _eulr2dcm(eul, xp):
    """Body→navigation DCM from (roll, pitch, yaw), INS convention: the
    transpose of Rx(-roll)·Ry(-pitch)·Rz(-yaw)."""
    phi, theta, psi = -eul[..., 0], -eul[..., 1], -eul[..., 2]
    cps, sps = xp.cos(psi), xp.sin(psi)
    cth, sth = xp.cos(theta), xp.sin(theta)
    cph, sph = xp.cos(phi), xp.sin(phi)
    z = xp.zeros_like(phi)
    o = xp.ones_like(phi)
    C1 = xp.stack([xp.stack([cps, sps, z], -1),
                   xp.stack([-sps, cps, z], -1),
                   xp.stack([z, z, o], -1)], -2)
    C2 = xp.stack([xp.stack([cth, z, -sth], -1),
                   xp.stack([z, o, z], -1),
                   xp.stack([sth, z, cth], -1)], -2)
    C3 = xp.stack([xp.stack([o, z, z], -1),
                   xp.stack([z, cph, sph], -1),
                   xp.stack([z, -sph, cph], -1)], -2)
    dcm_nb = C3 @ (C2 @ C1)
    return xp.swapaxes(dcm_nb, -1, -2)


def _lever_arm_to_enu(pts_sensor, R_sensor2body, t_sensor2body, eul_body,
                      body_enu, xp):
    """Sensor-frame points → ENU via the sensor→body extrinsics and the
    body's attitude."""
    body = xp.einsum("...ij,...j->...i", R_sensor2body, pts_sensor) + t_sensor2body
    dcm = _eulr2dcm(eul_body, xp)
    return body_enu + xp.einsum("...ij,...j->...i", dcm, body)


class _TorchOps:
    """The numpy names the implementations call, on torch tensors."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def maximum(x, y):
        return torch.clamp_min(x, y)


_TORCH = _TorchOps()


def _bind(fn, xp):
    return functools.partial(fn, xp=xp)


def _bind_torch(fn):
    @functools.wraps(fn)
    def call(*args):
        ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
        kw = {} if ref is None else dict(device=ref.device, dtype=ref.dtype)
        return fn(*(a if isinstance(a, torch.Tensor)
                    else torch.as_tensor(a, **kw) for a in args), xp=_TORCH)
    return call


# Host (float64 numpy) versions — use these for absolute coordinates.
llh2xyz_np = _bind(_llh2xyz, np)
xyz2llh_np = _bind(_xyz2llh, np)
xyz2enu_np = _bind(_xyz2enu, np)
enu2xyz_np = _bind(_enu2xyz, np)
llh2enu_np = _bind(_llh2enu, np)
enu2llh_np = _bind(_enu2llh, np)
eulr2dcm_np = _bind(_eulr2dcm, np)
lever_arm_to_enu_np = _bind(_lever_arm_to_enu, np)

# Tensor versions; precision and device follow the inputs.
llh2xyz = _bind_torch(_llh2xyz)
xyz2llh = _bind_torch(_xyz2llh)
xyz2enu = _bind_torch(_xyz2enu)
enu2xyz = _bind_torch(_enu2xyz)
llh2enu = _bind_torch(_llh2enu)
enu2llh = _bind_torch(_enu2llh)
eulr2dcm = _bind_torch(_eulr2dcm)
lever_arm_to_enu = _bind_torch(_lever_arm_to_enu)
