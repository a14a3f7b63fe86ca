"""WGS-84 geodesy on the host: llh ↔ ECEF ↔ ENU (float64 numpy).

A jax-free copy of the numpy functions of veloslam_tpu/core/geodesy.py
that the simulator's pcap writer, the INS converter and the INS replay
need (the original module imports jax).  Angles are radians.
tests/test_torch_host.py and tests/test_torch_live.py hold the copies
equal.
"""

from __future__ import annotations

import numpy as np

# WGS-84 ellipsoid
WGS84_A = 6378137.0          # semi-major axis (m)
WGS84_B = 6356752.3142       # semi-minor axis (m)
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2     # first eccentricity squared
WGS84_EP2 = (WGS84_A / WGS84_B) ** 2 - 1.0    # second eccentricity squared


def llh2xyz_np(llh):
    lat, lon, h = llh[..., 0], llh[..., 1], llh[..., 2]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)  # prime vertical
    x = (n + h) * cos_lat * np.cos(lon)
    y = (n + h) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return np.stack([x, y, z], axis=-1)


def xyz2llh_np(xyz):
    """Heikkinen's exact closed-form ECEF → geodetic solution."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    a, b, e2, ep2 = WGS84_A, WGS84_B, WGS84_E2, WGS84_EP2
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
    lat = np.arctan2(z + ep2 * z0, r)
    lon = np.arctan2(y, x)
    return np.stack([lat, lon, h], axis=-1)


def _enu_rotation(orgllh):
    """Rows transform ECEF deltas into (east, north, up) at the origin."""
    lat, lon = orgllh[..., 0], orgllh[..., 1]
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    row_e = np.stack([-so, co, np.zeros_like(so)], -1)
    row_n = np.stack([-sl * co, -sl * so, cl], -1)
    row_u = np.stack([cl * co, cl * so, sl], -1)
    return np.stack([row_e, row_n, row_u], -2)


def xyz2enu_np(xyz, orgxyz):
    R = _enu_rotation(xyz2llh_np(orgxyz))
    d = xyz - orgxyz
    return np.einsum("...ij,...j->...i", R, d)


def llh2enu_np(llh, orgxyz):
    return xyz2enu_np(llh2xyz_np(llh), orgxyz)


def enu2xyz_np(enu, orgxyz):
    R = _enu_rotation(xyz2llh_np(orgxyz))
    return orgxyz + np.einsum("...ji,...j->...i", R, enu)


def enu2llh_np(enu, orgxyz):
    return xyz2llh_np(enu2xyz_np(enu, orgxyz))
