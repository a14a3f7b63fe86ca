"""Shared pieces of the tests/test_torch_*.py parity tests: a fixture that
keeps torch to two threads (the tier runs several pytest workers side by
side), and numpy <-> torch helpers."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def small_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def t(a, dtype=None):
    """numpy (or anything np.asarray takes) → CPU tensor (a copy)."""
    return torch.as_tensor(np.array(a, dtype=dtype))


def n(x):
    """torch tensor or jax array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normal_equation_slots(F, P, seed, max_dist=2.0):
    """Posed-scan inputs: points to 40 m, unit normals, ~80% hits, means
    along the normal so residuals cover both Huber regimes and ~10% fail
    the max_dist gate; none within 0.02 of max_dist (a threshold that
    float32 rounding could put either way)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (F, P, 3))
    ang = rng.uniform(-0.2, 0.2, F)
    axis = rng.normal(size=(F, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2)[:, None],
                        np.sin(ang / 2)[:, None] * axis], 1)
    tr = rng.normal(0, 2, (F, 3))
    nrm = rng.normal(size=(F, P, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    u, w = q[:, None, 1:], q[:, None, :1]
    uv = np.cross(u, pts)
    posed = pts + 2.0 * (w * uv + np.cross(u, uv)) + tr[:, None]
    r = rng.normal(0, 0.6, (F, P))
    out = rng.random((F, P)) < 0.1
    r = np.where(out, rng.uniform(max_dist + 0.02, 5, (F, P)) * np.sign(r),
                 r)
    r = np.where(np.abs(np.abs(r) - max_dist) < 0.02, 0.9 * r, r)
    tangent = rng.normal(0, 0.3, (F, P, 3))
    tangent -= np.sum(tangent * nrm, -1, keepdims=True) * nrm
    mu = posed - nrm * r[..., None] + tangent
    hit = rng.random((F, P)) < 0.8
    f32 = np.float32
    return (pts.astype(f32), q.astype(f32), tr.astype(f32), mu.astype(f32),
            nrm.astype(f32), hit)


def with_edge_slots(pts, q, tr, mu, nrm, hit):
    """normal_equation_slots output (F ≥ 3) with slots 0-2 turned into the
    Gauss-Newton step's edge cases: slot 0 keeps 5 hits (n_hit ≤ 10: step
    rejected); slot 1's means sit at its posed points moved 1.5 m along
    x, so its step is that translation, clamped to 1 m; slot 2 holds a
    NaN in a flagged point (H, b and err NaN; the factor fails: step
    rejected)."""
    pts, mu, hit = pts.copy(), mu.copy(), hit.copy()
    hit[0] = False
    hit[0, :5] = True
    u, w = q[1, 1:].astype(np.float64), float(q[1, 0])
    uv = np.cross(u, pts[1])
    posed = pts[1] + 2.0 * (w * uv + np.cross(u, uv)) + tr[1]
    mu[1] = posed + np.array([1.5, 0.0, 0.0])
    hit[2, 0] = True
    pts[2, 0, 0] = np.nan
    return pts, q, tr, mu, nrm, hit


def port_args(pts, q, tr, mu, nrm, hit):
    """normal_equation_slots output → the wrapper's CPU tensors."""
    return (t(pts), t(q), t(tr), t(mu), t(nrm), t(hit.astype(np.uint8)))


def map_scans(K=70, P=512, seed=0):
    """Frame-local scans (points within ±30 m, 0-6 m up, half of each on
    walls every 10 m, ~90% valid) and world poses (yaw, ±150 m in x, y):
    several 100 m map tiles, 1 m voxels hit by several points."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-30, 30, (K, P, 2)),
                          rng.uniform(0, 6, (K, P, 1))], -1)
    pts[:, : P // 2, 0] = np.round(pts[:, : P // 2, 0] / 10) * 10 + 0.3
    msk = rng.random((K, P)) < 0.9
    yaw = rng.uniform(-np.pi, np.pi, K)
    q = np.stack([np.cos(yaw / 2), np.zeros(K), np.zeros(K),
                  np.sin(yaw / 2)], -1)
    tr = np.concatenate([rng.uniform(-150, 150, (K, 2)),
                         rng.uniform(-1, 1, (K, 1))], -1)
    return (pts.astype(np.float32), msk, q.astype(np.float32),
            tr.astype(np.float32))
