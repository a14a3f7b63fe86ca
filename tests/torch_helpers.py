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


def port_args(pts, q, tr, mu, nrm, hit):
    """normal_equation_slots output → the wrapper's CPU tensors."""
    return (t(pts), t(q), t(tr), t(mu), t(nrm), t(hit.astype(np.uint8)))
