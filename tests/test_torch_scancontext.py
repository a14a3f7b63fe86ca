"""Parity of the port's scan-context descriptors with the JAX package.

Descriptors: cell maxima are exact (a max adds no rounding), but a point
whose azimuth or range sits within an ulp of a cell edge may land in the
neighbouring cell when atan2 or the norm rounds the other way: at most a
few cells of 960 per scan may differ.  Scores: within 1e-5 (the shift
matmuls sum 960 products in another order); shifts exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_registration import _static_scan
from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.graph import scancontext as jsc
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu_torch.graph import scancontext as sc


@pytest.fixture(scope="module")
def scans():
    """Eight raycast scans of one world, on a loop with revisits, and
    their masks (some points masked, one scan empty)."""
    world = jsim.World.demo(seed=3, extent=40.0, n_posts=40, n_walls=16)
    rng = np.random.default_rng(0)
    P = 4096
    out, masks = [], []
    for k in range(8):
        ang = 2 * np.pi * (k % 5) / 5
        pos = np.array([8 * np.sin(ang), 8 * (1 - np.cos(ang)), 2.0])
        pts = _static_scan(world, pos + rng.normal(0, 0.2, 3) * [1, 1, 0],
                           ang + rng.normal(0, 0.05), n_az=450)
        idx = rng.choice(len(pts), P, replace=len(pts) < P)
        out.append(pts[idx])
        masks.append(rng.random(P) < 0.95)
    masks[5][:] = False                          # an empty keyframe
    return np.stack(out).astype(np.float32), np.stack(masks)


def test_scan_context_batch_matches_jax(scans):
    pts, mask = scans
    want = n(jsc.scan_context_batch(jnp.asarray(pts), jnp.asarray(mask)))
    got = n(sc.scan_context_batch(t(pts), t(mask)))
    assert got.shape == want.shape == (8, sc.N_RINGS, sc.N_SECTORS)
    assert (got != want).sum(axis=(1, 2)).max() <= 3
    assert not got[5].any() and (got > 0).sum() > 300
    np.testing.assert_array_equal(n(sc.scan_context(t(pts[0]), t(mask[0]))),
                                  got[0])


def test_descriptor_scores_match_jax(scans):
    """Same descriptors into both: scores to 1e-5, shifts exact, the
    empty descriptor scores 0 against everything."""
    pts, mask = scans
    desc = n(jsc.scan_context_batch(jnp.asarray(pts), jnp.asarray(mask)))
    s_j, a_j = jsc.descriptor_scores(jnp.asarray(desc))
    s_t, a_t = sc.descriptor_scores(t(desc))
    np.testing.assert_allclose(n(s_t), n(s_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(a_t), n(a_j))
    assert a_t.dtype == torch.int32
    assert not n(s_t)[5].any() and not n(s_t)[:, 5].any()
    assert n(s_t)[1, 6] > 0.5 and n(s_t)[2, 7] > 0.5    # revisits


def test_first_shift_wins_a_tie():
    """A descriptor constant along its sectors matches itself equally at
    every shift: the strict update keeps shift 0, as the JAX loop does."""
    desc = np.ones((2, sc.N_RINGS, sc.N_SECTORS), np.float32)
    desc[1, :, ::2] = 2.0                         # period-2 pattern
    s_t, a_t = sc.descriptor_scores(t(desc))
    s_j, a_j = jsc.descriptor_scores(jnp.asarray(desc))
    np.testing.assert_array_equal(n(a_t), n(a_j))
    assert int(a_t[0, 0]) == 0 and int(a_t[1, 1]) == 0


def test_relative_yaw_matches_jax():
    shifts = np.arange(-61, 62)
    np.testing.assert_array_equal(sc.relative_yaw(shifts),
                                  jsc.relative_yaw(shifts))
