"""Parity of the per-frame pipeline's loop-closure proposal and
verification with the JAX package.

Proposal (host numpy in both): find_candidates over keyframe positions
and scancontext.propose over a score matrix, exact.  Verification: the
same keyframe scans (raycast from one world, P = 8192) through the JAX
package's verify_closures_batch / verify_closure and the port's; the same
accept/reject per candidate and the accepted poses within 1e-4 (the
registrations sum float32 terms in other orders).  With obs_accept = 2.0
every tight candidate lands in the gray zone, so the reverse pass and the
cycle check run too."""

import jax.numpy as jnp
import numpy as np
import pytest

from test_registration import _static_scan
from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.graph import loopclosure as jlc
from veloslam_tpu.graph import scancontext as jsc
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.graph import loopclosure as lc
from veloslam_tpu_torch.graph import scancontext as sc

P = 8192
CAP = 8192


def test_find_candidates_matches_jax():
    rng = np.random.default_rng(0)
    # A drive that loops twice: revisits near each other, some ties.
    ang = np.linspace(0, 4 * np.pi, 120)
    pos = np.stack([10 * np.cos(ang), 10 * np.sin(ang), np.zeros(120)], 1)
    pos += rng.normal(0, 0.8, pos.shape)
    pos[7] = pos[70]                       # an exact tie
    for kw in ({}, {"radius": 3.0, "min_gap": 20},
               {"radius": 6.0, "min_gap": 30, "max_per_keyframe": 2}):
        want = jlc.find_candidates(pos, **kw)
        got = lc.find_candidates(pos, **kw)
        assert got == want
    assert len(lc.find_candidates(pos, radius=3.0, min_gap=20)) > 10
    assert lc.find_candidates(np.zeros((0, 3))) == []


def test_propose_matches_jax():
    rng = np.random.default_rng(1)
    K = 40
    s = rng.uniform(-0.2, 1.0, (K + 8, K + 8)).astype(np.float32)
    s[3, 30] = s[4, 31] = 0.97                  # equal scores
    shifts = rng.integers(0, 60, s.shape).astype(np.int32)
    for kw in ({"min_score": 0.6, "min_gap": 20},
               {"min_score": 0.5, "min_gap": 8, "max_per_keyframe": 2,
                "max_candidates": 5, "exclude": {(3, 30)}}):
        want = jsc.propose(s, shifts, n_valid=K, **kw)
        got = sc.propose(s, shifts, n_valid=K, **kw)
        assert got == want and len(got) >= 5


@pytest.fixture(scope="module")
def candidates():
    """Four candidate pairs (C, P) of keyframe scans in their own frames:
    two revisits (0.3 m / 2°, 1.2 m / 6° apart), a 4 m partial overlap,
    and an aliased pair from opposite ends of the world; priors from the
    truth with an error, identity for the aliased one."""
    world = jsim.World.demo(seed=3, extent=40.0, n_posts=40, n_walls=16)
    base = [np.array([0.0, 0.0, 2.0]), np.array([5.0, -4.0, 2.0]),
            np.array([-6.0, 3.0, 2.0]), np.array([-20.0, -20.0, 2.0])]
    offs = [(0.3, -0.2, 0.0, 2.0), (1.0, 0.6, 0.0, 6.0),
            (4.0, 0.5, 0.0, 3.0), (40.0, 38.0, 0.0, 90.0)]
    pi, pj, priors = [], [], []
    rng = np.random.default_rng(2)

    def sub(p):
        idx = np.sort(rng.choice(len(p), min(P, len(p)), replace=False))
        out = np.zeros((P, 3), np.float32)
        out[:len(idx)] = p[idx]
        return out, np.arange(P) < len(idx)

    mi, mj = [], []
    for b, o in zip(base, offs):
        a, m = sub(_static_scan(world, b, 0.0))
        pi.append(a)
        mi.append(m)
        yaw = np.deg2rad(o[3])
        c, m2 = sub(_static_scan(world, b + np.array(o[:3]), yaw))
        pj.append(c)
        mj.append(m2)
        if o[0] > 20:
            priors.append(([1.0, 0, 0, 0], [0.0, 0, 0]))
        else:
            e = 0.8 * yaw
            priors.append(([np.cos(e / 2), 0, 0, np.sin(e / 2)],
                           [0.8 * o[0], 0.8 * o[1], 0.0]))
    q = np.asarray([p[0] for p in priors], np.float32)
    tr = np.asarray([p[1] for p in priors], np.float32)
    return (np.stack(pi), np.stack(mi), np.stack(pj), np.stack(mj), q, tr)


@pytest.mark.parametrize("obs_accept", [0.75, 2.0])
def test_verify_closures_batch_matches_jax(candidates, obs_accept):
    pi, mi, pj, mj, q, tr = candidates
    kw = dict(voxel_size=1.0, capacity=CAP, obs_accept=obs_accept)
    want = jlc.verify_closures_batch(
        jnp.asarray(pi), jnp.asarray(mi), jnp.asarray(pj), jnp.asarray(mj),
        jse3.Pose(jnp.asarray(q), jnp.asarray(tr)), **kw)
    got = lc.verify_closures_batch(t(pi), t(mi), t(pj), t(mj),
                                   se3.Pose(t(q), t(tr)), **kw)
    assert [g is None for g in got] == [w is None for w in want]
    accepted = [k for k, w in enumerate(want) if w is not None]
    assert got[3] is None                      # the aliased pair
    assert accepted and accepted[:2] == [0, 1]
    for k in accepted:
        assert got[k].q.dtype == np.float32
        np.testing.assert_allclose(got[k].q, n(want[k].q), atol=1e-4)
        np.testing.assert_allclose(got[k].t, n(want[k].t), atol=1e-4)


@pytest.mark.parametrize("k", [0, 3])
def test_verify_closure_matches_jax(candidates, k):
    """One candidate (an accepted revisit, the aliased pair) through
    verify_closure, the reverse pass forced (obs_accept = 2.0)."""
    pi, mi, pj, mj, q, tr = candidates
    kw = dict(voxel_size=1.0, capacity=CAP, obs_accept=2.0)
    want = jlc.verify_closure(
        jnp.asarray(pi[k]), jnp.asarray(mi[k]), jnp.asarray(pj[k]),
        jnp.asarray(mj[k]), jse3.Pose(jnp.asarray(q[k]),
                                      jnp.asarray(tr[k])), **kw)
    got = lc.verify_closure(t(pi[k]), t(mi[k]), t(pj[k]), t(mj[k]),
                            se3.Pose(t(q[k]), t(tr[k])), **kw)
    assert (got is None) == (want is None) == (k == 3)
    if want is not None:
        np.testing.assert_allclose(got.q, n(want.q), atol=1e-4)
        np.testing.assert_allclose(got.t, n(want.t), atol=1e-4)
        batch = lc.verify_closures_batch(
            t(pi[k:k + 1]), t(mi[k:k + 1]), t(pj[k:k + 1]), t(mj[k:k + 1]),
            se3.Pose(t(q[k:k + 1]), t(tr[k:k + 1])), **kw)[0]
        np.testing.assert_array_equal(batch.t, got.t)


def test_cycle_error_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        a = rng.normal(size=4)
        a /= np.linalg.norm(a)
        b = a * np.array([1, -1, -1, -1]) + rng.normal(0, 0.01, 4)
        b /= np.linalg.norm(b)
        ta, tb = rng.normal(size=3), rng.normal(size=3)
        f32 = np.float32
        want = jlc._cycle_error(
            jse3.Pose(jnp.asarray(a, f32), jnp.asarray(ta, f32)),
            jse3.Pose(jnp.asarray(b, f32), jnp.asarray(tb, f32)))
        got = lc._cycle_error(se3.Pose(a.astype(f32), ta.astype(f32)),
                              se3.Pose(b.astype(f32), tb.astype(f32)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    H = rng.normal(size=(6, 6)).astype(np.float32)
    H = H @ H.T
    assert lc._lam_min_per_match(H, 50) == jlc._lam_min_per_match(H, 50)
    H[0, 0] = np.nan
    assert lc._lam_min_per_match(H, 50) == 0.0
