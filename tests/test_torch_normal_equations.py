"""The port's normal-equations wrapper: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and against
gicp.normal_equations_fixed with the Pallas path; the CPU placement rule;
input checks; and the builder's refusal without nvcc.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py compare it with this plain version there)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import (n, normal_equation_slots, port_args,  # noqa: F401
                           small_threads, t, with_edge_slots)
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.registration import gicp as jgicp
from veloslam_tpu.registration.pallas_kernels import (TILE,
                                                      fused_normal_equations)
from veloslam_tpu_torch import _build
from veloslam_tpu_torch.registration import normal_equations as ne


def test_plain_matches_pallas_kernel_interpret():
    """test_pallas_kernels' case: P = 4 tiles, identity pose so the rows
    [p′, n, r, w] are the plain version's own intermediates.  Tolerances
    of tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(0)
    P = 4 * TILE
    p = rng.normal(0, 10, (1, P, 3)).astype(np.float32)
    nrm = rng.normal(size=(1, P, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    r_want = rng.normal(0, 0.1, (1, P)).astype(np.float32)
    mu = (p - nrm * r_want[..., None]).astype(np.float32)
    hit = rng.random((1, P)) < 0.7
    q = np.array([[1.0, 0, 0, 0]], np.float32)
    tr = np.zeros((1, 3), np.float32)
    H, b, err_sum, w_sum, n_hit = ne.normal_equations_plain(
        *port_args(p, q, tr, mu, nrm, hit))
    # The same residual and Huber weight, fed to the Pallas kernel as rows.
    r = np.sum(nrm * (p - mu), -1)[0]
    absr = np.abs(r)
    w = np.where(absr <= 0.5, 1.0, 0.5 / np.maximum(absr, 1e-12))
    w = np.where(hit[0] & (absr < 2.0), w, 0.0).astype(np.float32)
    rows = jnp.asarray(np.stack([p[0, :, 0], p[0, :, 1], p[0, :, 2],
                                 nrm[0, :, 0], nrm[0, :, 1], nrm[0, :, 2],
                                 r, w]))
    Hj, bj, ej, nj, wj = fused_normal_equations(rows, interpret=True)
    np.testing.assert_allclose(n(H[0]), n(Hj), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(n(b[0]), n(bj), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(float(w_sum[0]), float(wj), rtol=1e-5)
    np.testing.assert_allclose(float(err_sum[0]), float(ej), rtol=1e-5)
    assert int(n_hit[0]) == int(nj)


def test_plain_matches_gicp_pallas_path_three_slots():
    """Three posed slots with a ragged P (JAX pads to its 512 tile) against
    gicp.normal_equations_fixed(use_pallas=True, pallas_interpret=True),
    slot by slot.  Tolerances of tests/test_pallas_kernels.py (H rtol 1e-3
    atol 0.5, b rtol 1e-3 atol 0.05, err rtol 1e-4, n_hit exact)."""
    F, P = 3, 1700
    pts, q, tr, mu, nrm, hit = normal_equation_slots(F, P, seed=1)
    H, b, err, n_hit = _port_normal_equations(pts, q, tr, mu, nrm, hit)
    for f in range(F):
        Hj, bj, ej, nj = jgicp.normal_equations_fixed(
            jnp.asarray(pts[f]), jse3.Pose(jnp.asarray(q[f]),
                                           jnp.asarray(tr[f])),
            jnp.asarray(mu[f]), jnp.asarray(nrm[f]), jnp.asarray(hit[f]),
            use_pallas=True, pallas_interpret=True)
        np.testing.assert_allclose(n(H[f]), n(Hj), rtol=1e-3, atol=0.5)
        np.testing.assert_allclose(n(b[f]), n(bj), rtol=1e-3, atol=0.05)
        np.testing.assert_allclose(float(err[f]), float(ej), rtol=1e-4)
        assert int(n_hit[f]) == int(nj)


def _port_normal_equations(pts, q, tr, mu, nrm, hit):
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import gicp
    return gicp.normal_equations_fixed(t(pts), se3.Pose(t(q), t(tr)), t(mu),
                                       t(nrm), t(hit))


def test_cpu_tensors_take_the_plain_version():
    args = port_args(*normal_equation_slots(2, 300, seed=2))
    assert ne.LAUNCHES == 0
    got = ne.fused_normal_equations(*args)
    want = ne.normal_equations_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ne.LAUNCHES == 0          # the plain path launches nothing


@pytest.mark.parametrize("edge", [False, True])
def test_gn_iteration_plain_is_normal_equations_then_gn_step(edge):
    """On CPU tensors gn_iteration is gicp.normal_equations_fixed followed
    by _gn_step (the GN iteration before the fused step), bitwise, and
    launches nothing; with_edge_slots' slots are rejected, clamped,
    rejected."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import gicp
    slots = normal_equation_slots(4, 700, seed=5)
    if edge:
        slots = with_edge_slots(*slots)
    pts, q, tr, mu, nrm, hit = port_args(*slots)
    pose = se3.Pose(q, tr)
    got = ne.gn_iteration(pts, pose, mu, nrm, hit)
    H, b, err, n_hit = gicp.normal_equations_fixed(pts, pose, mu, nrm, hit)
    want = ne._gn_step(pose, H, b, n_hit, 1e-6)
    for x, w in ((got.pose.q, want.q), (got.pose.t, want.t), (got.H, H),
                 (got.b, b), (got.err, err)):
        assert torch.equal(x.view(torch.int32), w.view(torch.int32))
    assert torch.equal(got.n_hit, n_hit)
    assert got.step.tolist() == ([0, 2, 0, 1] if edge else [1, 1, 1, 1])
    assert ne.LAUNCHES == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    args = list(port_args(*normal_equation_slots(2, 64, seed=3)))
    if bad == "dtype":
        args[5] = args[5].to(torch.bool)
        err = TypeError
    elif bad == "shape":
        args[1] = args[1][:1]
        err = ValueError
    elif bad == "strided":
        args[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
        err = ValueError
    else:
        args = [a.to("meta") for a in args]
        err = ValueError
    with pytest.raises(err):
        ne.fused_normal_equations(*args)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("normal_equations")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("normal_equations")
    assert not (tmp_path / "build").exists()


def test_kernel_source_matches_wrapper():
    """The .cu exports the symbol the wrapper binds, for sm_90a, and the
    launch's arguments match the ctypes signature: 6 inputs, F, P,
    huber_delta, max_dist, chunk, 6 outputs of the normal equations,
    damping, 4 outputs of the step, the stream."""
    src = (_build.CSRC_DIR / "normal_equations.cu").read_text()
    m = re.search(r'extern "C" int veloslam_normal_equations\((.*?)\)',
                  src, re.S)
    assert m, "C entry point missing"
    args = [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]
    assert args == ["pts", "q", "t", "mu", "nrm", "hit", "F", "P",
                    "huber_delta", "max_dist", "chunk", "partial", "H", "b",
                    "err_sum", "w_sum", "n_hit", "damping", "q_out", "t_out",
                    "err", "step", "stream"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path("normal_equations").name.startswith(
        "normal_equations-")
