"""Parity of the port's geodesy (veloslam_tpu_torch/core/geodesy.py) with
the JAX module's, on the same seeded inputs.

* Every public name of the JAX module has its counterpart in the port.
* The numpy bindings run the same expressions in float64: equal to the
  bit, eulr2dcm_np and lever_arm_to_enu_np included.
* The tensor bindings against the JAX device functions: in float64 (JAX
  under enable_x64, as tests/test_geodesy.py runs it) within 1e-12
  relative and 1e-8 absolute (ECEF values near 6.4e6 m carry 9.3e-10 m
  ulps, and each library rounds its own sin and cos, so an ENU
  difference of two such values is good to a few of those ulps); in
  float32 (JAX without x64) within 4 float32 ulps of each output's
  largest magnitude, for the functions float32 serves: DCMs, the lever
  arm, llh → ECEF and the ENU of ECEF points given in float32 (ECEF
  coordinates in float32 carry 0.5 m ulps, so llh recovered from them is
  no parity question).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veloslam_tpu.core import geodesy as jgeo
from veloslam_tpu_torch.core import geodesy

PUBLIC = ("llh2xyz", "xyz2llh", "xyz2enu", "enu2xyz", "llh2enu", "enu2llh",
          "eulr2dcm", "lever_arm_to_enu")


def _inputs(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    llh = np.stack([rng.uniform(-1.4, 1.4, 16), rng.uniform(-3.1, 3.1, 16),
                    rng.uniform(-100.0, 3000.0, 16)], -1)
    org_llh = np.array([0.54, 2.11, 10.0])
    org = jgeo.llh2xyz_np(org_llh)
    near = np.stack([org_llh[0] + rng.normal(0, 1e-4, 16),
                     org_llh[1] + rng.normal(0, 1e-4, 16),
                     org_llh[2] + rng.normal(0, 20.0, 16)], -1)
    return {"llh": llh, "org": org, "near_llh": near,
            "xyz": jgeo.llh2xyz_np(llh), "near_xyz": jgeo.llh2xyz_np(near),
            "enu": rng.normal(0, 500.0, (16, 3)),
            "eul": rng.uniform(-np.pi, np.pi, (16, 3)),
            "pts": rng.normal(0, 20.0, (16, 3)),
            "R": jgeo.eulr2dcm_np(rng.uniform(-0.2, 0.2, 3)),
            "t": rng.normal(0, 1.0, 3),
            "body_enu": rng.normal(0, 100.0, 3)}


# name -> the input keys it takes (absolute ECEF inputs for float64).
CALLS = {
    "llh2xyz": ("llh",), "xyz2llh": ("xyz",),
    "xyz2enu": ("near_xyz", "org"), "enu2xyz": ("enu", "org"),
    "llh2enu": ("near_llh", "org"), "enu2llh": ("enu", "org"),
    "eulr2dcm": ("eul",),
    "lever_arm_to_enu": ("pts", "R", "t", "eul", "body_enu"),
}


def test_every_public_name_is_ported():
    names = [k for k in vars(jgeo) if not k.startswith("_")
             and callable(getattr(jgeo, k)) and k not in ("jnp", "np",
                                                          "functools",
                                                          "annotations")]
    want = set(PUBLIC) | {f"{k}_np" for k in PUBLIC}
    assert set(names) == want
    for k in want:
        assert callable(getattr(geodesy, k)), k


@pytest.mark.parametrize("name", PUBLIC)
def test_numpy_binding_equal_to_the_bit(name):
    x = _inputs()
    args = [x[k] for k in CALLS[name]]
    np.testing.assert_array_equal(getattr(geodesy, f"{name}_np")(*args),
                                  getattr(jgeo, f"{name}_np")(*args))


@pytest.mark.parametrize("name", PUBLIC)
def test_tensor_binding_float64_matches_jax_x64(name):
    """float64 tensors against jnp under enable_x64: 1e-12 relative,
    1e-8 absolute (metres, radians; a few ulps at the Earth's radius)."""
    x = _inputs()
    args = [x[k] for k in CALLS[name]]
    with jax.enable_x64(True):
        want = np.asarray(getattr(jgeo, name)(*(jnp.asarray(a)
                                                for a in args)))
    got = getattr(geodesy, name)(*(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-8)


@pytest.mark.parametrize("name", ("xyz2enu", "llh2xyz", "eulr2dcm",
                                  "lever_arm_to_enu"))
def test_tensor_binding_float32_matches_jax(name):
    """float32 tensors (non-tensor arguments take the first tensor's
    dtype) against jnp in float32: the two packages' float32 rounding,
    within 4 ulps of each output's largest magnitude."""
    x = _inputs()
    args = [x[k].astype(np.float32) for k in CALLS[name]]
    want = np.asarray(getattr(jgeo, name)(*(jnp.asarray(a) for a in args)))
    assert want.dtype == np.float32
    got = getattr(geodesy, name)(torch.as_tensor(args[0]), *args[1:])
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * scale)


def test_tensor_binding_follows_the_input_device_and_round_trips():
    x = _inputs()
    enu = torch.as_tensor(x["enu"])
    back = geodesy.llh2enu(geodesy.enu2llh(enu, x["org"]), x["org"])
    assert back.device == enu.device and back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), x["enu"], atol=1e-6)
    d = geodesy.eulr2dcm(torch.as_tensor(x["eul"]))
    np.testing.assert_allclose(
        (d @ d.transpose(-1, -2)).numpy(),
        np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-12)
