"""The port on a CUDA card: the hand-written normal-equations kernel
against its plain version, and the odometry slice on the card against the
same slice on the CPU.  Marked `cuda`; each test skips where
torch.cuda.is_available() is false.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \
        tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax, which that machine
need not have; this module imports no jax.)
"""

import numpy as np
import pytest
import torch

from torch_helpers import normal_equation_slots, port_args
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.registration import normal_equations as ne
from veloslam_tpu_torch.runtime import odometry as odo

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("F,P", [(96, 16384), (3, 1000), (1, 1), (5, 0)])
def test_kernel_matches_plain_on_card(card, F, P):
    """|Δ| ≤ 1e-4·max|ref| + 1e-3 on H and b, 1e-4 relative on the sums,
    n_hit exact, two launches bitwise equal; LAUNCHES counts each."""
    args = [a.to(card) for a in
            port_args(*normal_equation_slots(F, P, seed=F + P))]
    before = ne.LAUNCHES
    got = ne.fused_normal_equations(*args)
    again = ne.fused_normal_equations(*args)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 2
    ref = ne.normal_equations_plain(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for x, r in zip(got[:2], ref[:2]):
        lim = 1e-4 * (r.abs().max().item() if r.numel() else 0) + 1e-3
        assert (x - r).abs().max().item() <= lim
    for x, r in zip(got[2:4], ref[2:4]):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-6)
    assert torch.equal(got[4], ref[4])


def test_odometry_on_card_matches_cpu(card):
    world = sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24)
    seq = sim.generate_sequence(duration_s=0.8, model="hdl32", seed=23,
                                world=world)
    track = sim.truth_track(seq, drift_rate=0.3)
    kw = dict(voxel_size=0.5, reg_points=2048, reg_iterations=16,
              map_capacity=16384, reassociate_every=8)
    out = {}
    for dev in ("cpu", card):
        o = odo.StreamingOdometry(DeviceCalib.from_host(cal.hdl32(),
                                                        device=dev), **kw)
        before = ne.LAUNCHES
        out[str(dev)] = o.run(seq["packets"], seq["pkt_times_us"], track,
                              batch=256)
        launches = ne.LAUNCHES - before
        assert launches == (16 * o.batches_fed if dev == card else 0)
    a, b = out["cpu"], out[str(card)]
    assert a["n_frames"] == b["n_frames"] >= 5
    np.testing.assert_array_equal(a["times_us"], b["times_us"])
    assert np.abs(a["positions"] - b["positions"]).max() < 0.01
