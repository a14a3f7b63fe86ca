"""Parity of the port's packet decode and motion compensation with the JAX
package, on simulated packets and on the independently built HDL-32 pcap
fixture (read with the JAX package's pcap reader).

Exact: valid, laser_id, az_ticks, is_upper, subfiring, frame breaks.
Tolerance: xyz atol 1e-4 m — float32 sin/cos of the same azimuths differ
by a few ulps between XLA and torch, times ranges up to 120 m."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode import decode as jdec
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu.io.pcap import read_lidar_packets
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode import decode as dec
from veloslam_tpu_torch.io import simulate as sim

PCAP = os.path.join(os.path.dirname(__file__), "fixtures",
                    "hdl32_indep.pcap")
EXACT = ("valid", "laser_id", "az_ticks", "is_upper", "subfiring")
CLOSE = {"xyz": 1e-4, "dist_m": 1e-5, "intensity": 0.0,
         "az_pt_ticks": 1e-3, "dt_s": 1e-9}


def _check_decoded(got, want):
    for f in EXACT:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)), err_msg=f)
    for f, atol in CLOSE.items():
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(want, f)),
                                   atol=atol, rtol=0, err_msg=f)


def _both(pkts, model):
    want = jdec.decode_packets(jnp.asarray(pkts),
                               jdec.DeviceCalib.from_host(
                                   jcal.default_for(model)), model=model)
    got = dec.decode_packets(t(pkts), dec.DeviceCalib.from_host(
        cal.default_for(model), device="cpu"), model=model)
    return got, want


@pytest.mark.parametrize("model", ["hdl32", "vlp16", "hdl64"])
def test_decode_simulated_packets_matches_jax(model):
    seq = sim.generate_sequence(duration_s=0.05, model=model, seed=1,
                                world=sim.World.demo(3))
    got, want = _both(seq["packets"], model)
    _check_decoded(got, want)


def test_decode_pcap_fixture_matches_jax():
    pkts, _, _ = read_lidar_packets(PCAP)
    got, want = _both(pkts, "hdl32")
    _check_decoded(got, want)
    assert n(got.valid).any()


def test_parse_fields_match_jax():
    pkts, _, _ = read_lidar_packets(PCAP)
    for a, b in zip(dec.parse_packet_fields(t(pkts)),
                    jdec.parse_packet_fields(jnp.asarray(pkts))):
        np.testing.assert_array_equal(n(a), n(b).astype(n(a).dtype))


def test_frame_breaks_and_compensation_match_jax():
    seq = jsim.generate_sequence(duration_s=0.25, model="hdl32", seed=2,
                                 world=jsim.World.demo(6))
    pkts = seq["packets"]
    got, want = _both(pkts, "hdl32")
    for last in (-1, 35000):
        a = dec.frame_break_flags(got.az_ticks, t(last, np.int32))
        b = jdec.frame_break_flags(want.az_ticks, jnp.asarray(last,
                                                              jnp.int32))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(n(x), n(y))
    assert n(a[0]).sum() >= 1         # the drive wraps azimuth
    anchor = int(seq["pkt_times_us"][0])
    rel = ((seq["pkt_times_us"] - anchor) * 1e-6).astype(np.float32)
    track = sim.truth_track(seq).window(anchor, int(seq["pkt_times_us"][-1]),
                                        anchor_us=anchor)
    trk = [track[k] for k in ("rel_s", "q", "t", "v")]
    xyz_g, poses_g = dec.compensate(got, t(rel), *(t(a) for a in trk))
    xyz_w, poses_w = jdec.compensate(want, jnp.asarray(rel),
                                     *(jnp.asarray(a) for a in trk))
    np.testing.assert_allclose(n(poses_g.q), n(poses_w.q), atol=1e-6)
    np.testing.assert_allclose(n(poses_g.t), n(poses_w.t), atol=1e-5)
    np.testing.assert_allclose(n(xyz_g), n(xyz_w), atol=1e-4, rtol=0)


def _dual_packets():
    """tests/test_dual_return.py's packet (6 dual pairs: the second
    return farther on laser 0, nearer and brighter on laser 1, identical
    on laser 2, missing on laser 3) followed by simulated single-return
    packets."""
    from veloslam_tpu.io import packets as jpk
    az = np.repeat(np.arange(6) * 600, 2).reshape(1, 12)
    dist = np.full((1, 12, 32), 5000)
    inten = np.full((1, 12, 32), 100)
    dist[0, 1::2, 0] = 6000
    dist[0, 1::2, 1] = 4000
    inten[0, 1::2, 1] = 180
    dist[0, 1::2, 3] = 0
    dual = jpk.encode_lidar_packets(az, dist, inten, np.zeros(1))
    seq = jsim.generate_sequence(duration_s=0.01, model="hdl32", seed=4,
                                 world=jsim.World.demo(3))
    return np.concatenate([dual, seq["packets"][:6]])


@pytest.mark.parametrize("mode", ["near", "far", "high", "low"])
def test_dual_return_flags_and_filter_match_jax(mode):
    """Exact: the flags, the pair mask and the filtered valid mask."""
    pkts = _dual_packets()
    got, want = _both(pkts, "hdl32")
    for a, b in zip(dec.dual_return_flags(got),
                    jdec.dual_return_flags(want)):
        assert n(a).dtype == n(b).dtype
        np.testing.assert_array_equal(n(a), n(b))
    assert n(dec.dual_return_flags(got)[2]).any()
    f_got = dec.apply_dual_return_filter(got, mode)
    f_want = jdec.apply_dual_return_filter(want, mode)
    np.testing.assert_array_equal(n(f_got.valid), n(f_want.valid))
    assert n(f_got.valid).sum() < n(got.valid).sum()
    with pytest.raises(ValueError):
        dec.apply_dual_return_filter(got, "middle")


@pytest.mark.parametrize("opts", [
    {"points_skip": 2},
    {"crop_region": (-10.0, 10.0, -8.0, 12.0, -2.0, 3.0)},
    {"crop_region": (-10.0, 10.0, -8.0, 12.0, -2.0, 3.0),
     "crop_inside": True, "points_skip": 1},
])
def test_decode_options_match_jax(opts):
    """points_skip and the crop region (kept, or dropped with
    crop_inside) select the same points as the JAX decode."""
    seq = sim.generate_sequence(duration_s=0.05, model="hdl32", seed=1,
                                world=sim.World.demo(3))
    pkts = seq["packets"]
    want = jdec.decode_packets(jnp.asarray(pkts), jdec.DeviceCalib.from_host(
        jcal.hdl32()), model="hdl32", **opts)
    got = dec.decode_packets(t(pkts), dec.DeviceCalib.from_host(
        cal.hdl32(), device="cpu"), model="hdl32", **opts)
    _check_decoded(got, want)
    plain = dec.decode_packets(t(pkts), dec.DeviceCalib.from_host(
        cal.hdl32(), device="cpu"), model="hdl32")
    assert 0 < n(got.valid).sum() < n(plain.valid).sum()


def test_per_packet_compensation_matches_jax():
    """compensate(per_packet=True): one INS pose per packet, at its
    stamp, for all its blocks."""
    seq = jsim.generate_sequence(duration_s=0.1, model="hdl32", seed=2,
                                 world=jsim.World.demo(6))
    got, want = _both(seq["packets"], "hdl32")
    anchor = int(seq["pkt_times_us"][0])
    rel = ((seq["pkt_times_us"] - anchor) * 1e-6).astype(np.float32)
    track = sim.truth_track(seq, drift_rate=0.5).window(
        anchor, int(seq["pkt_times_us"][-1]), anchor_us=anchor)
    trk = [track[k] for k in ("rel_s", "q", "t", "v")]
    xyz_g, poses_g = dec.compensate(got, t(rel), *(t(a) for a in trk),
                                    per_packet=True)
    xyz_w, poses_w = jdec.compensate(want, jnp.asarray(rel),
                                     *(jnp.asarray(a) for a in trk),
                                     per_packet=True)
    assert tuple(poses_g.q.shape) == (len(rel), 12, 4)
    np.testing.assert_allclose(n(poses_g.q), n(poses_w.q), atol=1e-6)
    np.testing.assert_allclose(n(poses_g.t), n(poses_w.t), atol=1e-5)
    np.testing.assert_allclose(n(xyz_g), n(xyz_w), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(n(poses_g.t)[:, 0], n(poses_g.t)[:, 11])
