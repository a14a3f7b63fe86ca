"""Parity of the port's other StreamingOdometry paths with the JAX
package: the fused step, the chained steps, and the batched step without
frame sampling or without the dilated index (the exact binary-search
lookup), with their pieces (the histogram subsample, the lean assembly).

Small sizes keep the JAX compiles short: 2048 registration points, an
8192-row map, 2 frame slots, 128-packet batches of a dense world with
the INS drifting 0.3 m/s, so registration output is accepted.  Each step
starts from one mid-drive state made by the JAX package and carried into
the port with `convert`.  Tolerances: the subsample's indices and mask,
frame counts, times, map keys and carried counters exact; poses within
1e-4 m and 1e-5 in the quaternion (float32 sums in another order;
measured ~1e-6 m); map counts within 1e-5 relative; the carried open
frame's points within 1e-4 m (each package's own compensated decode)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_odometry import _jtrack
from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode import decode as jdec
from veloslam_tpu.decode import frames as jfr
from veloslam_tpu.runtime import fullslam as jfs
from veloslam_tpu.runtime import odometry as jodo
from veloslam_tpu_torch import convert
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode import decode as dec
from veloslam_tpu_torch.decode import frames as fr
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime import fullslam as fs
from veloslam_tpu_torch.runtime import odometry as odo

KW = dict(reg_points=2048, map_capacity=8192)
BATCH = 128
SLOTS = 2
WARM = 8          # batches the JAX package streams before the shared state


@pytest.fixture(scope="module")
def drive():
    seq = sim.generate_sequence(
        duration_s=1.0, model="hdl32", seed=23,
        world=sim.World.demo(seed=8, extent=40.0, n_posts=60, n_walls=24))
    return seq, _jtrack(seq)


def _batch(drive, i):
    seq, track = drive
    s = slice(i * BATCH, (i + 1) * BATCH)
    pkts, times = seq["packets"][s], seq["pkt_times_us"][s]
    w = track.window(int(times[0]), int(times[-1]), anchor_us=int(times[0]))
    return pkts, times, w


def _engines(**flags):
    jo = jodo.StreamingOdometry(jdec.DeviceCalib.from_host(jcal.hdl32()),
                                **KW, **flags)
    po = odo.StreamingOdometry(DeviceCalib.from_host(cal.hdl32(),
                                                     device="cpu"),
                               **KW, **flags)
    jo.MAX_FRAMES_BATCH = po.MAX_FRAMES_BATCH = SLOTS
    return jo, po


def _numpy_tree(x):
    return type(x)(*(_numpy_tree(y) if isinstance(y, tuple)
                     else np.asarray(y) for y in x))


def _share(jo, po):
    """The JAX engine's state and time anchors, carried into the port."""
    po.state = convert.odometry_state_from_numpy(_numpy_tree(jo.state),
                                                 "cpu")
    po._stream_t0_us = jo._stream_t0_us
    po._open_anchor = jo._open_anchor
    po._open_start_dev = t(np.asarray(jo._open_start_dev))


def _check_states(ps, js):
    nf = int(js.n_frames)
    assert int(ps.n_frames) == nf > 0
    np.testing.assert_array_equal(ps.traj_time, n(js.traj_time))
    np.testing.assert_allclose(ps.traj_t[:nf], n(js.traj_t)[:nf], atol=1e-4)
    np.testing.assert_allclose(ps.traj_q[:nf], n(js.traj_q)[:nf], atol=1e-5)
    np.testing.assert_allclose(ps.corr_t, n(js.corr_t), atol=1e-4)
    np.testing.assert_array_equal(ps.min_dense_cov, n(js.min_dense_cov))
    np.testing.assert_array_equal(ps.map_grid.keys, n(js.map_grid.keys))
    np.testing.assert_allclose(ps.map_grid.count, n(js.map_grid.count),
                               rtol=1e-5)
    np.testing.assert_allclose(ps.carry.xyz, n(js.carry.xyz), atol=1e-4)
    for f in ps.carry._fields:
        if f != "xyz":
            np.testing.assert_array_equal(getattr(ps.carry, f),
                                          n(getattr(js.carry, f)),
                                          err_msg=f)


@pytest.mark.parametrize("n_out", [2048, 1000, 8192])
def test_subsample_matches_jax(n_out):
    """The same points in the same output slots, and every power-of-two
    prefix of a power-of-two output spread over the whole frame."""
    rng = np.random.default_rng(n_out)
    L, Fm = 32, 160
    flat = np.arange(L * Fm, dtype=np.float32).reshape(L, Fm)
    xyz = np.stack([flat, rng.normal(size=(L, Fm)),
                    rng.normal(size=(L, Fm))], -1).astype(np.float32)
    m = rng.random((SLOTS, L, Fm)) < 0.7
    xyz = np.broadcast_to(xyz, (SLOTS, L, Fm, 3)).copy()
    got = odo._subsample(t(xyz), t(m), n_out)
    for s in range(SLOTS):
        want = jodo._subsample(jnp.asarray(xyz[s]), jnp.asarray(m[s]), n_out)
        np.testing.assert_array_equal(n(got[1][s]), n(want[1]))
        np.testing.assert_array_equal(n(got[0][s]), n(want[0]))
    if n_out & (n_out - 1) == 0 and n_out <= m[0].sum():
        src = n(got[0][0])[:, 0]              # the flat source index
        for k in (256, 512, n_out):
            counts = np.histogram(src[:k], bins=8, range=(0, L * Fm))[0]
            assert counts.min() > 0.5 * k / 8 and \
                counts.max() < 1.5 * k / 8, (k, counts)


def test_assemble_frames_lean_matches_jax(drive):
    """lean=True: xyz and mask as the full assembly, intensity, rel_s and
    azimuth zero in the frames and in the carried open frame, in both
    packages, over consecutive batches."""
    seq, track = drive
    jcalib = jdec.DeviceCalib.from_host(jcal.hdl32())
    jcarry = jfr.AssemblyCarry.init(32)
    carry = fr.AssemblyCarry.init(32, device="cpu")
    open_abs = None
    for b in range(3):
        pkts, times, w = _batch(drive, b)
        anchor = int(times[0])
        rel = ((times - anchor) * 1e-6).astype(np.float32)
        cs = np.float32(0.0 if open_abs is None
                        else (open_abs - anchor) * 1e-6)
        jd = jdec.decode_packets(jnp.asarray(pkts), jcalib, model="hdl32")
        jxyz, _ = jdec.compensate(jd, jnp.asarray(rel),
                                  *(jnp.asarray(w[k])
                                    for k in ("rel_s", "q", "t", "v")))
        d = dec.DecodedBatch(*(t(x) for x in jd))
        jfb, jn, jstarts, jcarry, jopen = jfr.assemble_frames(
            jd, jxyz, jnp.asarray(rel), jcarry, jnp.asarray(cs),
            model="hdl32", n_beams=32, max_frames=SLOTS, lean=True)
        fb, nc, starts, carry, open_t = fr.assemble_frames(
            d, t(jxyz), t(rel), carry, t(cs), model="hdl32", n_beams=32,
            max_frames=SLOTS, lean=True)
        assert int(nc) == int(jn)
        np.testing.assert_array_equal(n(starts), n(jstarts))
        np.testing.assert_array_equal(n(fb.mask), n(jfb.mask))
        np.testing.assert_allclose(n(fb.xyz), n(jfb.xyz), atol=1e-5)
        for f in ("intensity", "rel_s", "azimuth"):
            for x in (getattr(fb, f), getattr(carry, f)):
                assert not n(x).any(), f
            assert not n(getattr(jfb, f)).any()
        for f in ("mask", "n_firings", "last_azimuth"):
            np.testing.assert_array_equal(n(getattr(carry, f)),
                                          n(getattr(jcarry, f)))
        open_abs = anchor + float(n(open_t)) * 1e6


def _warm_jax(drive, **flags):
    jo, po = _engines(**flags)
    for i in range(WARM):
        pkts, times, w = _batch(drive, i)
        jo.feed(jnp.asarray(pkts), times, w)
    assert int(jo.state.n_frames) >= 3 and bool(jo.state.have_map)
    _share(jo, po)
    return jo, po


@pytest.mark.parametrize("flags", [
    {}, {"fused": False},
    {"batched": True, "sample_assembly": False},
    {"batched": True, "sample_assembly": True}],
    ids=["fused", "chained", "batched_assembly", "batched_sampled"])
def test_step_from_shared_mid_drive_state(drive, flags):
    """Two more batches from the JAX package's mid-drive state through
    each path: the fused step (the JAX default), the chained steps, and
    the batched step with the exact binary-search lookup
    (use_dense=False), with and without frame sampling."""
    jo, po = _warm_jax(drive, **flags)
    for i in (WARM, WARM + 1):
        pkts, times, w = _batch(drive, i)
        jo.feed(jnp.asarray(pkts), times, w)
        po.feed(pkts, times, w)
    _check_states(convert.odometry_state_to_numpy(po.state), jo.state)


def test_chained_equals_fused_only_at_the_defaults(drive):
    """The chained path passes neither reassociate_every nor map_decay on
    (as in the JAX package), so it equals the fused path to the bit at
    the defaults, and with reassociate_every=8 only the fused path
    changes; the JAX chained path at reassociate_every=8 agrees."""
    runs = {}
    for name, flags in (("fused", {}), ("chained", {"fused": False}),
                        ("fused8", {"reassociate_every": 8}),
                        ("chained8", {"fused": False,
                                      "reassociate_every": 8})):
        _, po = _engines(**flags)
        for i in range(6):
            pkts, times, w = _batch(drive, i)
            po.feed(pkts, times, w)
        runs[name] = convert.odometry_state_to_numpy(po.state)
    for a, b in (("fused", "chained"), ("chained", "chained8")):
        for x, y in zip(runs[a], runs[b]):
            for u, v in zip(*((x, y) if isinstance(x, tuple)
                              else ([x], [y]))):
                np.testing.assert_array_equal(u, v)
    assert not np.array_equal(runs["fused"].traj_t, runs["fused8"].traj_t)
    jo, _ = _engines(fused=False, reassociate_every=8)
    for i in range(6):
        pkts, times, w = _batch(drive, i)
        jo.feed(jnp.asarray(pkts), times, w)
    nf = int(jo.state.n_frames)
    np.testing.assert_allclose(runs["chained8"].traj_t[:nf],
                               n(jo.state.traj_t)[:nf], atol=1e-4)


def test_constructors_take_the_jax_flags_and_defaults():
    """StreamingOdometry and FullSlam take the JAX package's flags with its
    defaults, and a constructor with no flags picks the same path: fused
    with the assembly carry for StreamingOdometry, batched with frame
    sampling and no dense index for FullSlam."""
    for port, ref in ((odo.StreamingOdometry, jodo.StreamingOdometry),
                      (fs.FullSlam, jfs.FullSlam)):
        want = {k: p.default for k, p in
                inspect.signature(ref.__init__).parameters.items()}
        got = {k: p.default for k, p in
               inspect.signature(port.__init__).parameters.items()}
        assert got == want, port
    jcalib = jdec.DeviceCalib.from_host(jcal.hdl32())
    pcalib = DeviceCalib.from_host(cal.hdl32(), device="cpu")
    for port, ref in ((odo.StreamingOdometry(pcalib, **KW),
                       jodo.StreamingOdometry(jcalib, **KW)),
                      (fs.FullSlam(pcalib, **KW), jfs.FullSlam(jcalib, **KW))):
        for f in ("fused", "batched", "use_pallas", "use_dense",
                  "sample_assembly", "n_beams", "reassociate_every"):
            assert getattr(port, f) == getattr(ref, f), f
        assert type(port.state.carry).__name__ == \
            type(ref.state.carry).__name__
        assert port.state.carry._fields == ref.state.carry._fields


def test_convert_round_trip_with_assembly_carry():
    st = odo.init_state(device="cpu", map_capacity=64, max_frames=8)
    assert isinstance(st.carry, fr.AssemblyCarry)
    back = convert.odometry_state_from_numpy(
        convert.odometry_state_to_numpy(st), "cpu")
    assert isinstance(back.carry, fr.AssemblyCarry)
    for a, b in zip(st, back):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ([a], [b]))):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
