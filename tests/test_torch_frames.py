"""Parity of the port's frame assembly (assemble_frames, the per-frame
pipeline) and gather-based frame sampling (sample_frames, the bulk path)
with the JAX package over consecutive batches, the open-frame carry
threaded through each.

Both sides take the same decoded, compensated batches (made by the JAX
package and handed to the port as tensors).  Sampling is exact: the
selection law (stable (slot | hash) sort, int64-masked uint32 hash), the
frame counts, starts, masks, selected points and the carry.  Assembly:
the completed counts, starts, masks, point counts and the carry's counters
exact; xyz, intensity, rel_s and azimuth within 1e-5 (the same values
moved by one scatter; the frame-relative times are float32 differences
taken in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode import decode as jdec
from veloslam_tpu.decode import frames as jfr
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.decode import decode as dec
from veloslam_tpu_torch.decode import frames as fr
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime.odometry import packets_per_second

BATCH = 160
POINTS = 1024
SLOTS = 4


def test_hash_matches_uint32_arithmetic():
    flat = np.array([0, 1, 2, 12345, 70399, 140799, 2**31 - 1], np.int64)
    want = ((flat.astype(np.uint64) * 2654435761) % 2**32) >> 16
    np.testing.assert_array_equal(n(fr.hash16(t(flat, np.int32))), want)


@pytest.mark.parametrize("model", ["hdl32", "vlp16"])
def test_sample_frames_three_batches_match_jax(model):
    seq = jsim.generate_sequence(
        duration_s=3 * BATCH / packets_per_second(model) + 0.01,
        model=model, seed=5, world=jsim.World.demo(6))
    calib = jdec.DeviceCalib.from_host(jcal.default_for(model))
    track_np = sim.truth_track(seq)
    jcarry = jfr.SampleCarry.init()
    carry = fr.SampleCarry.init(device="cpu")
    jopen = jnp.asarray(0.0, jnp.float32)
    open_t = t(0.0, np.float32)
    prev_anchor = None
    completed = 0
    for b in range(3):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        pkts, times = seq["packets"][sl], seq["pkt_times_us"][sl]
        anchor = int(times[0])
        w = track_np.window(anchor, int(times[-1]), anchor_us=anchor)
        trk = [w[k] for k in ("rel_s", "q", "t", "v")]
        rel = ((times - anchor) * 1e-6).astype(np.float32)
        shift = np.float32(0.0 if prev_anchor is None
                           else (prev_anchor - anchor) * 1e-6)
        jd = jdec.decode_packets(jnp.asarray(pkts), calib, model=model)
        jxyz, _ = jdec.compensate(jd, jnp.asarray(rel),
                                  *(jnp.asarray(a) for a in trk))
        d = dec.DecodedBatch(*(t(x) for x in jd))
        want = jfr.sample_frames(jd, jxyz, jnp.asarray(rel), jcarry,
                                 jopen + shift, model=model,
                                 max_frames=SLOTS, points_per_frame=POINTS)
        got = fr.sample_frames(d, t(jxyz), t(rel), carry, open_t + shift,
                               model=model, max_frames=SLOTS,
                               points_per_frame=POINTS)
        (jsf, jn, jstarts, jcarry, jopen) = want
        (sf, nc, starts, carry, open_t) = got
        assert int(nc) == int(jn)
        completed += int(nc)
        np.testing.assert_array_equal(n(starts), n(jstarts))
        np.testing.assert_array_equal(n(open_t), n(jopen))
        np.testing.assert_array_equal(n(sf.mask), n(jsf.mask))
        m = n(sf.mask)
        np.testing.assert_allclose(n(sf.xyz)[m], n(jsf.xyz)[m], atol=1e-5,
                                   rtol=0)
        for f in fr.SampleCarry._fields:
            np.testing.assert_array_equal(n(getattr(carry, f)),
                                          n(getattr(jcarry, f)), err_msg=f)
        prev_anchor = anchor
    assert completed >= 2          # frames completed, carry was exercised


ASSEMBLE_BATCH = {"hdl32": 160, "vlp16": 160, "hdl64": 320}


@pytest.mark.parametrize("model", ["hdl32", "hdl64", "vlp16"])
def test_assemble_frames_three_batches_match_jax(model):
    B = ASSEMBLE_BATCH[model]
    seq = jsim.generate_sequence(
        duration_s=3 * B / packets_per_second(model) + 0.01,
        model=model, seed=5, world=jsim.World.demo(6))
    jcalib = jdec.DeviceCalib.from_host(jcal.default_for(model))
    L = jcal.default_for(model).n_lasers
    track_np = sim.truth_track(seq, drift_rate=0.3)
    jcarry = jfr.AssemblyCarry.init(L)
    carry = fr.AssemblyCarry.init(L, device="cpu")
    open_abs = None
    completed = 0
    for b in range(3):
        sl = slice(b * B, (b + 1) * B)
        pkts, times = seq["packets"][sl], seq["pkt_times_us"][sl]
        anchor = int(times[0])
        w = track_np.window(anchor, int(times[-1]), anchor_us=anchor)
        trk = [w[k] for k in ("rel_s", "q", "t", "v")]
        rel = ((times - anchor) * 1e-6).astype(np.float32)
        cs = np.float32(0.0 if open_abs is None
                        else (open_abs - anchor) * 1e-6)
        jd = jdec.decode_packets(jnp.asarray(pkts), jcalib, model=model)
        jxyz, _ = jdec.compensate(jd, jnp.asarray(rel),
                                  *(jnp.asarray(a) for a in trk))
        d = dec.DecodedBatch(*(t(x) for x in jd))
        jfb, jn, jstarts, jcarry, jopen = jfr.assemble_frames(
            jd, jxyz, jnp.asarray(rel), jcarry, jnp.asarray(cs),
            model=model, n_beams=L)
        fb, nc, starts, carry, open_t = fr.assemble_frames(
            d, t(jxyz), t(rel), carry, t(cs), model=model, n_beams=L)
        assert int(nc) == int(jn)
        completed += int(nc)
        np.testing.assert_array_equal(n(starts), n(jstarts))
        np.testing.assert_array_equal(n(open_t), n(jopen))
        np.testing.assert_array_equal(n(fb.mask), n(jfb.mask))
        np.testing.assert_array_equal(n(fb.n_points), n(jfb.n_points))
        for f in ("xyz", "intensity", "rel_s", "azimuth"):
            np.testing.assert_allclose(n(getattr(fb, f)),
                                       n(getattr(jfb, f)), atol=1e-5,
                                       rtol=0, err_msg=f)
        for f in ("mask", "n_firings", "last_azimuth"):
            np.testing.assert_array_equal(n(getattr(carry, f)),
                                          n(getattr(jcarry, f)), err_msg=f)
        for f in ("xyz", "intensity", "rel_s", "azimuth"):
            np.testing.assert_allclose(n(getattr(carry, f)),
                                       n(getattr(jcarry, f)), atol=1e-5,
                                       rtol=0, err_msg=f)
        open_abs = anchor + float(n(open_t)) * 1e6
    assert completed >= 2          # frames completed, carry was exercised
    xyz, msk = fr.frame_points(fb.xyz[0], fb.mask[0])
    assert tuple(xyz.shape) == (L * C.MAX_FIRINGS_PER_FRAME, 3)
    assert tuple(msk.shape) == (L * C.MAX_FIRINGS_PER_FRAME,)
