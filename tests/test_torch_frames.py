"""Parity of the port's gather-based frame sampling with the JAX package
over consecutive batches, the open-frame carry threaded through each.

Both sides sample the same decoded, compensated batches (made by the JAX
package and handed to the port as tensors), so everything is exact: the
selection law (stable (slot | hash) sort, int64-masked uint32 hash), the
frame counts, starts, masks, selected points and the carry."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, small_threads, t  # noqa: F401
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode import decode as jdec
from veloslam_tpu.decode import frames as jfr
from veloslam_tpu.io import simulate as jsim
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
