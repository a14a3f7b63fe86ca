"""The metric arithmetic on a canned trace: busy time, idle share,
launches, the longest idle gaps, kernel time, and the NE roofline's
count at a small shape against a hand count."""

import types

import pytest
import torch

from slambench.lib import counts, peaks, registry
from slambench.lib import trace as tr

MS = 1_000_000      # ns


def canned():
    # Window 0-100 ms.  Device: two overlapping kernels 10-30 and
    # 20-40 ms, a copy 50-55, an NE kernel 70-80, one kernel outside.
    device = [("kernel", "k_a", 10 * MS, 30 * MS),
              ("kernel", "k_b", 20 * MS, 40 * MS),
              ("gpu_memcpy", "Memcpy HtoD", 50 * MS, 55 * MS),
              ("kernel",
               "void (anonymous namespace)::ne_kernel<4>(float const*)",
               70 * MS, 80 * MS),
              ("kernel", "k_late", 150 * MS, 160 * MS),
              ("cuda_runtime", "cudaLaunchKernel", 0, 1 * MS)]
    ann = [("slambench.window", 0, 100 * MS),
           ("slambench.pass", 0, 100 * MS),
           ("slambench.inputs", 40 * MS, 50 * MS),
           ("slambench.feed", 55 * MS, 100 * MS)]
    return tr.from_events(device, ann)


def test_busy_idle_and_launches():
    t = canned()
    assert t.w0 == 0 and t.w1 == 100 * MS
    assert tr.window_s(t) == pytest.approx(0.1)
    # union: 10-40 (30) + 50-55 (5) + 70-80 (10) = 45 ms
    assert tr.busy_s(t) == pytest.approx(0.045)
    assert tr.idle_share(t) == pytest.approx(0.55)
    assert tr.launches(t) == 3            # the copy and the late one not
    s, n = tr.kernel_seconds(t, "::ne_kernel<")
    assert (s, n) == (pytest.approx(0.010), 1)


def test_idle_gaps_named_by_the_host_span():
    gaps = tr.idle_gaps(canned())
    # gaps: 0-10 (pass), 40-50 (inputs), 55-70 (feed), 80-100 (feed)
    assert gaps[0] == ["feed", pytest.approx(0.020)]
    assert gaps[1] == ["feed", pytest.approx(0.015)]
    assert sorted(g[1] for g in gaps) == pytest.approx(
        [0.010, 0.010, 0.015, 0.020])
    assert {g[0] for g in gaps} == {"pass", "inputs", "feed"}


def test_device_ops_sum_by_name():
    ops = tr.device_ops(canned())
    assert ops[0] == ["k_a", pytest.approx(0.020)]
    assert {o[0] for o in ops} == {"k_a", "k_b", "Memcpy HtoD",
                                   "void (anonymous namespace)::ne_kernel<4>"
                                   "(float const*)"}


def test_ne_count_by_hand():
    # F = 2 slots of P = 8 points, 5 hits: flags 16 B, hits 5 x 36 B,
    # per slot (7 + 36 + 6 + 2 + 1 + 7 + 1) x 4 = 240 B.
    assert counts.ne_bytes(2, 8, 5) == 16 + 180 + 480
    assert counts.ne_flops(5) == 5 * (18 + 8 + 4 + 9 + 63 + 12 + 4)


def test_ne_roofline_reader_on_canned_calls():
    m = registry.metric("kernel.ne_roofline.slam")
    calls = [(2, 8, torch.tensor([2, 3], dtype=torch.int32)),
             (2, 8, torch.tensor([1, 0], dtype=torch.int32))]
    ctx = types.SimpleNamespace(trace=canned(), notes={},
                                probes={"ne": {"calls": calls}})
    b = counts.ne_bytes(2, 8, 5) + counts.ne_bytes(2, 8, 1)
    f = counts.ne_flops(6)
    floor = max(b / peaks.HBM_BYTES_PER_S, f / peaks.FP64_FLOP_PER_S)
    assert m.read(ctx) == pytest.approx(100 * floor / 0.010)
    assert ctx.notes["kernel.ne_roofline.slam"]["kernels"] == 1


def test_idle_share_reader_in_percent():
    m = registry.metric("device.idle_share.slam")
    ctx = types.SimpleNamespace(trace=canned())
    assert m.read(ctx) == pytest.approx(55.0)
    assert m.read(types.SimpleNamespace(trace=None)) is None
