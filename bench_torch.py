"""Benchmarks of the PyTorch port on one CUDA card: bulk odometry
throughput, full SLAM end to end, live ingest, and a roofline of the bulk
batch from the card's own rates.

The port of bench.py (which imports jax and stays as it is), with its
constants, stages, flags and output protocol; it imports torch, numpy and
veloslam_tpu_torch only, and runs on cuda:0 (it raises without a card),
except under --cpu-reference.

1. `hdl32_bulk_odometry_frames_per_s_per_chip` (headline `value`): the
   production bulk-replay odometry step (runtime/odometry.py::
   odometry_step_batched) on a 16384-packet HDL-32 batch (≈90.6
   revolutions): decode, INS motion compensation, frame sampling, 96
   slots × 16384 points × 16 GN iterations of point-to-plane GICP
   against the rolling 65536-row 0.5 m map, the map merge.  Timed from a
   WARM map, the state one step leaves: from bench.py's empty map every
   slot registers against nothing and the health gate discards the
   result, which on the card skips most of the normal-equations work.
   The empty-map time, timed in turns with the warm calls, is kept in
   `extra` as `bulk_ms_from_empty_map`, for comparison with the JAX
   record only.  CUDA events per call; the median of the calls after a
   warm-up, the spread beside it; frames/s = FRAMES_PER_BATCH / median.
2. `full_slam` (in `extra`): SlamPipeline.run_offline_batched + finalize()
   on bench.py's simulated loop drive (20 s by default) with drifting
   INS: keyframes, closures, pose graph, landmarks, tiled map.  Wall time
   of everything after the pcap is written, ending in a device
   synchronize; one ordinary warm run of the same drive first.
3. `live` (in `extra`): apps/replay.py::measure_live_loopback, the
   device stream (fast) over loopback UDP at 1x, 2x and 4x the sensor's
   packet rate.
4. `roofline` (in `extra`): bench.py's byte accounting of the bulk batch
   against the card's published memory rate and against the rates its
   primitives reached in this run (`rates`, primitive_rates()).

Output protocol: the headline JSON line is printed and flushed first,
after the bulk stage; an extended line (same metric and value, a richer
`extra`) is printed last.  The optional stages run under the
--full-budget-s wall-clock guard and are skipped, and say so, once it is
spent (not a failure).  A stage that raises is recorded in `extra`; the
extended line is still printed, and the process then exits 1.

vs_baseline compares the headline with the same bulk step on one CPU
core (torch, one thread, the kernels' plain versions):

    taskset -c 0 python3 bench_torch.py --cpu-reference

recorded in REFERENCE_CPU_FPS with the host CPU and the config signature
it was measured under; vs_baseline is null when the signature differs.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# The port is imported from this checkout, whatever the working directory.
sys.path.insert(0, HERE)

BATCH_PACKETS = 16384    # ≈ 90.6 HDL-32 revolutions per batch
MAX_FRAMES_BATCH = 96
HDL32_PACKETS_PER_SECOND = 1e6 / 46.08 / 12      # ≈ 1808.4
FRAMES_PER_BATCH = BATCH_PACKETS / HDL32_PACKETS_PER_SECOND * 10.0
REG_POINTS = 16384
REG_ITERATIONS = 16
MAP_CAPACITY = 65536         # rolling-map rows (0.5 m voxels)
VOXEL_SIZE = 0.5
REASSOCIATE_EVERY = 8
SAMPLE_ASSEMBLY = True

# Single-CPU-core frames/s of the same bulk step from a warm map (torch on
# the CPU, one thread, the kernels' plain versions), measured with
#   taskset -c 0 python3 bench_torch.py --cpu-reference
# on REFERENCE_CPU_HOST, under the config REFERENCE_CPU_CONFIG; main()
# nulls vs_baseline when the live config no longer matches.
REFERENCE_CPU_FPS = 15.310
REFERENCE_CPU_HOST = "GenuineIntel family 6 model 207"
REFERENCE_CPU_CONFIG = ("pkts16384-slots96-pts16384-iters16-map65536"
                        "-vox0.5-dense-ra8-sampled")

# NVIDIA's H100 SXM data sheet: device-memory bytes/s at 700 W.
HBM_BYTES_PER_S = 3.35e12
FULL_STAGE_MAX_S = 480


def config_signature() -> str:
    samp = "-sampled" if SAMPLE_ASSEMBLY else ""
    return (f"pkts{BATCH_PACKETS}-slots{MAX_FRAMES_BATCH}-pts{REG_POINTS}"
            f"-iters{REG_ITERATIONS}-map{MAP_CAPACITY}-vox{VOXEL_SIZE}"
            f"-dense-ra{REASSOCIATE_EVERY}{samp}")


class Budget:
    """Wall-clock guard for the optional stages: once `spent()` crosses
    the limit, later stages are skipped (and say so in `extra`)."""

    def __init__(self, seconds: float):
        self.limit = seconds
        self.t0 = time.perf_counter()

    def spent(self) -> float:
        return time.perf_counter() - self.t0

    def remaining(self) -> float:
        return self.limit - self.spent()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, device) -> float:
    """Milliseconds of one call of `fn()`: CUDA events on the card, the
    host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def cpu_model() -> str:
    """The host CPU's model, from /proc/cpuinfo: its model name, or where
    the host hides that, its vendor, family and model."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                       # the first processor only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}")


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (for a
    CPU device, the host CPU's model)."""
    if torch.device(device).type != "cuda":
        return {"name": cpu_model(), "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    name, limit = (s.strip() for s in out[index].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _host_inputs(seed=0, batch_packets=BATCH_PACKETS, model="hdl32",
                 calib=None) -> tuple:
    """bench.py's bulk inputs as numpy arrays, from the port's simulator:
    a 0.35 s drive of `model` (simulated with `calib`, else the model's
    built-in table) tiled to `batch_packets` at the model's packet rate,
    and a 64-sample straight-line INS window.  Returns (pkts, rel_s,
    track_rel, track_q, track_t, track_v)."""
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.odometry import packets_per_second

    seq = sim.generate_sequence(duration_s=0.35, model=model, seed=seed,
                                world=sim.World.demo(1), calib=calib)
    pkts = np.concatenate([seq["packets"]] *
                          (batch_packets // len(seq["packets"]) + 1)
                          )[:batch_packets]
    rel_s = (np.arange(batch_packets) / packets_per_second(model)
             ).astype(np.float32)

    m = 64
    track_rel = np.linspace(-0.1, rel_s[-1] + 0.1, m).astype(np.float32)
    track_q = np.zeros((m, 4), np.float32)
    track_q[:, 0] = 1.0
    track_t = np.stack([5.0 * track_rel, np.zeros(m), np.full(m, 2.0)],
                       -1).astype(np.float32)
    track_v = np.tile(np.array([5.0, 0, 0], np.float32), (m, 1))
    return pkts, rel_s, track_rel, track_q, track_t, track_v


def _build_inputs(seed=0, batch_packets=BATCH_PACKETS, device="cuda"):
    """bench.py::_build_inputs on `device`: (pkts, calib, rel_s,
    track_rel, track_q, track_t, track_v), built on the host and uploaded
    once."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib

    pkts, rel_s, *track = (torch.as_tensor(a, device=device) for a in
                           _host_inputs(seed, batch_packets))
    calib = DeviceCalib.from_host(calibration.hdl32(), device=device)
    return (pkts, calib, rel_s, *track)


def _bulk_step(inputs, *, max_frames_batch=MAX_FRAMES_BATCH, use_dense=True,
               reassociate_every=REASSOCIATE_EVERY, reg_points=REG_POINTS,
               reg_iterations=REG_ITERATIONS, map_capacity=MAP_CAPACITY):
    """bench.py's bulk step on `inputs`: returns (step, the empty-map
    state), step(state) -> (new state, open start)."""
    from veloslam_tpu_torch.runtime import odometry as odo

    (pkts, calib, rel_s, track_rel, track_q, track_t, track_v) = inputs
    device = pkts.device
    state = odo.init_state(32, device=device, map_capacity=map_capacity,
                           voxel_size=VOXEL_SIZE,
                           sample_assembly=SAMPLE_ASSEMBLY)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    step = functools.partial(
        odo.odometry_step_batched, model="hdl32", n_beams=32,
        reg_points=reg_points, reg_iterations=reg_iterations,
        max_frames_batch=max_frames_batch, use_pallas=False,
        use_dense=use_dense, reassociate_every=reassociate_every,
        sample_assembly=SAMPLE_ASSEMBLY)

    def once(st):
        return step(st, pkts, calib, rel_s, zero, zero,
                    track_rel, track_q, track_t, track_v)
    return once, state


def run_bulk(iters=21, batch_packets=BATCH_PACKETS, inputs=None,
             device="cuda", empty_map_too=False, **kw) -> dict:
    """The bulk step, each timed call from one fixed state: the map one
    step leaves.  Returns frames/s (FRAMES_PER_BATCH / median), the median
    ms, its spread, every call's ms, and `steps`: the steps run, the map's
    fill and one warm-up call included.  `empty_map_too` also times each
    call from bench.py's empty map, in turns with the warm one (warm,
    empty; empty, warm; ...), as `ms_from_empty_map` and its spread.  `kw`:
    _bulk_step's (the --ab variants, the tests' reduced sizes)."""
    frames_per_batch = batch_packets / HDL32_PACKETS_PER_SECOND * 10.0
    inputs = inputs or _build_inputs(batch_packets=batch_packets,
                                     device=device)
    once, empty = _bulk_step(inputs, **kw)
    warm, _ = once(empty)
    states = {"warm": warm, "empty": empty} if empty_map_too else {
        "warm": warm}
    steps = 1
    for st in states.values():
        once(st)
        steps += 1
    _sync(device)
    runs = {k: [] for k in states}
    for i in range(iters):
        for k in (states if i % 2 == 0 else reversed(states)):
            runs[k].append(_time_ms(lambda: once(states[k]), device))
            steps += 1
    ms = float(np.median(runs["warm"]))
    out = {"frames_per_s": frames_per_batch / (ms * 1e-3), "ms": ms,
           "ms_spread": [min(runs["warm"]), max(runs["warm"])],
           "ms_runs": runs["warm"], "steps": steps}
    if empty_map_too:
        out["ms_from_empty_map"] = float(np.median(runs["empty"]))
        out["ms_from_empty_map_spread"] = [min(runs["empty"]),
                                           max(runs["empty"])]
    return out


def _make_drive(duration_s, seed=3, drift=1.0):
    """Simulated loop drive with drifting INS (closures must fire).
    Radius 8 m at 8 m/s: one lap every ~6.3 s.  Returns (paths, seq); the
    files are in a new temporary directory, the caller's to remove."""
    from veloslam_tpu_torch.io import packets as pkmod
    from veloslam_tpu_torch.io import simulate as sim

    d = tempfile.mkdtemp()
    seq = sim.generate_sequence(
        duration_s=duration_s, model="hdl32", seed=seed,
        world=sim.World.demo(3, extent=40.0, n_posts=40, n_walls=16),
        trajectory=sim.circle_trajectory(radius=8.0, speed=8.0))
    paths = sim.write_sequence(seq, d, name="bench")
    ins = pkmod.read_ins_txt(paths["ins"])
    ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
    pkmod.write_ins_txt(paths["ins"], ins["t_us"],
                        ins["pos_xy"] + np.stack(
                            [np.zeros_like(ts), drift * ts], -1),
                        np.deg2rad(ins["yaw_deg"]), speed=ins["speed"])
    return paths, seq


def _slam_cfg():
    from veloslam_tpu_torch.config import GraphConfig, SlamConfig
    return SlamConfig(graph=GraphConfig(loop_closure_min_gap=12,
                                        sc_min_score=0.55))


def _pipeline_run(paths, batch, device) -> tuple:
    """One user run: a fresh SlamPipeline, run_offline_batched +
    finalize(); returns (pipeline, results, wall s to a device
    synchronize)."""
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

    pipe = SlamPipeline(_slam_cfg(), device=device)
    _sync(device)
    t0 = time.perf_counter()
    pipe.run_offline_batched(paths["pcap"], paths["ins"], batch=batch,
                             defer_map=True)
    res = pipe.finalize()
    _sync(device)
    return pipe, res, time.perf_counter() - t0


def run_full_slam(duration_s=20.0, batch=4096, warm_s=None, device="cuda",
                  check=None) -> dict:
    """End-to-end full SLAM: run_offline_batched + finalize on a loop
    drive, bench.py's result dict.  One ordinary warm run first, of the
    same drive when `warm_s` (default `duration_s`) equals `duration_s`,
    else of a `warm_s` s drive (0: none); then ONE measured run.
    `check(pipe, res, seq)`, when given, is called on the measured run
    after its clock stops."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    if warm_s is None:
        warm_s = duration_s
    if warm_s and warm_s != duration_s:
        paths, _ = _make_drive(warm_s)
        try:
            _pipeline_run(paths, batch, device)
        finally:
            shutil.rmtree(os.path.dirname(paths["pcap"]))
    paths, seq = _make_drive(duration_s)
    try:
        if warm_s == duration_s:
            _pipeline_run(paths, batch, device)
        pipe, res, wall = _pipeline_run(paths, batch, device)
    finally:
        shutil.rmtree(os.path.dirname(paths["pcap"]))
    if check is not None:
        check(pipe, res, seq)
    ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                seq["ins_pos"])
    m = ate(res["positions"][:, :2], ref[:, :2], align=False)
    return {
        "frames_per_s": round(res["n_frames"] / wall, 1),
        "wall_s": round(wall, 3),
        "n_frames": res["n_frames"],
        "n_keyframes": res["n_keyframes"],
        "n_closures": res["n_closures"],
        "map_patches": res["map_patches"],
        "ate_rmse_m": round(m["rmse"], 4),
        "x_realtime": round(res["n_frames"] / wall / 10.0, 2),
        "stage_s": {k: round(v["total_s"], 2)
                    for k, v in sorted(res.get("timing", {}).items())},
    }


def primitive_rates(device="cuda", runs=10, n_sort=BATCH_PACKETS * 12 * 32,
                    n_rows=MAX_FRAMES_BATCH * REG_POINTS,
                    copy_bytes=256 << 20) -> dict:
    """GB/s of payload that the primitives the bulk step's decomposition
    leans on reach on this device, each the median of `runs` timed calls
    after one warm-up, on seeded random data at the bulk shapes:

    * sort: torch.sort(stable=True) of `n_sort` int32 keys with their
      source index (n_cat = 16384·12·32, as sample_frames and the map
      build sort); payload 8 B a pair (key + 32-bit value), bench.py's
      accounting;
    * segment_sum: core/segment.py::segment_sum_sorted of `n_rows` rows ×
      13 float32 channels into MAP_CAPACITY segments; payload the 52 B of
      each row;
    * gather_rows8, gather_i32: the port's kernels (the plain versions on
      a CPU device) at the association's shapes, a 65536 × 8 float32
      table and a 2²¹-key int32 table (the dilated index), `n_rows`
      uniform indices; payload each index read and each output written;
    * stream: a device-to-device copy of `copy_bytes`; payload the bytes
      read and written.
    """
    from veloslam_tpu_torch.core.segment import segment_sum_sorted
    from veloslam_tpu_torch.registration import gather as ga

    gen = torch.Generator(device=device).manual_seed(0)

    def rand_i32(high, n):
        return torch.randint(0, high, (n,), dtype=torch.int32,
                             device=device, generator=gen)

    def rate(payload_bytes, fn):
        fn()
        _sync(device)
        ms = float(np.median([_time_ms(fn, device) for _ in range(runs)]))
        return {"gb_per_s": payload_bytes / (ms * 1e-3) / 1e9, "ms": ms,
                "payload_MB": payload_bytes / 1e6}

    keys = rand_i32(2 ** 31 - 1, n_sort)
    out = {"sort": rate(n_sort * 8,
                        lambda: torch.sort(keys, stable=True))}
    del keys
    ids = torch.sort(rand_i32(MAP_CAPACITY, n_rows)).values[None]
    data = torch.rand((1, n_rows, 13), device=device, generator=gen)
    out["segment_sum"] = rate(
        n_rows * 52, lambda: segment_sum_sorted(data, ids, MAP_CAPACITY))
    del ids, data
    idx = rand_i32(MAP_CAPACITY, n_rows)
    rows = torch.rand((MAP_CAPACITY, 8), device=device, generator=gen)
    out["gather_rows8"] = rate(n_rows * (4 + 32),
                               lambda: ga.gather_rows8(rows, idx))
    idx = rand_i32(1 << 21, n_rows)
    table = rand_i32(2 ** 31 - 1, 1 << 21)
    out["gather_i32"] = rate(n_rows * (4 + 4),
                             lambda: ga.gather_i32(table, idx))
    del idx, table, rows
    src = torch.empty(copy_bytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    src.fill_(1.0)
    out["stream"] = rate(2 * copy_bytes, lambda: dst.copy_(src))
    return out


def run_roofline(bulk_ms: float, rates: dict, device=None) -> dict:
    """Achieved against ceiling for the measured bulk batch: how far is
    the 16384-packet batch from this card's speed of light, and which?

    * `hbm_floor_ms`: every byte the algorithm must move, at the card's
      published 3.35 TB/s (H100 SXM at 700 W; `device` names the card
      and its power limit).
    * `primitive_floor_ms`: the same bytes at the rates the primitives
      reached on this card in this run (`rates`, primitive_rates()):
      decode, compensation and the GN stream at the copy's rate, the
      selection sort and the map sort's keys at the pair sort's, the map
      moments at the sorted segment sum's, the rank gathers at
      gather_rows8's and the association at gather_i32's.

    Byte accounting, bench.py's term for term (per batch: N = 16384
    packets, Ncat = N·12·32 ≈ 6.3M decoded points, Psel = 96·16384 ≈
    1.57M selected points, I = 16 GN iterations, V = 65536 map rows):
      decode        : N·1206 B packets read + Ncat·24 B xyz/aux written
      compensate    : Ncat·24 B read + written
      select (sort) : Ncat·8 B (key, src) pair-sort payload
                      + rank gathers Psel·16 B
      gicp          : per iteration Psel·64 B (query, voxel statistics,
                      residual); I iterations, + I/8 re-associations of
                      Psel·24 B
      map update    : Psel·(13 ch·4 B + 8 B) moments, sorted and summed
    Every fraction must be ≤ 1.05: a floor the measured time beats is a
    counting error, and raises."""
    MB = 1e6
    n_cat = BATCH_PACKETS * 12 * 32
    p_sel = MAX_FRAMES_BATCH * REG_POINTS
    it = REG_ITERATIONS
    decode_b = (BATCH_PACKETS * 1206 + n_cat * 24)
    comp_b = n_cat * 24 * 2
    sort_b = n_cat * 8
    rankg_b = p_sel * 16
    gicp_stream_b = p_sel * 64 * it
    assoc_b = p_sel * 24 * max(it // REASSOCIATE_EVERY, 1)
    map_sort_b = p_sel * (13 * 4 + 8)
    total_b = (decode_b + comp_b + sort_b + rankg_b + gicp_stream_b
               + assoc_b + map_sort_b)

    def ms(nbytes, name):
        return nbytes / (rates[name]["gb_per_s"] * 1e9) * 1e3

    hbm_floor_ms = total_b / HBM_BYTES_PER_S * 1e3
    terms = {
        "stream": ms(decode_b + comp_b + gicp_stream_b, "stream"),
        "sort": ms(sort_b + p_sel * 8, "sort"),
        "segment_sum": ms(p_sel * 13 * 4, "segment_sum"),
        "gather_rows8": ms(rankg_b, "gather_rows8"),
        "gather_i32": ms(assoc_b, "gather_i32"),
    }
    prim_floor_ms = sum(terms.values())
    fractions = {"fraction_of_primitive_floor": prim_floor_ms / bulk_ms,
                 "fraction_of_hbm_floor": hbm_floor_ms / bulk_ms}
    bad = {k: v for k, v in fractions.items() if not v <= 1.05}
    if bad:
        raise AssertionError(f"roofline: the measured {bulk_ms:.3f} ms beats "
                             f"a floor, {bad}: a counting error")
    top = max(terms, key=terms.get)
    card = ("" if device is None else
            f" (this card: {device['name']}, {device['power_limit']})")
    bound = "primitive" if prim_floor_ms >= hbm_floor_ms else "HBM"
    return {
        "measured_bulk_ms": round(bulk_ms, 3),
        "bytes_per_batch_MB": round(total_b / MB, 1),
        "hbm_floor_ms": round(hbm_floor_ms, 3),
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "primitive_floor_ms": round(prim_floor_ms, 3),
        "primitive_floor_terms_ms": {k: round(v, 3)
                                     for k, v in terms.items()},
        **{k: round(v, 3) for k, v in fractions.items()},
        "conclusion": (
            "The batch moves ~{:.0f} MB: {:.2f} ms at the H100 SXM's "
            "published {:.2f} TB/s at 700 W{}. At the rates this card's "
            "primitives reached in this run it takes {:.2f} ms, the {} "
            "term the largest ({:.2f} ms), so the {} floor bounds the "
            "batch. Measured {:.2f} ms = {:.0%} of the primitive floor, "
            "{:.0%} of the HBM floor: {:.2f} ms of each batch is spent "
            "outside the bytes these terms count."
        ).format(total_b / MB, hbm_floor_ms, HBM_BYTES_PER_S / 1e12, card,
                 prim_floor_ms, top, terms[top], bound, bulk_ms,
                 prim_floor_ms / bulk_ms, hbm_floor_ms / bulk_ms,
                 bulk_ms - max(prim_floor_ms, hbm_floor_ms)),
    }


def run_live(duration_s=5.0, rate=1.0, device="cuda") -> dict:
    """Live ingest on this machine: loopback-replay a simulated drive
    through run_online (the device stream, warm) at `rate`x the sensor's
    packet rate; sustained pkt/s, drops, lost, batch feed time."""
    from veloslam_tpu_torch.apps.replay import measure_live_loopback
    r = measure_live_loopback(duration_s=duration_s, rate=rate, fast=True,
                              warm=True, device=device)
    return {k: v for k, v in r.items() if k not in ("times_us", "positions")}


def run_live_sweep(budget, duration_s=5.0, rates=(1.0, 2.0, 4.0),
                   device="cuda") -> list:
    """Live headroom: 1x, 2x, 4x loopback runs until the stage budget is
    spent; a rate that raises is recorded with its error."""
    out = []
    for rate in rates:
        if budget.remaining() <= 0:
            out.append({"rate_x_sensor": rate, "skipped": "budget spent"})
            continue
        try:
            out.append(run_live(duration_s=duration_s, rate=rate,
                                device=device))
        except Exception as e:
            out.append({"rate_x_sensor": rate, "error": f"{e}"[:200]})
    return out


def headline(fps: float, extra: dict) -> dict:
    """The result record: the bulk metric, vs_baseline against the CPU
    reference when its config signature still matches."""
    vs = (round(fps / REFERENCE_CPU_FPS, 3)
          if REFERENCE_CPU_FPS and config_signature() == REFERENCE_CPU_CONFIG
          else None)
    return {"metric": "hdl32_bulk_odometry_frames_per_s_per_chip",
            "value": round(fps, 3), "unit": "frames/s", "vs_baseline": vs,
            "extra": extra}


def _failed(x) -> bool:
    """Whether a stage's record holds an error."""
    if isinstance(x, str):
        return x.startswith("error")
    if isinstance(x, dict):
        return "error" in x or any(_failed(v) for v in x.values())
    if isinstance(x, list):
        return any(_failed(v) for v in x)
    return False


def cpu_reference() -> int:
    """The single-core CPU reference: the bulk step from a warm map, one
    thread, the kernels' plain versions."""
    torch.set_num_threads(1)
    r = run_bulk(iters=3, device="cpu")
    print(f"# cpu reference: {r['frames_per_s']:.3f} frames/s "
          f"({r['ms']:.1f} ms/batch, spread {r['ms_spread'][0]:.1f}-"
          f"{r['ms_spread'][1]:.1f}) config={config_signature()} "
          f"host={cpu_model()!r} threads={torch.get_num_threads()} "
          f"affinity={sorted(os.sched_getaffinity(0))}", flush=True)
    return 0


def main(argv=None, device="cuda:0") -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cpu-reference", action="store_true",
                    help="measure the single-core CPU reference number")
    ap.add_argument("--skip-full", action="store_true",
                    help="no full-SLAM stage")
    ap.add_argument("--ab", action="store_true",
                    help="also time the bulk step with the binary-search "
                         "lookup and with re-association every iteration")
    ap.add_argument("--live", action="store_true", default=True,
                    help="measure live loopback ingest (default on; "
                         "--no-live disables)")
    ap.add_argument("--no-live", dest="live", action="store_false")
    # 20 s ≈ 3.2 laps: the finalize (closure verification, graph solve,
    # map build) is a fixed cost and the stream a marginal one per second,
    # so a short drive measures mostly the former; stage_s keeps the split.
    ap.add_argument("--full-duration-s", type=float, default=20.0)
    ap.add_argument("--full-budget-s", type=float, default=600.0,
                    help="wall-clock budget for the optional stages; "
                         "stages are skipped once it is spent")
    args = ap.parse_args(argv)
    if args.cpu_reference:
        return cpu_reference()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py runs on a CUDA card and "
                           "torch.cuda.is_available() is False; "
                           "--cpu-reference measures the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_info(device)
    inputs = _build_inputs(device=device)
    bulk = run_bulk(inputs=inputs, device=device, empty_map_too=True)
    extra = {"bulk_ms_per_batch": round(bulk["ms"], 3),
             "bulk_ms_spread": [round(v, 3) for v in bulk["ms_spread"]],
             "bulk_timed_calls": len(bulk["ms_runs"]),
             # bench.py's definition, in turns with the warm calls: for
             # comparison with the JAX record only.
             "bulk_ms_from_empty_map": round(bulk["ms_from_empty_map"], 3),
             "bulk_ms_from_empty_map_spread": [
                 round(v, 3) for v in bulk["ms_from_empty_map_spread"]],
             "config": config_signature(), "device": card,
             "cpu_reference": {"frames_per_s": REFERENCE_CPU_FPS,
                               "host": REFERENCE_CPU_HOST,
                               "config": REFERENCE_CPU_CONFIG}}
    try:
        rates = primitive_rates(device)
        extra["rates"] = {k: {kk: round(vv, 3) for kk, vv in v.items()}
                          for k, v in rates.items()}
        extra["roofline"] = run_roofline(bulk["ms"], rates, card)
    except Exception as e:
        extra["roofline"] = f"error: {e}"[:300]
    extra["scaling_note"] = (
        "one card: no scaling across cards is measured here; the "
        "multi-device slice (veloslam_tpu_torch/parallel/) runs its "
        "collectives with ranks sharing this card in chip_smoke.py's "
        "phase multichip, which checks them but cannot show scaling")
    result = headline(bulk["frames_per_s"], extra)
    # Headline line FIRST: a later-stage timeout can never erase it.
    print(json.dumps(result), flush=True)
    print(f"# bulk odometry ({BATCH_PACKETS} pkts = {FRAMES_PER_BATCH:.1f} "
          f"frames, {MAX_FRAMES_BATCH} reg slots x {REG_POINTS} pts x "
          f"{REG_ITERATIONS} GN iters, warm map): {bulk['ms']:.3f} ms/batch "
          f"(median of {len(bulk['ms_runs'])}, spread "
          f"{bulk['ms_spread'][0]:.3f}-{bulk['ms_spread'][1]:.3f}); "
          f"{card['name']}, {card['power_limit']}", file=sys.stderr,
          flush=True)
    if result["vs_baseline"] is None:
        print("# vs_baseline null: no CPU reference for this bulk config — "
              "run --cpu-reference", file=sys.stderr)

    budget = Budget(args.full_budget_s)

    if args.ab:
        extra["ab"] = {"dense_ra8_ms": round(bulk["ms"], 3)}
        for key, kw in (("searchsorted_ra8_ms", dict(use_dense=False)),
                        ("dense_ra1_ms", dict(reassociate_every=1))):
            try:
                r = run_bulk(iters=5, inputs=inputs, device=device, **kw)
                extra["ab"][key] = round(r["ms"], 3)
            except Exception as e:
                extra["ab"][key] = f"error: {e}"[:200]

    if not args.skip_full:
        if budget.remaining() > 0:
            # A SIGALRM raise inside the stage still reaches the extended
            # line below (recorded as a timeout).
            def _alarm(signum, frame):
                raise TimeoutError(
                    "full-slam stage exceeded its sub-budget (min of "
                    f"remaining and {FULL_STAGE_MAX_S} s of --full-budget-s "
                    f"{args.full_budget_s:.0f})")

            old = signal.signal(signal.SIGALRM, _alarm)
            # Sub-budget: leave the live sweep its share.
            signal.alarm(max(min(int(budget.remaining()), FULL_STAGE_MAX_S),
                             1))
            try:
                fs = run_full_slam(duration_s=args.full_duration_s,
                                   device=device)
                extra["full_slam"] = fs
                extra["full_slam_frames_per_s"] = fs["frames_per_s"]
                print(f"# full SLAM (keyframes+closures+graph+map): "
                      f"{fs['frames_per_s']} frames/s = {fs['x_realtime']}x "
                      f"realtime, ATE {fs['ate_rmse_m']} m, "
                      f"{fs['n_closures']} closures", file=sys.stderr,
                      flush=True)
            except Exception as e:
                extra["full_slam"] = f"error: {e}"[:300]
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        else:
            extra["full_slam"] = "skipped: budget spent"

    if args.live:
        if budget.remaining() > 0:
            try:
                extra["live"] = run_live_sweep(budget, device=device)
            except Exception as e:
                extra["live"] = f"error: {e}"[:300]
        else:
            extra["live"] = "skipped: budget spent"

    # Extended line LAST: same metric and value.
    result["extra"] = extra
    print(json.dumps(result), flush=True)
    failed = [k for k, v in extra.items() if _failed(v)]
    if failed:
        print(f"# failed stages: {failed}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
