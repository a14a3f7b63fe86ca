"""Drive the PyTorch port's main paths once on one CUDA card: bulk
odometry, device full SLAM with its end-of-stream finalize, and the
user-facing pipeline from pcap to trajectory, landmarks and tiled map.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one printed line each (or more); any failure raises and the exit
code is non-zero:
  1. device   — require CUDA; print the card's name and power limit;
                turn TF32 off for float32 matmuls and convolutions.
  2. build    — compile csrc/normal_equations.cu and csrc/gather.cu with
                nvcc, one process per source, started together.
  3. kernel   — the normal-equations kernel vs its plain torch versions
                at the bulk path's (F, P) = (96, 16384), closure
                verification's (128, 8192), and (3, 1000), (1, 1): NE
                only, and the whole GN step (gn_iteration) with a slot
                rejected for few hits, a clamped slot and a NaN slot;
                bitwise repeatability; times at (96, 16384), 80% and 56%
                hits, and (128, 8192).  The two gather kernels vs their
                plain versions, bitwise, at the Pallas probe's shapes, the
                bulk path's, closure verification's and M = 1000 and 1.
                Every time beside its bound and, for the gathers, the
                library call torch.index_select.
  4. drive    — StreamingOdometry on two simulated 1.2 s HDL-32 drives
                (INS at truth; INS drifting 0.3 m/s) with the production
                registration config, checked against the simulator's truth
                (ATE), against the JAX package's golden trajectories
                (tests/fixtures/odometry_golden_seed23.npz), for one
                normal-equations launch per GN iteration and one launch of
                each gather kernel per association block.
  5. bulk     — one full-width odometry_step_batched (16384 packets,
                96 frame slots) timed from a warm map, launches counted;
                gather_i32 on lookup_dilated's indices of one warm step.
  6. fullslam — FullSlam.run_device + finalize_device on bench.py's
                7 s loop drive (INS drifting 1 m/s) at the production
                width, checked against the JAX package's golden
                (tests/fixtures/fullslam_golden_seed3.npz): frames and
                times, keyframes, candidate pairs, accepted closures,
                corrected trajectory (x, y and z), ATE; launches
                counted; the spread of z across runs; frames/s.
  7. pipeline — the same drive written as a pcap + INS log by the port's
                simulator, through SlamPipeline(device="cuda").
                run_offline_batched(batch=4096, defer_map=True) +
                finalize() (GPS grounding, landmarks, the landmark-Schur
                graph solve, the tiled map) with bench.py's full-SLAM
                config, against the JAX package's golden
                (tests/fixtures/pipeline_golden_seed3.npz): a warm run and
                3 measured runs, each checked (frames and times,
                keyframes, closure pairs, trajectory, landmark counts,
                ATE) with its launches counted; pipeline frames/s as
                bench.py::run_full_slam defines it; then one run that
                synchronizes at each stage's end, for the stage seconds.
Then one JSON line with the kernel records (launches: one pipeline run),
and last the result line.
Imports nothing of JAX or of the JAX package, and checks that before the
result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "odometry_golden_seed23.npz")
FULLSLAM_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "fullslam_golden_seed3.npz")
PIPELINE_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "pipeline_golden_seed3.npz")
KERNEL_SOURCES = ("normal_equations", "gather")
# Closure verification of the full-SLAM drive registers 128 candidates
# of 8192 keyframe points against per-candidate targets of 8192 voxel
# rows (2048 in the coarse pass): F x V = 1 << 20 (1 << 18) table rows,
# seven key searches per point, one row per point.
KERNEL_SHAPES = ((96, 16384), (128, 8192), (3, 1000), (1, 1))
# (table rows, indices): the Pallas probe's shapes
# (scripts/bench_pallas_gather.py), the bulk path's (the 256x256x32
# dilated index and the 65536-row map, 96 slots x 16384 points), closure
# verification's (fine and coarse), odd M.
GATHER_SHAPES = ((65536, 8192), (1 << 21, 131072), (1 << 21, 1572864),
                 (1 << 20, 7 * 128 * 8192), (1 << 18, 7 * 128 * 8192),
                 (1 << 21, 1000), (1 << 21, 1))
ROW_SHAPES = ((32768, 1572864), (65536, 1572864), (1 << 20, 128 * 8192),
              (1 << 18, 128 * 8192), (32768, 1000), (32768, 1))
# The shapes whose times go into the kernel records (the bulk path's).
GATHER_RECORDED = {"gather_i32": (1 << 21, 1572864),
                   "gather_rows8": (65536, 1572864)}
TIMED_RUNS = 20
FULLSLAM_RUNS = 5
PIPELINE_RUNS = 3
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.  A
# kernel's bound is the larger of the bytes it must move (each input byte
# read once, each output byte written once) and its operations over these.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Float operations per point with a correspondence in the normal
# equations: pose transform 21, residual 8, Huber weight 3, Jacobian 9,
# the 29 sums 69 (an FMA counts 2).
NE_FLOP_PER_HIT = 110
# Corrected trajectory against the JAX golden: x, y within 5 cm; z within
# Z_LIMIT_M.  On this drive the stream's height drifts by metres in both packages, and the
# port's z lands 0.006-0.137 m from the golden's on the card (0.141 m
# between its own runs) and 0.105 m on the CPU, while every accepted
# closure's measured z agrees to 1e-6 m: the bound is ~1.8x the largest
# reading (see _check_fullslam).
Z_LIMIT_M = 0.25


def _events_ms(fn, runs: int, inner: int = 1) -> float:
    """Time per call of `fn()` by CUDA events around `inner` back-to-back
    calls; the median of `runs` such measurements."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _kernel_us(prof) -> float:
    """Total device time of the kernels in a trace, µs (the kernel rows
    only: an operator's row repeats the time of the kernels it launched)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _device_us(fn, calls: int = 20, tries: int = 3) -> float:
    """Device time per call of `fn()` in µs: the kernels torch.profiler
    sees over `calls` back-to-back calls (host time excluded).  A trace
    that caught no kernel (it happens on the card) is taken again, up to
    `tries` times; 0 if none caught one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = _kernel_us(prof) / calls
        if us > 0:
            return us
    return 0.0


def _bound(nbytes: float, flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card could take."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _share(bound_ms: float, dev_us: float) -> str:
    """The device time's share of the bound, as printed."""
    if dev_us <= 0:
        return "the profiler saw no kernel"
    return f"{bound_ms * 1e3 / dev_us:.0%} of the bound"


def _ne_bound(F: int, P: int, hits: int) -> tuple:
    """The normal equations' bound: each hit flag, and p, μ, n (36 B) of
    each point with a correspondence; per slot the pose in (28 B) and H,
    b, the sums and the new pose out (~220 B)."""
    return _bound(F * P + 36 * hits + 248 * F, NE_FLOP_PER_HIT * hits)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build() -> None:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from veloslam_tpu_torch import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {name: pool.submit(_build.build, name)
                   for name in KERNEL_SOURCES}
        built = {name: f.result() for name, f in futures.items()}
    secs = time.perf_counter() - t0
    for name, so in built.items():
        _build.load(name)
        ptxas = [ln.strip() for ln in open(f"{so}.log").read().splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}.cu -> {os.path.relpath(so, REPO)}; ptxas: "
              f"{' | '.join(ptxas)}", flush=True)
    print(f"[build] {len(built)} sources in {secs:.2f} s", flush=True)


def _reset_launches() -> None:
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import normal_equations as ne
    ne.LAUNCHES = 0
    for k in ga.LAUNCHES:
        ga.LAUNCHES[k] = 0


def _launches() -> dict:
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import normal_equations as ne
    return {"fused_normal_equations": ne.LAUNCHES, **ga.LAUNCHES}


def _check_launches(where: str, got: dict, want: dict, device) -> None:
    """Kernel launches of a path against the counts its shapes imply (on
    the CPU, a rehearsal, the wrappers take the plain path: none)."""
    if device.type != "cuda":
        want = dict.fromkeys(want, 0)
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got}, want {want}")


def _ne_inputs(F: int, P: int, seed: int, device, max_dist: float = 2.0,
               hit_rate: float = 0.8, edge_slots: bool = False):
    """Seeded inputs shaped like one GN iteration: posed points out to
    60 m, unit normals, `hit_rate` hits, and means placed along the normal
    so residuals span both Huber regimes (|r| ≶ 0.5) and ~10% exceed the
    max_dist gate.  No |r| lies within 0.02 of max_dist: the gate is a
    threshold, and float32 rounding may put a residual that sits on it on
    either side in the kernel and the plain version.

    With `edge_slots` (and F ≥ 3) the first three slots test the step's
    guards, as tests/torch_helpers.with_edge_slots does: slot 0 has 5
    hits (n_hit ≤ 10: step rejected); slot 1's means sit at its posed
    points moved 1.5 m along x (its step is that translation, clamped to
    1 m); slot 2 has a NaN in a flagged point (H, b and err NaN, the
    factor fails: step rejected)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (F, P, 3))
    axis = rng.normal(size=(F, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(-0.2, 0.2, F)
    q = np.concatenate([np.cos(ang / 2)[:, None],
                        np.sin(ang / 2)[:, None] * axis], 1)
    t = rng.normal(0, 2, (F, 3))
    n = rng.normal(size=(F, P, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u, w = q[:, None, 1:], q[:, None, :1]
    uv = np.cross(u, pts)
    posed = pts + 2.0 * (w * uv + np.cross(u, uv)) + t[:, None]
    r = rng.normal(0, 0.6, (F, P))
    outlier = rng.random((F, P)) < 0.1
    r = np.where(outlier, rng.uniform(max_dist + 0.02, 5.0, (F, P))
                 * np.sign(r), r)
    band = np.abs(np.abs(r) - max_dist) < 0.02
    r = np.where(band, 0.9 * r, r)
    tangent = rng.normal(0, 0.3, (F, P, 3))
    tangent -= np.sum(tangent * n, -1, keepdims=True) * n
    mu = posed - n * r[..., None] + tangent
    hit = (rng.random((F, P)) < hit_rate).astype(np.uint8)
    if edge_slots and F >= 3:
        hit[0] = 0
        hit[0, :5] = 1
        mu[1] = posed[1] + np.array([1.5, 0.0, 0.0])
        hit[2, 0] = 1
        pts[2, 0, 0] = np.nan

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return (dev(pts), dev(q), dev(t), dev(mu), dev(n), dev(hit, np.uint8))


def _same_bits(a, b) -> bool:
    """Bitwise equality (NaN payloads included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _diff(name: str, x, r, rel: bool = False) -> float:
    """max |x − r| (relative to |r| with `rel`) over the entries that are
    not NaN; NaN entries must agree."""
    nan = torch.isnan(r)
    if not torch.equal(torch.isnan(x), nan):
        raise AssertionError(f"{name}: NaN entries differ")
    d = (x - r).abs()
    if rel:
        d = d / r.abs().clamp(min=1e-30)
    d = d[~nan]
    return d.max().item() if d.numel() else 0.0


def _ne_diff(name: str, F: int, P: int, x, r, rel: bool = False) -> float:
    """_diff held to the normal equations' tolerance: |Δ| ≤ 1e-4·max|ref|
    + 1e-3 (float32 sums in another order), or 1e-4 relative."""
    d = _diff(name, x, r, rel)
    finite = r[~torch.isnan(r)].abs()
    lim = 1e-4 if rel else 1e-4 * (finite.max().item()
                                   if finite.numel() else 0) + 1e-3
    if not d <= lim:
        raise AssertionError(f"{name} at {F}x{P}: {'rel ' if rel else ''}"
                             f"|d| {d} > {lim}")
    return d


def _check_ne(F: int, P: int, args) -> dict:
    """NE-only mode against normal_equations_plain: |Δ| ≤ 1e-4·max|ref| +
    1e-3 on H and b (float32 sums in another order), 1e-4 relative on the
    sums, n_hit exact, two launches bitwise equal."""
    from veloslam_tpu_torch.registration import normal_equations as ne
    got = ne.fused_normal_equations(*args)
    again = ne.fused_normal_equations(*args)
    ref = ne.normal_equations_plain(*args)
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"NE kernel not bitwise repeatable at {F}x{P}")
    errs = {name: _ne_diff(name, F, P, got[i], ref[i])
            for i, name in enumerate(("H", "b"))}
    errs.update({name + "_rel": _ne_diff(name, F, P, got[i], ref[i], True)
                 for i, name in ((2, "err_sum"), (3, "w_sum"))})
    if not torch.equal(got[4], ref[4]):
        raise AssertionError(f"n_hit differs at {F}x{P}")
    return errs


def _check_gn(F: int, P: int, args, damping: float = 1e-6) -> dict:
    """gn_iteration's kernel against gn_iteration_plain: the ok and clamp
    decisions exactly (and the edge slots' expected ones), n_hit exact,
    H, b and err at _check_ne's tolerances with NaNs counted equal, a
    rejected slot's pose unchanged bitwise, two calls bitwise equal.  The
    new pose is held within 1e-5 m and 1e-6 per quaternion component of
    the plain step taken from the kernel's own H, b and n_hit: both solve
    the same float32 6×6 system, with another Cholesky.  The fully plain
    pose also differs by H's sum order times the conditioning of H; its
    offset is printed."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import normal_equations as ne
    pts, q, t, mu, n, hit = args
    pose = se3.Pose(q, t)
    got = ne.gn_iteration(pts, pose, mu, n, hit, damping=damping)
    again = ne.gn_iteration(pts, pose, mu, n, hit, damping=damping)
    ref = ne.gn_iteration_plain(pts, pose, mu, n, hit, damping=damping)
    own = ne._gn_step(pose, got.H, got.b, got.n_hit, damping)
    torch.cuda.synchronize()

    def leaves(g):
        return (g.pose.q, g.pose.t, g.H, g.b, g.err, g.n_hit, g.step)
    if not all(_same_bits(a, b) for a, b in zip(leaves(got), leaves(again))):
        raise AssertionError(f"gn_iteration not bitwise repeatable at {F}x{P}")
    if not torch.equal(got.step, ref.step):
        raise AssertionError(f"step decisions differ at {F}x{P}: "
                             f"{got.step.tolist()} vs {ref.step.tolist()}")
    want = [0, 2, 0] if F >= 3 else [0]
    if got.step[:len(want)].tolist() != want:
        raise AssertionError(f"edge slots at {F}x{P}: steps "
                             f"{got.step[:len(want)].tolist()}, want {want}")
    if not torch.equal(got.n_hit, ref.n_hit):
        raise AssertionError(f"gn_iteration n_hit differs at {F}x{P}")
    kept = got.step == 0
    if not (_same_bits(got.pose.q[kept], q[kept])
            and _same_bits(got.pose.t[kept], t[kept])):
        raise AssertionError(f"a rejected step moved the pose at {F}x{P}")
    errs = {"gn_H": _ne_diff("H", F, P, got.H, ref.H),
            "gn_b": _ne_diff("b", F, P, got.b, ref.b),
            "gn_err_rel": _ne_diff("err", F, P, got.err, ref.err, True)}
    errs["pose_t"] = (got.pose.t - own.t).abs().max().item()
    errs["pose_q"] = (got.pose.q - own.q).abs().max().item()
    if not (errs["pose_t"] <= 1e-5 and errs["pose_q"] <= 1e-6):
        raise AssertionError(f"pose at {F}x{P}: |dt| {errs['pose_t']} m, "
                             f"|dq| {errs['pose_q']} from the plain step on "
                             "the kernel's H, b")
    errs["plain_pose_t"] = (got.pose.t - ref.pose.t).abs().max().item()
    errs["plain_pose_q"] = (got.pose.q - ref.pose.q).abs().max().item()
    return errs


def phase_kernel(device) -> dict:
    """The normal-equations kernel in both modes against its plain
    versions at every shape of the paths, then times at the bulk shape;
    returns its kernel record (gn_iteration, as the paths call it)."""
    record = {}
    for F, P in KERNEL_SHAPES:
        args = _ne_inputs(F, P, seed=F * 100003 + P, device=device,
                          edge_slots=True)
        errs = {**_check_ne(F, P, args), **_check_gn(F, P, args)}
        print(f"[kernel] F={F} P={P} NE and GN step ok, steps as designed "
              "on the edge slots, bitwise repeatable; "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items()),
              flush=True)
        if (F, P) == KERNEL_SHAPES[0]:
            record["max_abs_err"] = max(errs["H"], errs["b"])
    record.update(time_normal_equations(device))
    return record


def time_normal_equations(device, step: bool = True) -> dict:
    """Times of the normal-equations kernel at the paths' shapes (bulk
    and closure verification), at chip_smoke's 80% hits and, for the bulk
    shape, the warm map's 56% (PERF.md §4): NE-only, and with `step` the
    whole GN step (gn_iteration, as the paths call it), each beside its
    plain version.  No single PyTorch call computes the function: no
    library time.  Returns the record's times, from the bulk shape at 80%
    (the GN step; NE-only without `step`, which also times a tree whose
    wrapper has no gn_iteration, for a comparison in one call)."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import normal_equations as ne
    record = {}
    for F, P, rate in (KERNEL_SHAPES[0] + (0.8,), KERNEL_SHAPES[0] + (0.56,),
                       KERNEL_SHAPES[1] + (0.8,)):
        args = _ne_inputs(F, P, seed=F * 100003 + P, device=device,
                          hit_rate=rate)
        pts, q, t, mu, n, hit = args
        pose = se3.Pose(q, t)
        bound_ms, bound_by = _ne_bound(F, P, int(hit.sum()))
        calls = {"NE": (lambda: ne.fused_normal_equations(*args),
                        lambda: ne.normal_equations_plain(*args))}
        if step:
            calls["GN step"] = (
                lambda: ne.gn_iteration(pts, pose, mu, n, hit),
                lambda: ne.gn_iteration_plain(pts, pose, mu, n, hit))
        for mode, (kernel, plain) in calls.items():
            times = {"ms": _events_ms(kernel, TIMED_RUNS, 10),
                     "plain_ms": _events_ms(plain, TIMED_RUNS, 10)}
            dev_us = _device_us(kernel)
            print(f"[kernel] {mode} F={F} P={P} hits {rate:.0%}: kernel "
                  f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms "
                  f"per call (median of {TIMED_RUNS} runs of 10 calls); "
                  f"device {dev_us:.2f} µs per call (profiler); bound "
                  f"{bound_ms * 1e3:.2f} µs ({bound_by}), "
                  f"{_share(bound_ms, dev_us)}", flush=True)
            if (F, P, rate) == KERNEL_SHAPES[0] + (0.8,):
                record.update(times, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None)
    # What the card reads in practice: torch.sum over as many bytes as p,
    # μ and n and the flags of the bulk shape, every sector of which the
    # kernel reads when hits are scattered.
    F, P = KERNEL_SHAPES[0]
    x = torch.zeros(F * P * 37 // 4, dtype=torch.float32, device=device)
    print(f"[kernel] torch.sum over {x.numel() * 4 / 1e6:.1f} MB (p, μ, n "
          f"and flags at {F}x{P}): device {_device_us(x.sum):.2f} µs per "
          "call (profiler)", flush=True)
    return record


def _time_gather(name: str, table, idx) -> dict:
    """Times of one gather kernel beside its plain version and the
    library call `torch.index_select(table, 0, idx)` (int32 idx; a
    yardstick only, the port never calls it), and its bound: each index
    read, each output written, and each table row the indices touch read
    once (rows that L2 serves again are not counted)."""
    from veloslam_tpu_torch.registration import gather as ga
    kernel = getattr(ga, name)
    plain = getattr(ga, f"{name}_plain")

    def library():
        return torch.index_select(table, 0, idx)

    m = idx.shape[0]
    row_bytes = table[:1].numel() * table.element_size()
    nbytes = m * (4 + row_bytes) + torch.unique(idx).numel() * row_bytes
    bound_ms, bound_by = _bound(nbytes)
    out = {"ms": _events_ms(lambda: kernel(table, idx), TIMED_RUNS, 10),
           "plain_ms": _events_ms(lambda: plain(table, idx), TIMED_RUNS, 10),
           "library_ms": _events_ms(library, TIMED_RUNS, 10),
           "bound_ms": bound_ms, "bound_by": bound_by}
    dev = {k: _device_us(fn) for k, fn in (
        ("kernel", lambda: kernel(table, idx)),
        ("plain", lambda: plain(table, idx)), ("library", library))}
    rate = (f"{nbytes / dev['kernel'] / 1e3:.0f} GB/s"
            if dev["kernel"] > 0 else "no GB/s")
    out["line"] = (
        f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
        f"index_select {out['library_ms']:.4f} ms per call (median of "
        f"{TIMED_RUNS} runs of 10 calls); device µs per call (profiler): "
        f"kernel {dev['kernel']:.2f} ({rate} of the {nbytes / 1e6:.1f} MB "
        f"it must move), plain {dev['plain']:.2f}, index_select "
        f"{dev['library']:.2f}; bound {bound_ms * 1e3:.2f} µs ({bound_by}), "
        f"{_share(bound_ms, dev['kernel'])}")
    return out


def phase_gather(device) -> dict:
    """Both gather kernels against their plain versions (bitwise), and
    times at the large shapes; returns the records of GATHER_RECORDED."""
    from veloslam_tpu_torch.registration import gather as ga
    rng = np.random.default_rng(7)
    records = {}
    for name, shapes in (("gather_i32", GATHER_SHAPES),
                         ("gather_rows8", ROW_SHAPES)):
        kernel = getattr(ga, name)
        plain = getattr(ga, f"{name}_plain")
        for n, m in shapes:
            if name == "gather_i32":
                table = rng.integers(-1, 32768, n).astype(np.int32)
            else:
                table = rng.standard_normal((n, 8)).astype(np.float32)
            table = torch.as_tensor(table, device=device)
            idx = torch.as_tensor(rng.integers(0, n, m).astype(np.int32),
                                  device=device)
            got = kernel(table, idx)
            ref = plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{name} ({n}, {m}): not bitwise equal "
                                     "to the plain version")
            err = (got - ref).abs().max().item()
            line = f"[kernel] {name} table {n} M {m}: bitwise equal"
            if m >= 131072:
                times = _time_gather(name, table, idx)
                line += "; " + times.pop("line")
                if (n, m) == GATHER_RECORDED[name]:
                    records[name] = {"max_abs_err": err, **times}
            print(line, flush=True)
    return records


def phase_drive(device, gold, cfg: dict) -> dict:
    """Replay each golden drive through StreamingOdometry; returns the
    kernel launches over all of them."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu_torch.runtime.odometry import StreamingOdometry

    iters = cfg["odometry"]["reg_iterations"]
    blocks = -(-iters // cfg["odometry"]["reassociate_every"])
    total = {}
    for drive in cfg["drives"]:
        name = drive["name"]
        seq = sim.generate_sequence(duration_s=cfg["duration_s"],
                                    model=cfg["model"], seed=cfg["seed"],
                                    world=sim.World.demo(**drive["world"]))
        odo = StreamingOdometry(
            DeviceCalib.from_host(calibration.default_for(cfg["model"]),
                                  device=device),
            model=cfg["model"], **cfg["odometry"])
        track = sim.truth_track(seq, drift_rate=drive["drift_rate"])
        _reset_launches()
        t0 = time.perf_counter()
        res = odo.run(seq["packets"], seq["pkt_times_us"], track,
                      batch=cfg["batch"])
        secs = time.perf_counter() - t0
        launches = _launches()
        nb = odo.batches_fed
        _check_launches(name, launches, {
            "fused_normal_equations": iters * nb,
            "gather_i32": blocks * nb, "gather_rows8": blocks * nb}, device)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        pos = res["positions"]
        if not (res["n_frames"] >= 8 and np.isfinite(pos).all()
                and np.isfinite(res["quaternions"]).all()):
            raise AssertionError(f"{name}: bad trajectory, "
                                 f"{res['n_frames']} frames")
        ref = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                    seq["ins_pos"])
        rmse = ate(pos, ref, align=False)["rmse"]
        # Gates of tests/test_odometry.py: 0.15 m at a true INS; with a
        # drifting INS, 0.25 m and 70% of the raw INS error.
        t_rel = (res["times_us"] - seq["ins_t_us"][0]) * 1e-6
        ins_err = float(np.sqrt(np.mean((drive["drift_rate"] * t_rel) ** 2)))
        limit = 0.15 if drive["drift_rate"] == 0 else min(0.25,
                                                          0.7 * ins_err)
        if not rmse < limit:
            raise AssertionError(f"{name}: ATE {rmse} m >= {limit} m")
        if res["n_frames"] != int(gold[f"{name}_n_frames"]) or \
                not np.array_equal(res["times_us"], gold[f"{name}_times_us"]):
            raise AssertionError(f"{name}: frames/times differ from golden")
        off = float(np.linalg.norm(pos - gold[f"{name}_positions"],
                                   axis=1).max())
        if not off < 0.05:
            raise AssertionError(f"{name}: {off} m from the JAX golden")
        print(f"[drive] {name}: {len(seq['packets'])} packets in "
              f"{odo.batches_fed} batches of {cfg['batch']}, "
              f"{res['n_frames']} frames, {secs:.3f} s wall; ATE rmse "
              f"{rmse:.5f} m (limit {limit:.3f}; raw INS {ins_err:.3f}); "
              f"max {off:.2e} m from the JAX golden; launches {launches} "
              f"over {nb} batches", flush=True)
    return total


def _bulk_inputs(device, batch_packets: int = 16384):
    """bench.py's bulk inputs, built with the port's simulator: a 0.35 s
    drive tiled to `batch_packets`, a 64-sample straight-line INS window."""
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.odometry import packets_per_second
    seq = sim.generate_sequence(duration_s=0.35, model="hdl32", seed=0,
                                world=sim.World.demo(1))
    pkts = np.concatenate([seq["packets"]] * (
        batch_packets // len(seq["packets"]) + 1))[:batch_packets]
    rel_s = (np.arange(batch_packets) / packets_per_second("hdl32")
             ).astype(np.float32)
    m = 64
    track_rel = np.linspace(-0.1, rel_s[-1] + 0.1, m).astype(np.float32)
    track_q = np.zeros((m, 4), np.float32)
    track_q[:, 0] = 1.0
    track_t = np.stack([5.0 * track_rel, np.zeros(m), np.full(m, 2.0)],
                       -1).astype(np.float32)
    track_v = np.tile(np.array([5.0, 0, 0], np.float32), (m, 1))
    return [torch.as_tensor(a, device=device)
            for a in (pkts, rel_s, track_rel, track_q, track_t, track_v)]


def phase_bulk(device, smi: str, reg: dict) -> None:
    """`reg`: the production registration config, as the golden file
    recorded it from the JAX package's RegistrationConfig."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.runtime import odometry as odo

    slots = 96
    pkts, rel_s, track_rel, track_q, track_t, track_v = _bulk_inputs(device)
    calib = DeviceCalib.from_host(calibration.hdl32(), device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    kw = dict(model="hdl32", reg_points=reg["reg_points"],
              reg_iterations=reg["reg_iterations"], max_frames_batch=slots,
              reassociate_every=reg["reassociate_every"],
              map_decay=reg["map_decay"])

    def step(state):
        return odo.odometry_step_batched(
            state, pkts, calib, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, **kw)

    fresh = odo.init_state(device=device, map_capacity=reg["map_capacity"],
                           voxel_size=reg["voxel_size"])
    warm, _ = step(fresh)                       # warm-up; fills the map
    torch.cuda.synchronize()
    _reset_launches()
    ms = _events_ms(lambda: step(warm), 5)
    blocks = -(-reg["reg_iterations"] // reg["reassociate_every"])
    _check_launches("bulk (5 steps)", _launches(), {
        "fused_normal_equations": 5 * reg["reg_iterations"],
        "gather_i32": 5 * blocks, "gather_rows8": 5 * blocks}, device)
    # One more step, with lookup_dilated's gather inputs recorded: a real
    # index stream for the gather kernel's times.
    from veloslam_tpu_torch.registration import voxel as vx
    seen, gather_i32 = [], vx.gather_i32

    def recording(table, idx):
        seen.append((table, idx))
        return gather_i32(table, idx)

    vx.gather_i32 = recording
    try:
        after, _, res = odo._batched_core(
            warm, pkts, calib, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, min_points=4, min_planarity=0.35, **kw)
    finally:
        vx.gather_i32 = gather_i32
    n_done = int(res.done.sum())
    matched = res.n_matched[res.done].float().median().item()
    if not (n_done > 0 and torch.isfinite(after.traj_t).all()
            and torch.isfinite(after.map_grid.mean).all()):
        raise AssertionError(f"bad bulk step: {n_done} frames done")
    print(f"[bulk] {pkts.shape[0]} packets, {slots} slots, {n_done} frames "
          f"per batch, median n_matched {matched:.0f}: {ms:.3f} ms/batch, "
          f"{n_done / (ms * 1e-3):.1f} frames/s (median of 5, CUDA events; "
          f"{smi})", flush=True)
    if device.type == "cuda":
        from veloslam_tpu_torch.registration import gather as ga
        table, idx = seen[0]
        if not torch.equal(ga.gather_i32(table, idx),
                           ga.gather_i32_plain(table, idx)):
            raise AssertionError("gather_i32 on lookup_dilated's indices: "
                                 "not bitwise equal to the plain version")
        print(f"[bulk] gather_i32 on lookup_dilated's indices of one warm "
              f"step (table {table.numel()}, M {idx.numel()}, "
              f"{torch.unique(idx).numel()} distinct): bitwise equal; "
              f"{_time_gather('gather_i32', table, idx)['line']}",
              flush=True)


def _fullslam_drive(device, drive: dict, model: str):
    """The drive's packets, INS track and a fresh engine on `device`."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.fullslam import FullSlam
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=model, seed=drive["seed"],
        world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    track = sim.truth_track(seq, drift_rate=drive["drift_rate"])

    def engine():
        return FullSlam(DeviceCalib.from_host(calibration.default_for(model),
                                              device=device),
                        model=model, **drive["engine"])
    return seq, track, engine


def run_fullslam(seq, track, eng, drive: dict, floor: int) -> tuple:
    """Stream the drive, then queue and read the finalize sweep: returns
    (results on the host, stream s, finalize s); each timed span ends
    in a device synchronize."""
    from veloslam_tpu_torch.runtime.pipeline import sweep_budget
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    eng.run_device(seq["packets"], seq["pkt_times_us"], track,
                   batch=drive["batch"])
    sync()
    t1 = time.perf_counter()
    budget = sweep_budget(eng, floor)
    dev = eng.finalize_device(max_candidates=budget, **drive["finalize"])
    sync()
    t2 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in dev.items()
            if isinstance(v, torch.Tensor)}
    host["odometry_t"] = eng.state.traj_t.cpu().numpy()
    host["max_candidates"] = budget
    return host, t1 - t0, t2 - t1


def phase_fullslam(device, smi: str) -> dict:
    """bench.py's full-SLAM drive through FullSlam + finalize_device,
    against the JAX golden: a warm-up run, then FULLSLAM_RUNS measured
    runs; returns the kernel launches of one measured run."""
    gold = np.load(FULLSLAM_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["full"]
    seq, track, engine = _fullslam_drive(device, drive, cfg["model"])
    warm_eng = engine()            # first run: loads the card's libraries
    run_fullslam(seq, track, warm_eng, drive, cfg["budget_floor"])
    runs, z = [], []
    for _ in range(FULLSLAM_RUNS):
        eng = engine()
        _reset_launches()
        host, stream_s, fin_s = run_fullslam(seq, track, eng, drive,
                                             cfg["budget_floor"])
        runs.append((stream_s, fin_s, _launches()))
        _check_fullslam(host, eng, seq, drive, gold, runs[-1][2], device)
        n = int(host["n_frames"])
        z.append((host["traj_t"][:n, 2], host["odometry_t"][:n, 2]))
    stream_s, fin_s = (float(np.median([r[i] for r in runs]))
                       for i in (0, 1))
    launches = runs[-1][2]
    total = stream_s + fin_s
    # The port's own spread between runs, a witness apart from the golden.
    spread = [float(np.ptp(np.stack([r[i] for r in z]), axis=0).max())
              for i in (0, 1)]
    print(f"[fullslam] z spread across the {FULLSLAM_RUNS} runs: corrected "
          f"{spread[0]:.3e} m, odometry {spread[1]:.3e} m (max over frames "
          f"of max - min)", flush=True)
    print(f"[fullslam] stream {stream_s:.3f} s + finalize {fin_s:.3f} s = "
          f"{total:.3f} s: {n / total:.1f} frames/s ({n / stream_s:.1f} "
          f"stream only; medians of {FULLSLAM_RUNS} runs, each from a fresh "
          f"engine, each checked); launches per run {launches}; {smi}",
          flush=True)
    return launches


def _check_fullslam(host, eng, seq, drive, gold, launches, device):
    """One run of the full drive against the JAX golden."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"full_{k}"]

    n = int(host["n_frames"])
    times_us = (host["traj_time"][:n].astype(np.float64) * 1e6
                + eng._stream_t0_us).astype(np.int64)
    if n != int(g("n_frames")) or not np.array_equal(times_us,
                                                     g("times_us")):
        raise AssertionError(f"fullslam: {n} frames / times differ from the "
                             f"golden's {int(g('n_frames'))}")
    kf_n = int(host["kf_n"])
    if kf_n != int(g("kf_n")):
        raise AssertionError(f"fullslam: {kf_n} keyframes, golden "
                             f"{int(g('kf_n'))}")
    if host["max_candidates"] != int(g("max_candidates")):
        raise AssertionError(f"fullslam: budget {host['max_candidates']}, "
                             f"golden {int(g('max_candidates'))}")
    # Candidate pairs and accepted pairs as sets: the greedy pass takes
    # entries in value order, and two values that tie within float32
    # rounding (a score, a distance) may come out in either order on the
    # card, which permutes the slots but not the graph that is solved.
    def pairs(h, flag):
        return sorted(zip(h["cand_i"][h[flag]].tolist(),
                          h["cand_j"][h[flag]].tolist()))
    gh = {k: g(k) for k in ("cand_i", "cand_j", "cand_valid", "accept")}
    same_order = all(np.array_equal(host[k], gh[k]) for k in gh)
    for flag in ("cand_valid", "accept"):
        if pairs(host, flag) != pairs(gh, flag):
            raise AssertionError(
                f"fullslam: {flag} pairs differ from the golden:\n"
                f"{pairs(host, flag)}\n{pairs(gh, flag)}")
    n_acc = int(host["n_accepted"])
    if n_acc < 3:
        raise AssertionError(f"fullslam: {n_acc} closures accepted, want 3+")
    pos = host["traj_t"][:n]
    if not (np.isfinite(pos).all() and np.isfinite(host["traj_q"][:n]).all()):
        raise AssertionError("fullslam: non-finite corrected trajectory")
    # x, y within 5 cm; z within Z_LIMIT_M: on this drive the odometry's
    # height drifts by metres in both packages (z is barely observed), so
    # float sums taken in another order move the stream's z by a
    # decimetre, between the port's own runs on the card as against the
    # golden.  The finalize's correction (corrected - stream) is printed
    # beside it: it moves with the stream's z, a few cm at most.
    off = float(np.linalg.norm(pos[:, :2] - g("positions")[:, :2],
                               axis=1).max())
    off_z = float(np.abs(pos[:, 2] - g("positions")[:, 2]).max())
    corr = float(np.linalg.norm(
        (pos - host["odometry_t"][:n])
        - (g("positions") - g("odometry_positions")), axis=1).max())
    odo_z = float(np.abs(host["odometry_t"][:n, 2]
                         - g("odometry_positions")[:, 2]).max())
    odo_xy = float(np.linalg.norm(host["odometry_t"][:n, :2]
                                  - g("odometry_positions")[:, :2],
                                  axis=1).max())
    if not (off <= 0.05 and off_z <= Z_LIMIT_M):
        raise AssertionError(f"fullslam: corrected trajectory {off} m from "
                             f"the JAX golden in x, y, {off_z} m in z")
    # Accepted closures' measured translations, matched by pair.
    def meas(h):
        return {(i, j): t for i, j, t, a in zip(
            h["cand_i"].tolist(), h["cand_j"].tolist(), h["meas_t"],
            h["accept"]) if a}
    gm, hm = meas({**gh, "meas_t": g("meas_t")}), meas(host)
    meas_d = np.abs(np.stack([hm[k] - gm[k] for k in gm]))
    truth = interpolate_positions(times_us, seq["ins_t_us"], seq["ins_pos"])
    rmse = ate(pos[:, :2], truth[:, :2], align=False)["rmse"]
    limit = min(float(g("ate")) + 0.02, 0.5 * float(g("ate_raw_ins")))
    if not rmse <= limit:
        raise AssertionError(f"fullslam: ATE {rmse} m > {limit} m")
    blocks = -(-drive["engine"]["reg_iterations"]
               // drive["engine"]["reassociate_every"])
    nb = eng.batches_fed
    # Verification: coarse 6 GN iterations re-associating every 2, fine
    # and reverse 20 every 4, and H_self: 46 + 1 normal-equations
    # launches, 3 + 5 + 5 + 1 association blocks.
    _check_launches("fullslam", launches, {
        "fused_normal_equations":
            drive["engine"]["reg_iterations"] * nb + 6 + 20 + 20 + 1,
        "gather_i32": blocks * nb + 14,
        "gather_rows8": blocks * nb + 14}, device)
    print(f"[fullslam] {len(seq['packets'])} packets in {nb} batches of "
          f"{drive['batch']} (bootstrap ramp first), {n} frames, {kf_n} "
          f"keyframes (ring {eng.ring.capacity}); "
          f"{int(host['cand_valid'].sum())} candidates of "
          f"{host['max_candidates']}, {n_acc} accepted, equal to the "
          f"JAX golden's as sets (slot order "
          f"{'equal' if same_order else 'permuted'}); corrected trajectory "
          f"max {off:.2e} m from it in x, y, {off_z:.2e} m in z, its "
          f"correction {corr:.2e} m from the golden's in 3-D; odometry "
          f"{odo_xy:.2e} m in x, y, {odo_z:.2e} m in z; accepted closures' "
          f"measured t max {meas_d[:, :2].max():.2e} m in x, y, "
          f"{meas_d[:, 2].max():.2e} m in z; 2-D ATE "
          f"{rmse:.4f} m (golden {float(g('ate')):.4f}, raw INS "
          f"{float(g('ate_raw_ins')):.3f}, limit {limit:.4f})", flush=True)


def write_pipeline_drive(drive: dict, model: str, out_dir: str):
    """A golden drive as bench.py::_make_drive writes it, with the port's
    writers: the sequence, its pcap (position packets every 1 s) and INS
    log, the INS positions drifted in +y."""
    from veloslam_tpu_torch.io import packets as pk
    from veloslam_tpu_torch.io import simulate as sim
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=model, seed=drive["seed"],
        world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    paths = sim.write_sequence(seq, out_dir, name=drive["name"])
    ins = pk.read_ins_txt(paths["ins"])
    ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
    pk.write_ins_txt(paths["ins"], ins["t_us"],
                     ins["pos_xy"] + np.stack(
                         [np.zeros_like(ts), drive["drift_rate"] * ts], -1),
                     np.deg2rad(ins["yaw_deg"]), speed=ins["speed"])
    return paths, seq


def run_pipeline(paths: dict, drive: dict, device, timers=None) -> tuple:
    """One user run, as bench.py::run_full_slam times it: a fresh
    SlamPipeline, run_offline_batched (pcap read included) + finalize;
    returns (pipeline, results, wall s).  `timers` replaces the
    pipeline's stage timers."""
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]), device=device)
    if timers is not None:
        pipe.timers = timers
    sync()
    t0 = time.perf_counter()
    pipe.run_offline_batched(paths["pcap"], paths["ins"],
                             batch=drive["batch"], defer_map=True)
    res = pipe.finalize()
    sync()
    return pipe, res, time.perf_counter() - t0


def phase_pipeline(device, smi: str, fullslam_launches: dict,
                   name: str = "full") -> dict:
    """The user pipeline on bench.py's full-SLAM drive (or, for a CPU
    rehearsal, `name="small"`), against the JAX golden: a warm run, then
    PIPELINE_RUNS measured runs, then one stage-synchronized run; returns
    the kernel launches of one measured run.  The pipeline streams the
    same packets in the same batches as phase `fullslam` and verifies the
    same candidates, so its launches must equal that phase's."""
    import tempfile

    from veloslam_tpu_torch.utils.profiling import StageTimers
    gold = np.load(PIPELINE_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    with tempfile.TemporaryDirectory() as tmp:
        paths, seq = write_pipeline_drive(drive, cfg["model"], tmp)
        run_pipeline(paths, drive, device)      # warm: the card's libraries
        walls, launches = [], None
        for _ in range(PIPELINE_RUNS):
            _reset_launches()
            pipe, res, wall = run_pipeline(paths, drive, device)
            launches = _launches()
            _check_pipeline(pipe, res, seq, gold, name, launches,
                            fullslam_launches, device)
            walls.append(wall)
        sync = (torch.cuda.synchronize if device.type == "cuda" else None)
        _, res, wall_sync = run_pipeline(paths, drive, device,
                                         StageTimers(sync=sync))
    wall = float(np.median(walls))
    n = res["n_frames"]
    stages = {k: round(v["total_s"], 4) for k, v in res["timing"].items()}
    print(f"[pipeline] {n} frames in {wall:.3f} s: {n / wall:.1f} frames/s "
          f"(pipeline frames/s as bench.py::run_full_slam: run_offline_"
          f"batched + finalize, pcap read included; median of "
          f"{PIPELINE_RUNS} runs {[round(w, 3) for w in walls]}, each "
          f"checked); launches per run {launches}; {smi}", flush=True)
    print(f"[pipeline] stage seconds, synchronized at each stage's end "
          f"({wall_sync:.3f} s wall, {sum(stages.values()):.3f} s in "
          f"stages): {stages}; {smi}", flush=True)
    return launches


def _check_pipeline(pipe, res, seq, gold, name, launches, fullslam_launches,
                    device) -> None:
    """One pipeline run against the JAX golden."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"{name}_{k}"]

    n = res["n_frames"]
    if n != int(g("n_frames")) or not np.array_equal(res["times_us"],
                                                     g("times_us")):
        raise AssertionError(f"pipeline: {n} frames / times differ from "
                             f"the golden's {int(g('n_frames'))}")
    if res["n_keyframes"] != int(g("n_keyframes")) or not np.array_equal(
            res["keyframe_times_us"], g("keyframe_times_us")):
        raise AssertionError(f"pipeline: {res['n_keyframes']} keyframes / "
                             f"times, golden {int(g('n_keyframes'))}")
    # As sets: near-tied proposal values may permute the slots on the card
    # (see _check_fullslam), not the graph.
    closures = sorted(pipe.closures)
    if closures != sorted(map(tuple, g("closures").tolist())):
        raise AssertionError(f"pipeline: closure pairs {closures} differ "
                             f"from the golden's {g('closures').tolist()}")
    if len(closures) < 3:
        raise AssertionError(f"pipeline: {len(closures)} closures, want 3+")
    pos = res["positions"]
    if not (np.isfinite(pos).all() and np.isfinite(res["quaternions"]).all()):
        raise AssertionError("pipeline: non-finite trajectory")
    off = float(np.linalg.norm(pos[:, :2] - g("positions")[:, :2],
                               axis=1).max())
    off_z = float(np.abs(pos[:, 2] - g("positions")[:, 2]).max())
    if not (off <= 0.05 and off_z <= Z_LIMIT_M):
        raise AssertionError(f"pipeline: trajectory {off} m from the JAX "
                             f"golden in x, y, {off_z} m in z")
    counts = {k: (res[k], int(g(k))) for k in ("n_landmarks",
                                              "n_landmark_obs")}
    for k, (got, want) in counts.items():
        if not abs(got - want) <= 0.05 * want:
            raise AssertionError(f"pipeline: {k} {got}, golden {want} "
                                 "(more than 5% apart)")
    lm = ""
    if res["n_landmarks"] == int(g("n_landmarks")):
        d = np.linalg.norm(pipe.graph.l_pos[:pipe.graph.n_landmarks]
                           - g("landmarks"), axis=1)
        lm = f", landmarks max {d.max():.2e} m from the golden's"
    patches = [pipe.map._materialize(k, create=False)
               for k in sorted(set(pipe.map._patches)
                               | set(pipe.map._spilled))]
    count = sum(float(p.count.sum()) for p in patches)
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    rmse = ate(pos[:, :2], truth[:, :2], align=False)["rmse"]
    limit = min(float(g("ate")) + 0.02, 0.15)
    if not rmse <= limit:
        raise AssertionError(f"pipeline: ATE {rmse} m > {limit} m")
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"pipeline: a kernel was not launched: "
                             f"{launches}")
    _check_launches("pipeline", launches, fullslam_launches, device)
    print(f"[pipeline] {n} frames, {res['n_keyframes']} keyframes, "
          f"{len(closures)} closures equal to the JAX golden's as sets; "
          f"trajectory max {off:.2e} m from it in x, y, {off_z:.2e} m in z; "
          f"landmarks {res['n_landmarks']} (golden {counts['n_landmarks'][1]}"
          f", {res['n_landmarks'] - counts['n_landmarks'][1]:+d}), "
          f"observations {res['n_landmark_obs']} (golden "
          f"{counts['n_landmark_obs'][1]}, "
          f"{res['n_landmark_obs'] - counts['n_landmark_obs'][1]:+d}), "
          f"{int(pipe.graph.o_ok[:pipe.graph.n_obs].sum())} kept after the "
          f"trim{lm}; map {res['map_patches']} patches (golden "
          f"{int(g('map_patches'))}), {sum(p.n_voxels for p in patches)} "
          f"voxels (golden {int(g('map_voxels'))}), total count "
          f"{count / float(g('map_count')) - 1:+.2e} relative to the "
          f"golden's; 2-D ATE {rmse:.4f} m (golden {float(g('ate')):.4f}, "
          f"limit {limit:.4f})", flush=True)


def main() -> int:
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    record = phase_kernel(device)
    gather_records = phase_gather(device)
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive_launches = phase_drive(device, gold, cfg)
    print(f"[drive] launches over both drives: {drive_launches}", flush=True)
    phase_bulk(device, smi, cfg["odometry"])
    fullslam_launches = phase_fullslam(device, smi)
    launches = phase_pipeline(device, smi, fullslam_launches)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "veloslam_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package: {loaded}")
    src = "veloslam_tpu_torch/csrc/"
    kernels = [
        {"name": "fused_normal_equations", "route": "cuda",
         "source": src + "normal_equations.cu",
         "replaces": "veloslam_tpu/registration/pallas_kernels.py:84",
         "launches": launches["fused_normal_equations"], **record},
        {"name": "gather_i32", "route": "cuda", "source": src + "gather.cu",
         "replaces": "scripts/bench_pallas_gather.py:54",
         "launches": launches["gather_i32"],
         **gather_records["gather_i32"]},
        {"name": "gather_rows8", "route": "cuda", "source": src + "gather.cu",
         "replaces": "scripts/bench_pallas_gather.py:88",
         "launches": launches["gather_rows8"],
         **gather_records["gather_rows8"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
