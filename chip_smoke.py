"""Drive the PyTorch port's bulk-odometry main path once on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and the exit code is
non-zero:
  1. device   — require CUDA; print the card's name and power limit;
                turn TF32 off for float32 matmuls and convolutions.
  2. build    — compile the normal-equations kernel from csrc/ with nvcc.
  3. kernel   — kernel vs its plain torch version on the card at
                (F, P) = (96, 16384), (3, 1000), (1, 1); bitwise
                repeatability; kernel and plain times at (96, 16384).
  4. drive    — StreamingOdometry on two simulated 1.2 s HDL-32 drives
                (INS at truth; INS drifting 0.3 m/s) with the production
                registration config, checked against the simulator's truth
                (ATE), against the JAX package's golden trajectories
                (tests/fixtures/odometry_golden_seed23.npz) and for one
                kernel launch per GN iteration.
  5. bulk     — one full-width odometry_step_batched (16384 packets,
                96 frame slots) timed from a warm map.
Then one JSON line with the kernel records, and last the result line.
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
KERNEL_SHAPES = ((96, 16384), (3, 1000), (1, 1))
TIMED_RUNS = 20


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
    from veloslam_tpu_torch import _build
    t0 = time.perf_counter()
    so = _build.build("normal_equations")
    _build.load("normal_equations")
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in open(f"{so}.log").read().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] normal_equations.cu -> {os.path.relpath(so, REPO)} in "
          f"{secs:.2f} s; ptxas: {' | '.join(ptxas)}", flush=True)


def _ne_inputs(F: int, P: int, seed: int, device, max_dist: float = 2.0):
    """Seeded inputs shaped like one GN iteration: posed points out to
    60 m, unit normals, ~80% hits, and means placed along the normal so
    residuals span both Huber regimes (|r| ≶ 0.5) and ~10% exceed the
    max_dist gate.  No |r| lies within 0.02 of max_dist: the gate is a
    threshold, and float32 rounding may put a residual that sits on it on
    either side in the kernel and the plain version."""
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
    hit = (rng.random((F, P)) < 0.8).astype(np.uint8)

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return (dev(pts), dev(q), dev(t), dev(mu), dev(n), dev(hit, np.uint8))


def phase_kernel(device) -> dict:
    from veloslam_tpu_torch.registration import normal_equations as ne
    record = {}
    for F, P in KERNEL_SHAPES:
        args = _ne_inputs(F, P, seed=F * 100003 + P, device=device)
        got = ne.fused_normal_equations(*args)
        again = ne.fused_normal_equations(*args)
        ref = ne.normal_equations_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"kernel not bitwise repeatable at {F}x{P}")
        H, b, err_sum, w_sum, n_hit = got
        Hr, br, er, wr, nr = ref
        errs = {}
        for name, x, r in (("H", H, Hr), ("b", b, br)):
            d = (x - r).abs().max().item()
            lim = 1e-4 * r.abs().max().item() + 1e-3
            if not d <= lim:
                raise AssertionError(f"{name} at {F}x{P}: |d| {d} > {lim}")
            errs[name] = d
        for name, x, r in (("err_sum", err_sum, er), ("w_sum", w_sum, wr)):
            rel = ((x - r).abs() / r.abs().clamp(min=1e-30)).max().item()
            if not rel <= 1e-4:
                raise AssertionError(f"{name} at {F}x{P}: rel {rel} > 1e-4")
            errs[name + "_rel"] = rel
        if not torch.equal(n_hit, nr):
            raise AssertionError(f"n_hit differs at {F}x{P}")
        print(f"[kernel] F={F} P={P} ok, bitwise repeatable; "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items()),
              flush=True)
        if (F, P) == KERNEL_SHAPES[0]:
            record["max_abs_err"] = max(errs["H"], errs["b"])
            record["ms"] = _events_ms(
                lambda: ne.fused_normal_equations(*args), TIMED_RUNS, 10)
            record["plain_ms"] = _events_ms(
                lambda: ne.normal_equations_plain(*args), TIMED_RUNS, 10)
            # The kernel reads each hit flag, and p, μ, n (36 B) of hits.
            read = F * P + 36 * int(args[5].sum())
            gbs = read / (record["ms"] * 1e-3) / 1e9
            print(f"[kernel] F={F} P={P}: kernel {record['ms']:.4f} ms "
                  f"per call (~{gbs:.0f} GB/s of the {read / 1e6:.1f} MB "
                  "it reads), plain "
                  f"{record['plain_ms']:.4f} ms (median of {TIMED_RUNS} "
                  "runs of 10 calls)", flush=True)
    return record


def phase_drive(device, gold, cfg: dict) -> int:
    """Replay each golden drive through StreamingOdometry; returns the
    kernel launches over all of them."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.registration import normal_equations as ne
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu_torch.runtime.odometry import StreamingOdometry

    iters = cfg["odometry"]["reg_iterations"]
    total = 0
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
        ne.LAUNCHES = 0
        t0 = time.perf_counter()
        res = odo.run(seq["packets"], seq["pkt_times_us"], track,
                      batch=cfg["batch"])
        secs = time.perf_counter() - t0
        launches = ne.LAUNCHES
        if launches != iters * odo.batches_fed:
            raise AssertionError(
                f"{name}: {launches} kernel launches, want {iters} per batch "
                f"x {odo.batches_fed} batches")
        total += launches
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
              f"max {off:.2e} m from the JAX golden; {launches} kernel "
              f"launches = {iters} x {odo.batches_fed} batches", flush=True)
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
    from veloslam_tpu_torch.registration import normal_equations as ne
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
    before = ne.LAUNCHES
    ms = _events_ms(lambda: step(warm), 5)
    per_call = (ne.LAUNCHES - before) / 5
    if per_call != reg["reg_iterations"]:
        raise AssertionError(f"{per_call} kernel launches per step")
    after, _, res = odo._batched_core(
        warm, pkts, calib, rel_s, zero, zero, track_rel, track_q, track_t,
        track_v, min_points=4, min_planarity=0.35, **kw)
    n_done = int(res.done.sum())
    matched = res.n_matched[res.done].float().median().item()
    if not (n_done > 0 and torch.isfinite(after.traj_t).all()
            and torch.isfinite(after.map_grid.mean).all()):
        raise AssertionError(f"bad bulk step: {n_done} frames done")
    print(f"[bulk] {pkts.shape[0]} packets, {slots} slots, {n_done} frames "
          f"per batch, median n_matched {matched:.0f}: {ms:.3f} ms/batch, "
          f"{n_done / (ms * 1e-3):.1f} frames/s (median of 5, CUDA events; "
          f"{smi})", flush=True)


def main() -> int:
    smi = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    record = phase_kernel(device)
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    launches = phase_drive(device, gold, cfg)
    phase_bulk(device, smi, cfg["odometry"])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "veloslam_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package: {loaded}")
    kernels = [{
        "name": "fused_normal_equations", "route": "cuda",
        "source": "veloslam_tpu_torch/csrc/normal_equations.cu",
        "replaces": "veloslam_tpu/registration/pallas_kernels.py:84",
        "launches": launches, "max_abs_err": record["max_abs_err"],
        "ms": record["ms"], "plain_ms": record["plain_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
