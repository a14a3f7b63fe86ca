"""The normal-equations kernel (veloslam_tpu_torch/csrc/normal_equations.cu
through registration/normal_equations.py) of another source tree against
this one's, in turns, on one CUDA card: time and accuracy.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_ne.py OTHER_TREE

OTHER_TREE is another tree of the repository, e.g. the parent commit's,
unpacked into a directory that .gitignore lists:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent

First, with this tree, the GN step's own inputs on the sensor families'
drives of tests/fixtures/models_golden_seed3.npz are recorded to build/:
every call of `slam_run --model hdl64 --calibration db.xml --fast` on
bench.py's drive, and the last call of one VLP-16 bulk step of 16384
packets (chip_smoke._bulk_inputs) at 222 frame slots.  Then, in the order
other, this, this, other, each tree in a process of its own (its package
imported first): gn_iteration and NE-only ms per call (CUDA events over
10 calls, median of chip_smoke.TIMED_RUNS), device µs (torch.profiler)
and the host's µs a call (the two's difference) on chip_smoke._ne_inputs
at PROFILED_SHAPES and HIT_RATES, beside chip_smoke._ne_bound; and on
every recorded input, how far the kernel's b
and the plain float32 version's b land from the plain version evaluated
in float64, against chip_smoke's tolerance (1e-4·max|b| + 1e-3), and how
far the kernel's pose lands from the float64 step on its own H, b
(tolerance 1e-5 m).
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(REPO, "build", "profile_ne_inputs.pt")
ORDER = ("other", "this", "this", "other")
PROFILED_SHAPES = ((96, 16384), (50, 16384), (222, 16384), (128, 8192),
                   (1, 16384), (8, 16384))
HIT_RATES = (0.8, 0.56, 0.01)


def record_inputs(path: str) -> None:
    """The GN step's inputs on the HDL-64's --fast drive and a VLP-16
    bulk step, on the CPU, saved to `path`."""
    import contextlib
    import io
    import json
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as cs
    from veloslam_tpu_torch.apps import slam_run
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.registration import gicp
    dev = torch.device("cuda", 0)
    calls = {"hdl64 --fast": [], "vlp16 bulk": []}
    orig = gicp.gn_iteration
    where = []

    def record(*args, **kw):
        if where[0] == "vlp16 bulk":        # its last call only
            calls[where[0]].clear()
        pts, pose, mu, n, hit = args
        calls[where[0]].append((tuple(x.detach().cpu().clone() for x in (
            pts, pose.q, pose.t, mu, n, hit)), dict(kw)))
        return orig(*args, **kw)

    gold, cfg, drives = cs.models_drives("full")
    drive = drives["hdl64"]
    gicp.gn_iteration = record
    try:
        where[:] = ["hdl64 --fast"]
        with tempfile.TemporaryDirectory() as tmp:
            paths, _, _ = cs.write_models_drive(drive, tmp)
            with contextlib.redirect_stdout(io.StringIO()):
                slam_run.main([
                    "--pcap", paths["pcap"], "--ins", paths["ins"],
                    "--model", "hdl64", "--calibration",
                    paths["calibration"], "--fast", "--batch",
                    str(drive["fast_batch"]), "--device", "cuda",
                    "--out-dir", os.path.join(tmp, "out")])
        where[:] = ["vlp16 bulk"]
        reg = json.loads(str(np.load(cs.GOLDEN)["config"]))["odometry"]
        with contextlib.redirect_stdout(io.StringIO()):
            cs._models_bulk(dev, "", "vlp16", calibration.vlp16(), reg)
    finally:
        gicp.gn_iteration = orig
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(calls, path)
    print(f"[profile_ne] recorded {[(k, len(v)) for k, v in calls.items()]} "
          f"GN inputs to {path}", flush=True)


def measure(tree: str, label: str, path: str) -> None:
    """One tree's kernel: times at PROFILED_SHAPES, then its accuracy on
    the recorded inputs.  Its package is imported before chip_smoke."""
    sys.path.insert(0, tree)
    import torch

    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import normal_equations as ne
    if not os.path.abspath(ne.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"{ne.__file__} is not under {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    head = f"[profile_ne] {label} ({tree})"
    for (F, P), rate in ((s, r) for s in PROFILED_SHAPES for r in HIT_RATES):
        pts, q, t, mu, n, hit = cs._ne_inputs(F, P, seed=F * 100003 + P,
                                              device=dev, hit_rate=rate)
        pose = se3.Pose(q, t)

        def gn():
            return ne.gn_iteration(pts, pose, mu, n, hit)

        def ne_only():
            return ne.fused_normal_equations(pts, q, t, mu, n, hit)

        bound_ms, by = cs._ne_bound(F, P, int(hit.sum()))
        ms = {k: cs._events_ms(fn, cs.TIMED_RUNS, 10) * 1e3
              for k, fn in (("GN", gn), ("NE", ne_only))}
        us = {k: cs._device_us(fn)
              for k, fn in (("GN", gn), ("NE", ne_only))}
        print(f"{head} F={F} P={P} {rate:.0%} hits: GN {ms['GN']:.2f} µs, "
              f"NE-only {ms['NE']:.2f} µs per call (events); device GN "
              f"{us['GN']:.2f} µs, NE-only {us['NE']:.2f} µs; host GN "
              f"{ms['GN'] - us['GN']:.2f} µs, NE-only "
              f"{ms['NE'] - us['NE']:.2f} µs; bound {bound_ms * 1e3:.2f} "
              f"µs ({by})", flush=True)
    for source, calls in torch.load(path).items():
        worst = dict.fromkeys(("kernel_b", "f32_b", "over_b", "pose_t"),
                              0.0)
        fails = 0
        for args, kw in calls:
            pts, q, t, mu, n, hit = (x.to(dev) for x in args)
            pose = se3.Pose(q, t)
            got = ne.gn_iteration(pts, pose, mu, n, hit, **kw)
            ref32 = ne.gn_iteration_plain(pts, pose, mu, n, hit, **kw)
            ref = ne.gn_iteration_plain(*cs._f64((pts, pose, mu, n)), hit,
                                        **kw)
            own = ne._gn_step(cs._f64(pose), got.H.double(),
                              got.b.double(), got.n_hit,
                              kw.get("damping", 1e-6))
            finite = ref.b[~torch.isnan(ref.b)].abs()
            lim = 1e-4 * (finite.max().item() if finite.numel() else 0) \
                + 1e-3
            row = {"kernel_b": cs._diff("b", got.b, ref.b),
                   "f32_b": cs._diff("b", ref32.b, ref.b),
                   "pose_t": cs._diff("t", got.pose.t, own.t)}
            row["over_b"] = row["kernel_b"] / lim
            fails += row["kernel_b"] > lim or row["pose_t"] > 1e-5
            worst = {k: max(worst[k], row[k]) for k in worst}
        print(f"{head} {source}: {len(calls)} GN inputs, {fails} outside "
              f"chip_smoke's tolerances; largest |Δb| from the float64 "
              f"evaluation: kernel {worst['kernel_b']:.3g} (at most "
              f"{worst['over_b']:.3g}x its limit), plain float32 "
              f"{worst['f32_b']:.3g}; kernel pose from the float64 step on "
              f"its own H, b {worst['pose_t']:.3g} m", flush=True)


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--measure":
        measure(*argv[1:])
        return 0
    if len(argv) != 1:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(f"[profile_ne] {cs.phase_device()}", flush=True)
    record_inputs(INPUTS)
    trees = {"this": REPO, "other": os.path.abspath(argv[0])}
    for label in ORDER:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", trees[label], label, INPUTS],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
