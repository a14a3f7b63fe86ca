#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`, `slambench/workloads/<cell>
.json`) names a configuration (`configs/`), a traffic (`traffic/`) and
through it the entry (`entries/`) that the window drives.  Set-up makes
the drive from the seed on the card, writes it as the user's files under
TMPDIR, and runs one warm pass; the window then runs for `--seconds`;
after it the reference (`reference/`) judges what the window produced.
With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read by `metrics/<name>.py` from the
spans and the profiler's trace of the window.  The last line of standard
output is the result, a JSON object whose last key, `checks`, holds each
number compared with its limit; the last lines of standard error say the
same.  Without a CUDA card the run prints no result and exits 3.
"""

from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "veloslam_tpu")
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, on
    the clock of /proc/uptime)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number present, finite and at or
    under its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        passed = _finite(v) and v <= limit
        ok = ok and passed
        checks[name] = {"value": v if _finite(v) else str(v),
                        "limit": limit}
    return ok, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One process with one host thread a pool: the port's host stages
    # (the map's tile merge, landmarks, the graph solve) otherwise spread
    # over math threads that contend with the card's other host work, and
    # the rate spreads with the host's load.  Set before torch and numpy
    # load.
    for var in THREAD_VARS:
        os.environ[var] = "1"
    return run(args.workload, args.seed, args.seconds, bool(args.trace))


def run(name: str, seed: int, seconds: float, trace: bool,
        device_name: str = "cuda:0", bench_dir: str = BENCH_DIR,
        root: str = ROOT, require_card: bool = True) -> int:
    from slambench.lib import port, registry
    from slambench.lib.context import Context
    from slambench.lib.spans import Spans

    bench = registry.benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        print(f"slambench: no workload {name!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = registry.workload(name, bench_dir)
    config = registry.config(cell["config"], bench_dir)
    traffic = registry.traffic(cell["traffic"], bench_dir)
    chips = int(cells[name]["chips"])

    import torch
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"slambench: needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}",
                  file=sys.stderr)
            return 3
        # Build and kernel caches at fixed paths inside the checkout.
        for var, sub in (("TRITON_CACHE_DIR", "triton"),
                         ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
            os.environ.setdefault(var, os.path.join(root, "build", sub))
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    tmp = tempfile.mkdtemp(prefix=f"slambench-{name}-")
    try:
        spans = Spans(annotate=trace)
        ctx = Context(name=name, cell=cell, config=config, traffic=traffic,
                      seed=seed, seconds=seconds, device=device, tmp=tmp,
                      spans=spans)
        entry = registry.entry(traffic["entry"], bench_dir).Entry(ctx)
        with spans.span("setup"):
            entry.setup()
        per_layer = registry.cell_metrics(bench, name, "per_layer")
        readers = {m: registry.metric(m, bench_dir) for m in per_layer} \
            if trace else {}
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(ctx)
        port.sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ctx.window_from = len(spans.items)
        t_call = time.perf_counter()
        age_at_call = process_age_s()
        cpu0 = time.process_time()
        prof = None
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            with record_function("slambench.window"):
                result = entry.window()
            port.sync(device)
            prof.stop()
        else:
            result = entry.window()
            port.sync(device)
        cpu1 = time.process_time()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        # The window opened when its first pass started (the entry may
        # start it later than the call, after binding ports and a lead).
        lead = result.get("lead_s", 0.0)
        setup_s = age_at_call + lead
        ctx.result = result
        for r in readers.values():
            if hasattr(r, "uninstall"):
                r.uninstall(ctx)
        if prof is not None:
            from slambench.lib import trace as tr
            with spans.span("trace_reduce"):
                ctx.trace = tr.from_profiler(prof)
            del prof
        bad = forbidden_modules()
        if bad:
            print(f"slambench: forbidden modules loaded: {bad}",
                  file=sys.stderr)
            return 4

        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = entry.check(result)
        check_s = time.perf_counter() - t_check
        correct, checks = judge(numbers, cell["check"]["limits"])

        if trace:
            metrics = {}
            for m, spec in per_layer.items():
                v = readers[m].read(ctx)
                if v is not None:
                    metrics[m] = {"value": v, "unit": spec["unit"]}
        else:
            e2e = registry.cell_metrics(bench, name, "end_to_end")
            metrics = {}
            for m, spec in e2e.items():
                v = setup_s if m == "setup_s" else result["metrics"].get(m)
                if v is not None:
                    metrics[m] = {"value": v, "unit": spec["unit"]}

        dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": chips, "memory_peak_bytes": int(peak)}
        out = {"correct": bool(correct),
               "attempted": int(numbers.get("attempted", 0)),
               "failed": int(numbers.get("frames_bad", 0)),
               "metrics": metrics, "device": dev}
        if trace and ctx.trace is not None:
            from slambench.lib import trace as tr
            dev["busy_s"] = tr.busy_s(ctx.trace)
            dev["window_s"] = tr.window_s(ctx.trace)
            out["breakdown"] = {"device_ops": tr.device_ops(ctx.trace),
                                "idle_gaps": tr.idle_gaps(ctx.trace)}
        out["checks"] = checks

        info = dict(result.get("info", {}), seed=seed, trace=int(trace),
                    window_s=result["window_s"], setup_s=setup_s,
                    reference_s=check_s, memory_peak_bytes=int(peak),
                    numbers=numbers, notes=ctx.notes,
                    window_call_s=time.perf_counter() - t_call,
                    window_cpu_s=cpu1 - cpu0)
        print("# info " + json.dumps(info, default=str), file=sys.stderr)
        print(f"# correct {correct}", file=sys.stderr)
        for k, c in checks.items():
            print(f"# check {k} = {c['value']} (limit {c['limit']})",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(out))
        sys.stdout.flush()
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
