"""The chain kernel (veloslam_tpu_torch/csrc/chain.cu) against another
version of its source, in turns, in one process on one CUDA card.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_chain.py OTHER_CHAIN_CU

OTHER_CHAIN_CU is the other source, e.g. the parent commit's, unpacked
into a directory that .gitignore lists:

    mkdir -p build/parent && git archive HEAD~1 \\
        veloslam_tpu_torch/csrc/chain.cu | tar -x -C build/parent

Both sources are built with the port's nvcc flags.  In the order other,
this, this, other, each is timed at chip_smoke.CHAIN_TIMED (factor and
solve on chip_smoke.chain_inputs, CUDA events), in ns per step beside
chip_smoke's latency bound; the two builds' outputs are compared bit for
bit; then the pose-only PCG solve at K = 16384 (chip_smoke's "chain"
graph at the production 8 GN x 96 CG iterations) runs once with each, in
the same order, timed by CUDA events, its positions compared bit for
bit.  Last, the SASS of this build's chain_factor_kernel around its first
MUFU.RCP (the reciprocal of chip_smoke.CHAIN_RCP_OPS) is printed, with
the kernel's counts of a few instructions.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ORDER = ("other", "this", "this", "other")


def build_other(src: Path) -> ctypes.CDLL:
    """`src` built with the port's flags beside the port's own builds."""
    from veloslam_tpu_torch import _build
    from veloslam_tpu_torch.graph import chain
    out = _build.BUILD_DIR / "chain-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(f"[profile_chain] other: {src}; ptxas: " + " | ".join(
        ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
        if "registers" in ln or "spill" in ln), flush=True)
    return chain.bind(ctypes.CDLL(str(out)))


def kernels(other: ctypes.CDLL):
    """A function use(name) that routes graph.chain's wrappers to this
    build ("this") or `other`."""
    from veloslam_tpu_torch.graph import chain
    this = chain._kernel_lib()
    libs = {"this": this, "other": other}

    def use(name):
        chain._kernel_lib = lambda: libs[name]
    return use


def time_steps(use, smi: str) -> None:
    """Each build at CHAIN_TIMED in ORDER, and their outputs bit for bit."""
    from veloslam_tpu_torch.graph import chain
    clock = cs.sm_clock_hz()
    for K in cs.CHAIN_TIMED:
        D, B, r = cs.chain_inputs(K, torch.device("cuda", 0))
        out, rows = {}, []
        runs = 20 if K <= 4096 else 5
        for name in ORDER:
            use(name)
            U, L = chain.chain_factor(D, B)
            z = chain.chain_solve(U, L, B, r)
            torch.cuda.synchronize()
            out[name] = (U, L, z)
            f_ms = cs._events_ms(lambda: chain.chain_factor(D, B), runs)
            s_ms = cs._events_ms(lambda: chain.chain_solve(U, L, B, r), runs)
            rows.append(f"{name} factor {f_ms * 1e6 / K:.1f} solve "
                        f"{s_ms * 1e6 / K:.1f}")
        same = [cs._same_bits(a, b) for a, b in zip(out["this"],
                                                      out["other"])]
        lat = {k: cs.chain_latency_ms(K, ops, clock) * 1e6 / K
               for k, ops in (("factor", cs.CHAIN_FACTOR_OPS),
                              ("solve", cs.CHAIN_SOLVE_OPS))}
        print(f"[profile_chain] K={K}: ns per step (CUDA events, median of "
              f"{runs}) {'; '.join(rows)}; latency bound factor "
              f"{lat['factor']:.1f}, solve {lat['solve']:.1f} ns per step at "
              f"{clock / 1e9:.3f} GHz; this build's Uinv, L, z equal to the "
              f"other's to the bit: {same}; {smi}", flush=True)


def time_pcg(use, smi: str) -> None:
    """One pose-only PCG solve at K = 16384 per entry of ORDER."""
    from veloslam_tpu_torch.graph import pcg
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    p = cs.PCG_GRAPHS["chain"]
    f, _ = cs.pcg_graph(p)
    g = GraphArrays(**{k: torch.as_tensor(v, device="cuda")
                       for k, v in f.items()})
    kw = dict(max_poses=p["K"], iterations=cs.PCG_ITERATIONS,
              cg_iters=cs.PCG_CG_ITERS)
    pcg.solve_pcg(g, **kw)                      # warm: the card's libraries
    rows, pos = [], {}
    for name in ORDER:
        use(name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out, _ = pcg.solve_pcg(g, **kw)
        end.record()
        end.synchronize()
        rows.append(f"{name} {start.elapsed_time(end):.1f}")
        pos[name] = out.t[:p["n"]].cpu().numpy()
    print(f"[profile_chain] pose-only PCG at K={p['K']} ({p['n']} poses, "
          f"{cs.PCG_ITERATIONS} GN x {cs.PCG_CG_ITERS} CG iterations), ms "
          f"per solve (CUDA events): {'; '.join(rows)}; positions equal to "
          f"the bit: {np.array_equal(pos['this'], pos['other'])}; {smi}",
          flush=True)


def show_rcp() -> None:
    """This build's SASS: chain_factor_kernel from its first MUFU.RCP."""
    from veloslam_tpu_torch import _build
    tool = (shutil.which("cuobjdump")
            or str(Path(_build.find_nvcc()).parent / "cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(_build.library_path("chain"))],
                          capture_output=True, text=True, check=True).stdout
    lines = sass.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "Function" in ln and "chain_factor" in ln)
    rcp = next(i for i in range(start, len(lines)) if "MUFU.RCP" in lines[i])
    print("[profile_chain] chain_factor_kernel's first reciprocal (SASS):\n"
          + "\n".join(lines[rcp - 4:rcp + 14]), flush=True)
    body = lines[start:]
    end = next((i for i, ln in enumerate(body[1:], 1) if "Function" in ln),
               len(body))
    counts = {op: sum(op in ln for ln in body[:end])
              for op in ("FFMA", "SHFL", "MUFU.RCP", "LDS", "STG", "BRA")}
    print(f"[profile_chain] chain_factor_kernel SASS instruction counts "
          f"{counts}", flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = cs.phase_device()
    cs.phase_build()
    use = kernels(build_other(Path(sys.argv[1])))
    time_steps(use, smi)
    time_pcg(use, smi)
    show_rcp()
    return 0


if __name__ == "__main__":
    sys.exit(main())
