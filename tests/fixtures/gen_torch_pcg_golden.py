"""Generate pcg_golden.npz: the JAX package's matrix-free PCG pose-graph
solvers at the sizes they exist for, for the port to be held to.

The graphs come from chip_smoke.py::pcg_graph (numpy only, seeded), which
the port's `pcg` phase builds again on the card:

  * "chain": tests/test_graph.py::test_pcg_scales_past_dense_ceiling's
    drifted 500-pose-lap chain run to 16000 poses in the keyframe ring's
    cap of 16384 rows, a closure every 100 poses from the second lap on;
    graph.pcg.solve_pcg (chain preconditioner);
  * "landmarks": ::test_pcg_landmarks_scales_past_dense_ceiling's
    4096-pose chain with 16 posts seen from every 8th pose;
    graph.pcg.solve_pcg_landmarks.

Both at the production iterations = 8, cg_iters = 96.  The npz keeps, per
graph, the solved positions of the real poses (and landmarks), the
initial and final costs, the RMS position error against the truth before
and after, and the solve's seconds here; the graphs' parameters are
chip_smoke.PCG_GRAPHS, stored as JSON under "config".

Run from the repository root (JAX on the CPU; ~25 s on 8 cores, the
solves 11 s and 7 s with their compiles; < 1 GB):
    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_pcg_golden.py
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "pcg_golden.npz")


def main():
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import chip_smoke as cs
    from veloslam_tpu.graph import pcg
    from veloslam_tpu.graph.posegraph import GraphArrays

    out = {"config": json.dumps({"graphs": cs.PCG_GRAPHS,
                                 "iterations": cs.PCG_ITERATIONS,
                                 "cg_iters": cs.PCG_CG_ITERS})}
    for name, p in cs.PCG_GRAPHS.items():
        f, true_t = cs.pcg_graph(p)
        g = GraphArrays(**{k: jnp.asarray(v) for k, v in f.items()})
        kw = dict(max_poses=p["K"], iterations=cs.PCG_ITERATIONS,
                  cg_iters=cs.PCG_CG_ITERS)
        if name == "landmarks":
            solve = pcg.solve_pcg_landmarks
            kw["max_landmarks"] = p["M"]
        else:
            solve = pcg.solve_pcg
        t0 = time.perf_counter()
        res, stats = solve(g, **kw)
        jax.block_until_ready(res)
        secs = time.perf_counter() - t0
        n = p["n"]
        t = np.asarray(res.t)[:n]

        def rmse(x):
            return float(np.sqrt(np.mean(np.sum((x - true_t) ** 2, -1))))
        r = {"t": t, "initial_cost": float(stats.initial_cost),
             "final_cost": float(stats.final_cost),
             "rmse_before": rmse(f["t"][:n]), "rmse_after": rmse(t),
             "seconds": secs}
        if name == "landmarks":
            r["l_pos"] = np.asarray(res.l_pos)[:int(f["n_landmarks"])]
        for k, v in r.items():
            out[f"{name}_{k}"] = v
        print(f"{name}: K={p['K']} n={n} cost {r['initial_cost']:.4g} -> "
              f"{r['final_cost']:.4g}, RMSE vs truth {r['rmse_before']:.4f}"
              f" -> {r['rmse_after']:.4f} m; {secs:.1f} s (compile "
              "included)", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
