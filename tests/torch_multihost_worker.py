"""Rank bodies for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_multihost.py; the
session's rank body is chip_smoke.multichip_session_rank).

Each function runs on one rank spawned by
veloslam_tpu_torch.parallel.dist.spawn_ranks as fn(device, *args) inside
a process group, and returns numpy results for the test process to
compare.  This module imports no jax: the ranks load only the port.
"""

import sys

import numpy as np
import torch

from veloslam_tpu_torch.config import MeshConfig
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.decode import calibration as calib_mod
from veloslam_tpu_torch.decode.decode import DeviceCalib
from veloslam_tpu_torch.graph.posegraph import GraphArrays
from veloslam_tpu_torch.parallel import dist, halo, sharded
from veloslam_tpu_torch.parallel.mesh import block, make_mesh
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.registration.gicp import PlaneGrid, make_plane_grid


def plane_grid(leaves: dict, device) -> PlaneGrid:
    """A PlaneGrid from numpy leaves keys, count, mean, cov, origin,
    voxel_size, normal, usable."""
    t = {k: torch.as_tensor(np.array(v), device=device)
         for k, v in leaves.items()}
    grid = vx.VoxelGrid(keys=t["keys"], count=t["count"], mean=t["mean"],
                        cov=t["cov"], origin=t["origin"],
                        voxel_size=t["voxel_size"])
    return make_plane_grid(grid, t["normal"], t["usable"])


def _np(x):
    return x.detach().cpu().numpy()


def _result(res) -> dict:
    return {"q": _np(res.pose.q), "t": _np(res.pose.t),
            "n_matched": int(res.n_matched),
            "mean_error": float(res.mean_error)}


def parallel_rank(device, inp: dict) -> dict:
    """Every sharded call of the parity tests on this rank's mesh (all
    ranks on "map"; decode on "data", and at four ranks also on the
    2 × 2 mesh's "data" axis)."""
    torch.set_num_threads(1)
    n = dist.process_count()
    mesh = make_mesh(MeshConfig(data_axis=1, map_axis=n), device)
    out = {"rank": mesh.rank, "coords": mesh.coords}

    # Map-sharded registration, the production schedule.
    full = plane_grid(inp["grid"], device)
    shard = sharded.shard_plane_grid(mesh, full)
    src = torch.as_tensor(inp["src"], device=device)
    msk = torch.as_tensor(inp["src_mask"], device=device)
    ident = se3.Pose.identity()
    for name, use_dense in (("dense", True), ("search", False)):
        before = dict(dist.COLLECTIVES)
        res = sharded.register_sharded(
            mesh, src, msk, shard, se3.Pose(ident.q.to(device),
                                            ident.t.to(device)),
            iterations=16, reassociate_every=8, use_dense=use_dense)
        out[f"register_{name}"] = _result(res)
        out[f"register_{name}_collectives"] = {
            k: dist.COLLECTIVES[k] - before[k] for k in before}
    pose = se3.Pose(torch.as_tensor(inp["ne_q"], device=device),
                    torch.as_tensor(inp["ne_t"], device=device))
    H, b, err, n_hit = sharded.sharded_normal_equations(
        mesh, torch.as_tensor(inp["ne_src"], device=device),
        torch.as_tensor(inp["ne_mask"], device=device), pose, shard)
    out["normal_equations"] = {"H": _np(H), "b": _np(b),
                               "err": float(err), "n": int(n_hit)}

    # Data-parallel decode.
    cal = DeviceCalib.from_host(calib_mod.hdl32(), device=device)
    pkts = torch.as_tensor(inp["packets"], device=device)
    out["decode"] = _np(sharded.decode_packets_sharded(
        make_mesh(MeshConfig(data_axis=n, map_axis=1), device), pkts, cal,
        model="hdl32"))
    if n == 4:
        grid2 = make_mesh(MeshConfig(data_axis=2, map_axis=2), device)
        out["decode_2x2"] = _np(sharded.decode_packets_sharded(
            grid2, pkts, cal, model="hdl32"))
        out["coords_2x2"] = grid2.coords

    # Edge-sharded graph solves.
    g = GraphArrays(**{k: torch.as_tensor(np.array(v), device=device)
                       for k, v in inp["graph"].items()})
    K, M = inp["graph_K"], inp["graph_M"]
    stepped, cost = sharded.solve_graph_step_sharded(mesh, g, max_poses=K)
    out["graph_step"] = {"t": _np(stepped.t), "q": _np(stepped.q),
                         "cost": float(cost)}
    for lm in (False, True):
        solved, cost = sharded.solve_graph_sharded(
            mesh, g, max_poses=K, max_landmarks=M, iterations=6,
            with_landmarks=lm)
        out[f"graph_solve_{int(lm)}"] = {
            "t": _np(solved.t), "q": _np(solved.q),
            "l_pos": _np(solved.l_pos), "cost": float(cost)}

    # Halo exchange and the halo registration.
    hfull = plane_grid(inp["halo_grid"], device)
    hshard = sharded.shard_plane_grid(mesh, hfull)
    ext = halo.exchange_and_extend(mesh, hshard)
    out["extended"] = {"keys": _np(ext.grid.keys), "mean": _np(ext.grid.mean),
                       "cov": _np(ext.grid.cov), "count": _np(ext.grid.count),
                       "normal": _np(ext.normal), "usable": _np(ext.usable)}
    q_pts = block(torch.as_tensor(inp["query_pts"], device=device), mesh,
                  "map")
    q_msk = block(torch.as_tensor(inp["query_mask"], device=device), mesh,
                  "map")
    mu, hit = halo.sharded_query_local(mesh, ext, q_pts, q_msk)
    out["query"] = {"mu": _np(mu), "hit": _np(hit)}
    reg_full = plane_grid(inp["halo_reg_grid"], device)
    p_r = block(torch.as_tensor(inp["halo_pts"], device=device), mesh,
                "map")
    m_r = block(torch.as_tensor(inp["halo_mask"], device=device), mesh,
                "map")
    before = dict(dist.COLLECTIVES)
    res = halo.register_halo_sharded(
        mesh, p_r, m_r, sharded.shard_plane_grid(mesh, reg_full),
        se3.Pose(ident.q.to(device), ident.t.to(device)), iterations=12,
        halo=inp["halo_width"])
    out["register_halo"] = _result(res)
    out["register_halo_collectives"] = {
        k: dist.COLLECTIVES[k] - before[k] for k in before}
    out["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "veloslam_tpu"))
    return out


def nccl_rank(device, inp: dict) -> dict:
    """World 1 on the card over NCCL: register_sharded and
    decode_packets_sharded against gicp.register and decode_packets on
    the same card, and the kernel launches of the sharded calls."""
    from veloslam_tpu_torch.decode.decode import decode_packets
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import normal_equations as ne
    mesh = dist.global_mesh(device)
    full = plane_grid(inp["grid"], device)
    src = torch.as_tensor(inp["src"], device=device)
    msk = torch.as_tensor(inp["src_mask"], device=device)
    prior = se3.Pose.identity(device=device)
    kw = dict(iterations=16, reassociate_every=8)
    before = (ne.LAUNCHES, dict(ga.LAUNCHES))
    res = sharded.register_sharded(mesh, src, msk, full, prior,
                                   use_dense=True, **kw)
    torch.cuda.synchronize()
    launches = {"fused_normal_equations": ne.LAUNCHES - before[0],
                **{k: v - before[1][k] for k, v in ga.LAUNCHES.items()}}
    one = gicp.register(src, msk, full, prior,
                        vx.build_dense_index(full.grid), **kw)
    cal = DeviceCalib.from_host(calib_mod.hdl32(), device=device)
    pkts = torch.as_tensor(inp["packets"], device=device)
    return {"backend": mesh.backend, "sharded": _result(res),
            "single": _result(one), "launches": launches,
            "decode_equal": bool(torch.equal(
                sharded.decode_packets_sharded(mesh, pkts, cal,
                                               model="hdl32"),
                decode_packets(pkts, cal, model="hdl32").xyz))}
