"""The port's multi-device package (veloslam_tpu_torch/parallel/) against
the JAX package's parallel/ on the same numpy inputs.

The port runs in Gloo worlds of 2 and 4 CPU ranks, each world spawned
once for this module (tests/torch_multihost_worker.py::parallel_rank,
through dist.spawn_ranks: a free port, a timeout on the process group
and on every join); the JAX side runs in this process on the conftest's
8-device CPU mesh with map = the world size.  Integers match exactly;
floats within the tolerance each test states, with its reason; every
replicated output is equal to the bit across ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from test_graph import _noisy_circle_graph
from test_halo import _scene
from test_registration import _pad, _static_scan
from torch_helpers import n, port_pose, t
from torch_helpers import small_threads  # noqa: F401
import torch_multihost_worker as worker
from veloslam_tpu.config import MeshConfig as JMeshConfig
from veloslam_tpu.core import se3 as jse3
from veloslam_tpu.decode import calibration as jcal
from veloslam_tpu.decode.decode import DeviceCalib as JDeviceCalib
from veloslam_tpu.io import simulate as jsim
from veloslam_tpu.parallel import dist as jdist
from veloslam_tpu.parallel import halo as jhalo
from veloslam_tpu.parallel import mesh as jmesh
from veloslam_tpu.parallel import sharded as jsharded
from veloslam_tpu.registration import gicp as jgicp
from veloslam_tpu.registration import voxel as jvx
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.decode import calibration as cal
from veloslam_tpu_torch.decode.decode import DeviceCalib, decode_packets
from veloslam_tpu_torch.graph.posegraph import relative_pose_measurement
from veloslam_tpu_torch.parallel import dist, halo
from veloslam_tpu_torch.registration import gicp
from veloslam_tpu_torch.registration import voxel as vx

WORLDS = (2, 4)
TIMEOUT_S = 300


def _grid_leaves(pg) -> dict:
    g = pg.grid
    return {"keys": n(g.keys), "count": n(g.count), "mean": n(g.mean),
            "cov": n(g.cov), "origin": n(g.origin),
            "voxel_size": n(g.voxel_size), "normal": n(pg.normal),
            "usable": n(pg.usable)}


def _landmark_graph():
    """tests/test_parallel.py's graph: a 24-pose noisy circle with a
    closure and three landmarks seen from every third pose."""
    rng = np.random.default_rng(11)
    g, true = _noisy_circle_graph(rng, n=24, drift=0.04, yaw_drift=0.01,
                                  max_poses=32, max_edges=64)
    rel_q, rel_t = relative_pose_measurement(port_pose(true[23]),
                                             port_pose(true[0]))
    g.add_edge(23, 0, rel_q, rel_t, info=(1000.0,) * 6)
    for lx, ly in ((5.0, 8.0), (30.0, 20.0), (15.0, 35.0)):
        li = g.add_landmark(np.array([lx, ly, 1.0], np.float32))
        for k in range(0, 24, 3):
            z = jse3.apply(jse3.inverse(true[k]),
                           jnp.asarray([lx, ly, 1.0], jnp.float32))
            g.add_observation(k, li, np.asarray(z), info=8.0)
    return g


def _halo_target(seed: int, capacity: int = 1024):
    """tests/test_halo.py's plane-cluster scene as a padded scan and its
    1 m plane grid (JAX)."""
    pts = _scene(np.random.default_rng(seed))
    P = 1 << int(np.ceil(np.log2(len(pts))))
    pad = np.zeros((P, 3), np.float32)
    msk = np.zeros(P, bool)
    pad[:len(pts)] = pts
    msk[:len(pts)] = True
    return pad, msk, jgicp.build_plane_grid(
        jnp.asarray(pad), jnp.asarray(msk), np.zeros(3), 1.0,
        capacity=capacity)


def _boundary_queries(target, S: int):
    """One query per interior shard boundary, on the last occupied voxel
    of each lower shard (test_halo's probe), 64 slots a shard."""
    keys = np.asarray(target.grid.keys)
    means = np.asarray(target.grid.mean)
    occ = keys != jvx.INVALID_KEY
    per = len(keys) // S
    qpts = np.zeros((S * 64, 3), np.float32)
    qmask = np.zeros(S * 64, bool)
    for shard in range(S - 1):
        rows = np.arange(shard * per, (shard + 1) * per)
        rows = rows[occ[rows]]
        if len(rows):
            qpts[shard * 64] = means[rows[-1]]
            qmask[shard * 64] = True
    return qpts, qmask


@pytest.fixture(scope="module")
def scene():
    """Every input, numpy, made from seeds; shared by both worlds."""
    world = jsim.World.demo(seed=5, n_posts=30, n_walls=10)
    tgt = _static_scan(world, np.array([0.0, 0.0, 2.0]), 0.0)
    t_gt = np.array([0.15, 0.3, 0.02], np.float32)
    src = _static_scan(world, np.array([0.0, 0.0, 2.0]) + t_gt,
                       np.deg2rad(1.5))
    tp, tm = _pad(tgt, 32768)
    sp, sm = _pad(src, 32768)
    grid = jgicp.build_plane_grid(tp, tm, np.zeros(3), 1.0, capacity=8192)
    seq = jsim.generate_sequence(duration_s=0.1, model="hdl32", seed=2)
    lg = _landmark_graph()
    hpad, hmsk, htarget = _halo_target(0)
    rpad, rmsk, rtarget = _halo_target(1)
    T = jse3.Pose(jse3.quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]),
                                            jnp.asarray(0.02)),
                  jnp.asarray([0.2, -0.15, 0.05]))
    rsrc = np.asarray(jse3.apply(T, jnp.asarray(rpad)))
    return {"jgrid": grid, "grid": _grid_leaves(grid), "t_gt": t_gt,
            "src": n(sp), "src_mask": n(sm),
            "ne_src": n(sp)[::8].copy(), "ne_mask": n(sm)[::8].copy(),
            "ne_q": np.array([0.9998, 0.0, 0.0, 0.02], np.float32)
            / np.linalg.norm([0.9998, 0.0, 0.0, 0.02]).astype(np.float32),
            "ne_t": np.array([0.1, 0.25, 0.0], np.float32),
            "packets": seq["packets"][:64],
            "jgraph": lg, "graph": {k: n(v) for k, v in
                                    lg.arrays()._asdict().items()},
            "graph_K": lg.K, "graph_M": lg.M,
            "jhalo_grid": htarget, "halo_grid": _grid_leaves(htarget),
            "jhalo_reg_grid": rtarget,
            "halo_reg_grid": _grid_leaves(rtarget), "halo_src": rsrc,
            "halo_src_mask": rmsk, "halo_T": T}


def _rank_inputs(sc: dict, S: int) -> dict:
    keys = n(sc["jhalo_reg_grid"].grid.keys)
    h = 2 * jhalo.required_halo(keys, S) + 16
    p_r, m_r = jhalo.partition_points_by_key_ranges(
        keys, sc["halo_src"], sc["halo_src_mask"], np.zeros(3), 1.0, S)
    qpts, qmask = _boundary_queries(sc["jhalo_grid"], S)
    inp = {k: v for k, v in sc.items() if not k.startswith("j")
           and k not in ("t_gt", "halo_src", "halo_src_mask", "halo_T")}
    inp.update(halo_pts=p_r, halo_mask=m_r, halo_width=h, query_pts=qpts,
               query_mask=qmask)
    return inp


@pytest.fixture(scope="module", params=WORLDS, ids=lambda S: f"world{S}")
def world(request, scene):
    """(S, the S ranks' results, the rank inputs, the JAX mesh map=S)."""
    S = request.param
    inp = _rank_inputs(scene, S)
    ranks = dist.spawn_ranks(worker.parallel_rank, S, backend="gloo",
                             device="cpu", args=(inp,), timeout_s=TIMEOUT_S)
    mesh = jmesh.make_mesh(JMeshConfig(data_axis=1, map_axis=S))
    return S, ranks, inp, mesh


def _put(mesh, tree, specs):
    return jax.tree.map(lambda a, s: jax.device_put(
        np.asarray(a), NamedSharding(mesh, s)), tree, specs)


def _same_bits(ranks, key):
    """`key`'s value (a dict of arrays and numbers) is equal to the bit on
    every rank."""
    for r in ranks[1:]:
        for k, v in ranks[0][key].items():
            np.testing.assert_array_equal(np.asarray(r[key][k]),
                                          np.asarray(v), err_msg=f"{key} {k}")


# --- host helpers: exact ----------------------------------------------------------

def test_tile_owner_matches_jax():
    ix, iy = np.meshgrid(np.arange(-300, 300), np.arange(-200, 200))
    for shards in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(
            dist.tile_owner(ix.ravel(), iy.ravel(), shards),
            jdist.tile_owner(ix.ravel(), iy.ravel(), shards))
    big = np.array([2**31 - 1, -2**31, 123456789], np.int64)
    np.testing.assert_array_equal(dist.tile_owner(big, big[::-1], 7),
                                  jdist.tile_owner(big, big[::-1], 7))


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_plane_grid_rows_matches_jax(scene, shards):
    """Each shard's rows (hash-owned tiles, key-sorted, padded) equal
    the JAX package's; the shards are disjoint and cover the grid."""
    jgrid = scene["jgrid"]
    pg = worker.plane_grid(scene["grid"], "cpu")
    seen = 0
    for pid in range(shards):
        rows, origin, vs = dist.partition_plane_grid_rows(pg, pid, shards)
        jrows, jorigin, jvs = jdist.partition_plane_grid_rows(jgrid, pid,
                                                              shards)
        for a, b in zip(rows, jrows):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(origin, jorigin)
        assert float(vs) == float(jvs)
        seen += int((rows[0] != vx.INVALID_KEY).sum())
    assert seen == int((n(jgrid.grid.keys) != jvx.INVALID_KEY).sum())


def test_halo_helpers_match_jax(scene):
    """required_halo, halo_is_exact, the clamp's warning, the float32
    key packing and the key-range router, value for value."""
    keys = n(scene["jhalo_reg_grid"].grid.keys)
    for S in (2, 3, 4, 8):
        assert halo.required_halo(keys, S) == jhalo.required_halo(keys, S)
        for h in (0, 8, 64, 512):
            assert halo.halo_is_exact(keys, S, h) == jhalo.halo_is_exact(
                keys, S, h)
        p_r, m_r = halo.partition_points_by_key_ranges(
            keys, scene["halo_src"], scene["halo_src_mask"], np.zeros(3),
            1.0, S)
        jp, jm = jhalo.partition_points_by_key_ranges(
            keys, scene["halo_src"], scene["halo_src_mask"], np.zeros(3),
            1.0, S)
        np.testing.assert_array_equal(p_r, jp)
        np.testing.assert_array_equal(m_r, jm)
    gap = np.array([5, 6, 7, 8, (1 << 20) + 200, (2 << 20) + 100,
                    (2 << 20) + 199, 4 << 20], np.int64)
    assert halo.required_halo(gap, 2) == jhalo.required_halo(gap, 2) >= 3
    pts = np.array([[4.8, 0.05, 0.05], [-1.0, 3.3, 900.0]], np.float32)
    np.testing.assert_array_equal(
        halo._pack_keys_np(pts, np.ones(2, bool), np.zeros(3), 0.1),
        jhalo._pack_keys_np(pts, np.ones(2, bool), np.zeros(3), 0.1))
    with pytest.warns(RuntimeWarning, match="clamped"):
        assert halo._clamp_halo(300, 1024, 4, "test") == 256


# --- map-sharded registration ------------------------------------------------------

@pytest.mark.parametrize("search", ["dense", "search"])
def test_register_sharded_matches_jax_and_one_rank(world, scene, search):
    """The production schedule (16 iterations, reassociate every 8, a
    DenseIndex per shard or the binary search): within 1e-4 of the JAX
    package's register_sharded on map = S (float32 GN steps in another
    summation order, the register tests' tolerance), n_matched equal;
    within 1e-6 of the port's own gicp.register on the whole map (the
    global argmin picks the single map's voxel, so only ties could
    differ); 2 collectives, one all_gather per association block; the
    ranks equal to the bit."""
    S, ranks, inp, mesh = world
    use_dense = search == "dense"
    jgrid = scene["jgrid"]
    want = jsharded.register_sharded(
        mesh, jnp.asarray(inp["src"]), jnp.asarray(inp["src_mask"]),
        _put(mesh, jgrid, jsharded.plane_grid_specs("map")),
        jse3.Pose.identity(), iterations=16, reassociate_every=8,
        use_dense=use_dense)
    full = worker.plane_grid(inp["grid"], "cpu")
    one = gicp.register(t(inp["src"]), t(inp["src_mask"]), full,
                        se3.Pose.identity(),
                        vx.build_dense_index(full.grid) if use_dense
                        else None, iterations=16, reassociate_every=8)
    got = ranks[0][f"register_{search}"]
    np.testing.assert_allclose(got["t"], n(want.pose.t), atol=1e-4)
    np.testing.assert_allclose(got["q"], n(want.pose.q), atol=1e-4)
    assert got["n_matched"] == int(want.n_matched)
    np.testing.assert_allclose(got["t"], n(one.pose.t), atol=1e-6)
    np.testing.assert_allclose(got["q"], n(one.pose.q), atol=1e-6)
    assert got["n_matched"] == int(one.n_matched)
    np.testing.assert_allclose(got["t"], scene["t_gt"], atol=0.05)
    _same_bits(ranks, f"register_{search}")
    for r in ranks:
        assert r[f"register_{search}_collectives"] == {
            "all_reduce": 0, "all_gather": 2, "ring": 0}


def test_sharded_normal_equations_matches_jax(world, scene):
    """One linearization of 4096 scan points against the sharded map
    (binary-search association per shard), H and b within 1e-4·max|H| +
    1e-3 of JAX's (float32 sums in another order, the NE tests'
    tolerance), n equal, err within 1e-5."""
    S, ranks, inp, mesh = world
    # Under jit: run eagerly, the shard_map takes seconds a call.
    H, b, err, n_hit = jax.jit(
        lambda p, m, q, tr, g: jsharded.sharded_normal_equations(
            mesh, p, m, jse3.Pose(q, tr), g))(
        jnp.asarray(inp["ne_src"]), jnp.asarray(inp["ne_mask"]),
        jnp.asarray(inp["ne_q"]), jnp.asarray(inp["ne_t"]),
        _put(mesh, scene["jgrid"], jsharded.plane_grid_specs("map")))
    got = ranks[0]["normal_equations"]
    lim = 1e-4 * float(np.abs(n(H)).max()) + 1e-3
    assert np.abs(got["H"] - n(H)).max() <= lim
    assert np.abs(got["b"] - n(b)).max() <= 1e-4 * float(
        np.abs(n(b)).max()) + 1e-3
    assert got["n"] == int(n_hit) > 500
    np.testing.assert_allclose(got["err"], float(err), rtol=1e-5)
    _same_bits(ranks, "normal_equations")


# --- data-parallel decode --------------------------------------------------------------

def test_decode_packets_sharded(world):
    """The gathered points equal the port's decode_packets on all the
    packets to the bit (the same per-packet arithmetic), on the S × 1 mesh
    and at four ranks on the 2 × 2 mesh's "data" axis; within 1e-4 of
    the JAX package's decode_packets_sharded (the decode tests'
    tolerance)."""
    S, ranks, inp, _ = world
    whole = n(decode_packets(t(inp["packets"]), DeviceCalib.from_host(
        cal.hdl32(), device="cpu"), model="hdl32").xyz)
    dmesh = jmesh.make_mesh(JMeshConfig(data_axis=S, map_axis=1))
    want = n(jsharded.decode_packets_sharded(
        dmesh, jnp.asarray(inp["packets"]),
        JDeviceCalib.from_host(jcal.hdl32()), model="hdl32"))
    for r in ranks:
        np.testing.assert_array_equal(r["decode"], whole)
        if S == 4:
            np.testing.assert_array_equal(r["decode_2x2"], whole)
    np.testing.assert_allclose(ranks[0]["decode"], want, atol=1e-4, rtol=0)
    if S == 4:
        assert [r["coords_2x2"] for r in ranks] == [
            {"data": d, "map": m} for d in (0, 1) for m in (0, 1)]


# --- edge-sharded graph solves ---------------------------------------------------------

def test_solve_graph_step_sharded_matches_jax(world, scene):
    """One step: positions within 2e-3 and rotations within 1e-4 of the
    JAX package's (the dense-solve tests' tolerances: float32 Cholesky
    of a 1e6-gauged matrix); the cost within 1e-3 relative."""
    S, ranks, _, mesh = world
    jg = scene["jgraph"]
    want, cost = jsharded.solve_graph_step_sharded(mesh, jg.arrays(),
                                                   max_poses=jg.K)
    got = ranks[0]["graph_step"]
    np.testing.assert_allclose(got["t"], n(want.t), atol=2e-3)
    np.testing.assert_allclose(got["q"], n(want.q), atol=1e-4)
    np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-3)
    _same_bits(ranks, "graph_step")


@pytest.mark.parametrize("with_landmarks", [False, True])
def test_solve_graph_sharded_matches_jax(world, scene, with_landmarks):
    """Six iterations, pose-only and with the Schur-eliminated landmarks
    (observations split over the ranks): within 2e-3 m / 1e-4 of JAX's
    solve_graph_sharded on map = S, landmarks within 2e-3 m."""
    S, ranks, _, mesh = world
    jg = scene["jgraph"]
    want, _ = jsharded.solve_graph_sharded(
        mesh, _put(mesh, jg.arrays(), jsharded._graph_specs()),
        max_poses=jg.K, max_landmarks=jg.M, iterations=6,
        with_landmarks=with_landmarks)
    key = f"graph_solve_{int(with_landmarks)}"
    got = ranks[0][key]
    np.testing.assert_allclose(got["t"], n(want.t), atol=2e-3)
    np.testing.assert_allclose(got["q"], n(want.q), atol=1e-4)
    np.testing.assert_allclose(got["l_pos"], n(want.l_pos), atol=2e-3)
    _same_bits(ranks, key)


def test_graph_edges_that_do_not_split_raise(scene):
    """An edge count the "map" size does not divide raises (the crop
    buckets are multiples of 8; JAX's shard_map refuses the same)."""
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    from veloslam_tpu_torch.parallel import sharded
    from veloslam_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(1, 3, "cpu", {"data": None, "map": None}, None)
    g = GraphArrays(**{k: t(v) for k, v in scene["graph"].items()})
    with pytest.raises(ValueError, match="do not split"):
        sharded.solve_graph_step_sharded(mesh, g, max_poses=scene["graph_K"])


# --- halo exchange ----------------------------------------------------------------------

def test_exchange_and_extend_matches_jax(world, scene):
    """Each rank's extended shard (its rows + both neighbours' 256-row
    bands, key-sorted) equals block r of JAX's exchange_and_extend, every
    field to the bit (data movement only)."""
    S, ranks, _, mesh = world
    ext = jhalo.exchange_and_extend(
        mesh, _put(mesh, scene["jhalo_grid"], jhalo._plane_specs("map")))
    want = {"keys": n(ext.grid.keys), "mean": n(ext.grid.mean),
            "cov": n(ext.grid.cov), "count": n(ext.grid.count),
            "normal": n(ext.normal), "usable": n(ext.usable)}
    per = len(want["keys"]) // S
    assert per == 1024 // S + 2 * jhalo.HALO
    for r in ranks:
        i = r["coords"]["map"]
        for k, v in want.items():
            np.testing.assert_array_equal(r["extended"][k],
                                          v[i * per:(i + 1) * per],
                                          err_msg=k)


def test_sharded_query_local_matches_jax(world, scene):
    """Boundary queries through the extended shards: the hits and the
    matched means equal JAX's sharded_query_local."""
    S, ranks, inp, mesh = world
    ext = jhalo.exchange_and_extend(
        mesh, _put(mesh, scene["jhalo_grid"], jhalo._plane_specs("map")))
    mu, hit = jhalo.sharded_query_local(mesh, ext,
                                        jnp.asarray(inp["query_pts"]),
                                        jnp.asarray(inp["query_mask"]))
    got_mu = np.concatenate([r["query"]["mu"] for r in ranks])
    got_hit = np.concatenate([r["query"]["hit"] for r in ranks])
    np.testing.assert_array_equal(got_hit, n(hit))
    np.testing.assert_array_equal(got_mu, n(mu))
    assert got_hit[inp["query_mask"]].all()


def test_register_halo_sharded_matches_jax(world, scene):
    """Points routed by key range, haloed shards, one 44-float
    all_reduce per GN iteration: within 1e-4 of JAX's
    register_halo_sharded (float32 sums in another order), n_matched
    equal; both recover the injected offset; 12 all_reduces and one ring
    exchange; the ranks equal to the bit."""
    S, ranks, inp, mesh = world
    want = jhalo.register_halo_sharded(
        mesh, jnp.asarray(inp["halo_pts"]), jnp.asarray(inp["halo_mask"]),
        _put(mesh, scene["jhalo_reg_grid"], jhalo._plane_specs("map")),
        jse3.Pose.identity(), iterations=12, halo=inp["halo_width"])
    got = ranks[0]["register_halo"]
    np.testing.assert_allclose(got["t"], n(want.pose.t), atol=1e-4)
    np.testing.assert_allclose(got["q"], n(want.pose.q), atol=1e-4)
    assert got["n_matched"] == int(want.n_matched)
    rec = jse3.compose(jse3.Pose(jnp.asarray(got["q"]),
                                 jnp.asarray(got["t"])), scene["halo_T"])
    np.testing.assert_allclose(n(rec.t), 0.0, atol=0.05)
    _same_bits(ranks, "register_halo")
    for r in ranks:
        assert r["register_halo_collectives"] == {
            "all_reduce": 12, "all_gather": 0, "ring": 1}


# --- the runtime: no silent fallback, a failing rank fails the run -----------------

def test_requests_that_cannot_be_met_raise(monkeypatch):
    """NCCL on the CPU, an unknown backend, a CUDA device without a card
    and NCCL with more local ranks than cards raise; gloo on the CPU is
    taken only as asked."""
    with pytest.raises(ValueError, match="NCCL"):
        dist.rank_device("cpu", "nccl", 0, 1)
    with pytest.raises(ValueError, match="backend"):
        dist.rank_device("cpu", "mpi", 0, 1)
    assert dist.rank_device("cpu", "gloo", 3, 4) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.rank_device("cuda", "gloo", 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        dist.rank_device("cuda", "nccl", 0, 2)
    assert dist.rank_device("cuda", "gloo", 1, 2) == torch.device("cuda", 0)
    # One process, nothing to start: the device comes back, no group.
    assert dist.init_distributed(num_processes=1, backend="gloo",
                                 device="cpu") == torch.device("cpu")
    assert dist.process_count() == 1


def _raise_on_rank_one(device):
    if torch.distributed.get_rank() == 1:
        print("rank one prints this, then fails")
        raise ValueError("rank one failed on purpose")
    return "fine"


def _hang(device):
    import time
    time.sleep(600)


def test_a_failing_or_hung_rank_fails_the_run_with_its_output():
    with pytest.raises(RuntimeError) as err:
        dist.spawn_ranks(_raise_on_rank_one, 2, backend="gloo",
                         device="cpu", timeout_s=120)
    assert "rank one prints this, then fails" in str(err.value)
    assert "rank one failed on purpose" in str(err.value)
    with pytest.raises(RuntimeError, match="not done within"):
        dist.spawn_ranks(_hang, 1, backend="gloo", device="cpu",
                         timeout_s=5)


def test_the_ranks_load_no_jax(world):
    """The spawned ranks loaded nothing of jax or of the JAX package:
    they import the port only."""
    _, ranks, _, _ = world
    for r in ranks:
        assert r["jax_modules"] == []


def test_multihost_golden_is_its_generators_and_self_consistent():
    """tests/fixtures/multihost_golden_seed3.npz holds its generator's
    drives and configs (the port rebuilds each SlamConfig unchanged), and
    the JAX session it recorded: the two ranks equal to the bit, their
    tiles disjoint with the single-process oracle's map as their union."""
    import dataclasses
    import json

    import chip_smoke as cs
    from fixtures.gen_torch_multihost_golden import golden_config
    from veloslam_tpu_torch.config import MeshConfig, SlamConfig
    gold = np.load(cs.MULTICHIP_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    assert cfg == golden_config()
    for d in cfg["drives"]:
        back = dataclasses.asdict(SlamConfig.from_dict(d["slam"]))
        assert back.pop("mesh") == dataclasses.asdict(MeshConfig())
        assert json.loads(json.dumps(back)) == d["slam"]
        name = d["name"]
        for k in ("times_us", "positions", "stream_positions",
                  "quaternions"):
            np.testing.assert_array_equal(gold[f"{name}_p0_{k}"],
                                          gold[f"{name}_p1_{k}"])
        t0, t1 = ({tuple(x) for x in gold[f"{name}_p{r}_tiles"].tolist()}
                  for r in (0, 1))
        assert not t0 & t1
        assert t0 | t1 == {tuple(x) for x in
                           gold[f"{name}_oracle_tiles"].tolist()}
