"""The per-frame GICP chain as CUDA graphs (registration/cudagraphs.py)
and its eager fallback.

On the CPU: `gicp.register_batch`'s `association` argument left at its
default is `associate`, and `SlamPipeline._register_frame` registers
eagerly (no graph captured, no `register_graph` stage) with every method,
with and without the dense index, equal to the registration called
directly.  On a card (marked `cuda`, skipped where
torch.cuda.is_available() is false; this module imports no jax): over the
"small" golden drive the graphed per-frame registration equals the eager
one to the bit, one capture a pipeline, a replay every registered frame,
16 normal-equations launches a frame, and under the benchmark's control
the prior left uncorrected.  On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_gicp_graphs.py
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.core import se3
from veloslam_tpu_torch.registration import d2d, gicp, ndt
from veloslam_tpu_torch.registration import gather as ga
from veloslam_tpu_torch.registration import normal_equations as ne
from veloslam_tpu_torch.registration import voxel as vx
from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
from veloslam_tpu_torch.utils import profiling

GRAPH_STAGES = ("register_graph", "register_graph_capture")


def _surfaces(rng, n):
    """n points on a floor, four walls and a few posts of a 30 m room,
    1 cm of noise."""
    k = rng.integers(0, 3, n)
    u, v = rng.uniform(-15.5, 15.5, n), rng.uniform(-1.5, 2.5, n)
    side = rng.integers(0, 4, n)
    wall = np.stack([np.where(side < 2, np.where(side == 0, -15.5, 15.5), u),
                     np.where(side < 2, u, np.where(side == 2, -15.5, 15.5)),
                     v], -1)
    ang = rng.uniform(0, 2 * np.pi, n)
    post = rng.integers(0, 6, n)
    posts = np.stack([-10 + 4 * post + 0.3 * np.cos(ang),
                      5 - 2 * post + 0.3 * np.sin(ang), v], -1)
    floor = np.stack([u, rng.uniform(-15.5, 15.5, n), np.full(n, -1.5)],
                     -1)
    pts = np.where((k == 0)[:, None], floor,
                   np.where((k == 1)[:, None], wall, posts))
    return (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


def _pose(yaw, t):
    return se3.Pose(torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                                 dtype=torch.float32),
                    torch.tensor(t, dtype=torch.float32))


@pytest.fixture(scope="module")
def room():
    """A map scan and a frame scan of the room: the frame's points in the
    sensor frame of a pose 0.3 m and 0.02 rad off the world, padded to
    P = 4096 with its mask."""
    rng = np.random.default_rng(21)
    world = _surfaces(rng, 60000)
    truth = _pose(0.02, [0.3, -0.2, 0.0])
    scan = _surfaces(rng, 3500)
    local = se3.apply(se3.inverse(truth), torch.as_tensor(scan)).numpy()
    P = 4096
    pts = np.zeros((P, 3), np.float32)
    pts[:len(local)] = local
    mask = np.arange(P) < len(local)
    return world, pts, mask


def _target_and_scan(room):
    world, pts, mask = room
    grid = vx.build_grid(torch.as_tensor(world), torch.ones(len(world),
                                                            dtype=torch.bool),
                         torch.zeros(3), torch.tensor(1.0), capacity=8192)
    return (gicp.plane_grid_from(grid), grid, torch.as_tensor(pts)[None],
            torch.as_tensor(mask)[None])


@pytest.mark.parametrize("index", ["dense", "search"])
@pytest.mark.parametrize("reassociate_every", [1, 8])
def test_register_batch_association_defaults_to_associate(
        room, index, reassociate_every):
    """Left at its default, `association` is `associate`: the same
    result to the bit as passing `associate`, which runs once a block of
    `reassociate_every` iterations."""
    target, grid, pts, mask = _target_and_scan(room)
    dense = vx.build_dense_index(grid) if index == "dense" else None
    calls = []

    def counted(*args):
        calls.append(1)
        return gicp.associate(*args)

    kw = dict(iterations=16, reassociate_every=reassociate_every)
    prior = se3.Pose(torch.tensor([[1.0, 0, 0, 0]]), torch.zeros(1, 3))
    base = gicp.register_batch(pts, mask, target, prior, dense, **kw)
    seam = gicp.register_batch(pts, mask, target, prior, dense,
                               association=counted, **kw)
    assert len(calls) == -(-16 // reassociate_every)
    for a, b in ((base.pose.q, seam.pose.q), (base.pose.t, seam.pose.t),
                 (base.n_matched, seam.n_matched),
                 (base.mean_error, seam.mean_error), (base.H, seam.H)):
        assert torch.equal(a, b)
    assert int(base.n_matched[0]) > 1000
    assert float(torch.linalg.vector_norm(base.pose.t[0] - torch.tensor(
        [0.3, -0.2, 0.0]))) < 0.05


def _reference(pipe, roi, pts, mask, prior):
    """The frame's registration called directly, as the pipeline's eager
    path makes it."""
    rc = pipe.cfg.registration
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    if rc.method == "d2d":
        src = vx.build_grid(p, m, roi.origin, roi.voxel_size,
                            capacity=rc.scan_voxel_capacity)
        return d2d.register_d2d(src, roi, d2d.usable_mask(
            roi, min_points=rc.min_points_per_voxel), prior,
            iterations=rc.max_iterations, damping=rc.damping,
            max_dist=rc.max_correspondence_dist)
    if rc.method == "ndt":
        return ndt.register(p, m, ndt.build_ndt_grid(
            roi, min_points=rc.min_points_per_voxel), prior,
            iterations=rc.max_iterations,
            max_dist=rc.max_correspondence_dist)
    target = gicp.plane_grid_from(roi, min_points=rc.min_points_per_voxel,
                                  min_planarity=rc.min_planarity)
    dense = vx.build_dense_index(roi) if rc.use_dense_index else None
    return gicp.register(p, m, target, prior, dense,
                         iterations=rc.max_iterations, damping=rc.damping,
                         huber_delta=rc.huber_delta,
                         max_dist=rc.max_correspondence_dist,
                         reassociate_every=rc.reassociate_every)


@pytest.mark.parametrize("method,dense", [("gicp", True), ("gicp", False),
                                          ("d2d", True), ("ndt", True)])
def test_pipeline_registers_eagerly_on_the_cpu(room, method, dense):
    """On the CPU `_register_frame` captures no graph and opens no graph
    stage, with every method and with or without the dense index; its
    result equals the registration called directly, to the bit."""
    world, pts, mask = room
    cfg = SlamConfig()
    cfg = dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, method=method, use_dense_index=dense,
        max_points=len(pts)))
    pipe = SlamPipeline(cfg, device="cpu")
    pipe.map.integrate_points(world, np.ones(len(world), bool),
                              center=np.zeros(3))
    prior = _pose(0.0, [0.0, 0.0, 0.0])
    with profiling.recording(pipe.timers):
        got = pipe._register_frame(pts, mask, prior)
    assert pipe._reg_graphs is None
    stages = pipe.timers.summary()
    assert stages["register"]["count"] == 1
    assert not any(s in stages for s in GRAPH_STAGES)
    roi = pipe.map.roi_grid(0.0, 0.0)
    want = _reference(pipe, roi, pts, mask, prior)
    assert torch.equal(got.pose.q, want.pose.q)
    assert torch.equal(got.pose.t, want.pose.t)
    assert got.n_matched == int(want.n_matched)
    np.testing.assert_array_equal(got.mean_error, float(want.mean_error))
    assert got.n_matched > (cfg.registration.min_matched_voxels
                            if method == "d2d"
                            else cfg.registration.min_matched_points)


# --- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def card_drive(tmp_path_factory):
    """The "small" golden drive (GICP, dense index) written once, and a
    runner of one user run of it on the card that records each
    `_register_frame` call: its prior, its result, and the
    normal-equations and gather launches it made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    import chip_smoke as cs
    gold = np.load(cs.PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}["small"]
    paths, _ = cs.write_pipeline_drive(drive, cfg["model"],
                                       str(tmp_path_factory.mktemp("drive")))
    card = torch.device("cuda", 0)

    def run(graphed=True):
        calls = []
        orig = SlamPipeline._register_frame

        def recorded(self, pts, mask, T_prior):
            n0, g0 = ne.LAUNCHES, dict(ga.LAUNCHES)
            res = orig(self, pts, mask, T_prior)
            calls.append({"prior": (T_prior.q.numpy().copy(),
                                    T_prior.t.numpy().copy()),
                          "res": res, "ne": ne.LAUNCHES - n0,
                          "gather": {k: ga.LAUNCHES[k] - g0[k] for k in g0}})
            return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SlamPipeline, "_register_frame", recorded)
            if not graphed:
                mp.setattr(SlamPipeline, "_gicp_graphs",
                           lambda self, roi, n_points: None)
            pipe, _, _, _ = cs.run_perframe(paths, drive, card)
        return pipe, calls

    run()                                   # warm: kernels, libraries
    return run


def _registered(calls):
    return [c for c in calls if c["res"] is not None]


@pytest.mark.cuda
def test_graphed_registration_equals_eager_to_the_bit(card_drive):
    """Frame by frame over the drive (ROIs that grow and move), the
    graphed registration's pose, n_matched and mean_error equal the eager
    path's to the bit."""
    _, graphed = card_drive(graphed=True)
    eager_pipe, eager = card_drive(graphed=False)
    assert eager_pipe._reg_graphs is None
    got, want = _registered(graphed), _registered(eager)
    assert len(got) == len(want) >= 5
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in ((a["prior"][0], b["prior"][0]),
                     (a["prior"][1], b["prior"][1]),
                     (a["res"].pose.q.numpy(), b["res"].pose.q.numpy()),
                     (a["res"].pose.t.numpy(), b["res"].pose.t.numpy()),
                     (np.float32(a["res"].mean_error),
                      np.float32(b["res"].mean_error))):
            assert x.tobytes() == y.tobytes(), i
        assert a["res"].n_matched == b["res"].n_matched, i


@pytest.mark.cuda
def test_one_capture_a_pipeline_and_a_replay_a_frame(card_drive):
    """Each pipeline captures once; every registered frame, the capture
    frame too, replays the target graph; the gathers counted are those
    the replays ran: one of each per association, two a frame."""
    for _ in range(2):
        pipe, calls = card_drive(graphed=True)
        stages = pipe.timers.summary()
        reg = _registered(calls)
        assert stages["register_graph_capture"]["count"] == 1
        assert (stages["register_graph"]["count"]
                == stages["register"]["count"] == len(reg) >= 5)
        rc = pipe.cfg.registration
        per_frame = -(-rc.max_iterations // rc.reassociate_every)
        for c in reg[1:]:
            assert c["gather"] == {"gather_i32": per_frame,
                                   "gather_rows8": per_frame}


@pytest.mark.cuda
def test_every_registered_frame_launches_the_ne_kernel_per_iteration(
        card_drive):
    """The normal-equations launches stay eager: max_iterations (16) a
    registered frame, none for a frame with no map around it."""
    pipe, calls = card_drive(graphed=True)
    iters = pipe.cfg.registration.max_iterations
    assert iters == 16
    assert [c["ne"] for c in calls] == [
        iters if c["res"] is not None else 0 for c in calls]


@pytest.mark.cuda
def test_control_leaves_the_prior_on_the_graphed_path(card_drive):
    """Under the benchmark's control (`gicp.register_batch` at 0
    iterations) the graphed path runs no Gauss-Newton iteration: each
    registered frame's pose is its prior, and the graph replays."""
    from slambench.tests import faults
    with faults.control():
        pipe, calls = card_drive(graphed=True)
    reg = _registered(calls)
    assert pipe.timers.summary()["register_graph"]["count"] == len(reg) >= 5
    for c in reg:
        assert c["ne"] == 0
        assert np.array_equal(c["res"].pose.q.numpy(), c["prior"][0])
        assert np.array_equal(c["res"].pose.t.numpy(), c["prior"][1])


class _Stream:
    """A stand-in for a CUDA stream on the CPU, where work runs in order."""

    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _ReplayingGraph:
    """A stand-in for torch.cuda.CUDAGraph on the CPU: the capture runs
    the chain once and keeps its outputs; a replay runs it again and
    writes the results into those outputs, as a graph's replay does."""

    chain = None

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        def put(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            else:
                for d, s in zip(dst, src):
                    put(d, s)
        put(self.out, self.chain())


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The cudagraphs module with a stand-in graph that replays by
    running its chain again, and stand-in streams, on the CPU."""
    from veloslam_tpu_torch.registration import cudagraphs

    def record(chain):
        g = _ReplayingGraph()
        g.chain = chain
        g.out = chain()
        return g, {}, g.out

    monkeypatch.setattr(cudagraphs, "_record", record)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return cudagraphs


def _gicp_kw(rc):
    return dict(iterations=rc.max_iterations, damping=rc.damping,
                huber_delta=rc.huber_delta,
                max_dist=rc.max_correspondence_dist,
                reassociate_every=rc.reassociate_every)


def test_graphed_register_plumbing_on_the_cpu(room, cpu_graphs):
    """GicpGraphs' upload, static copies and association seam, with a
    stand-in graph that replays by running its chain again: frame after
    frame (ROIs that grow, priors that move), its registration equals the
    eager registration to the bit, with one capture and one target replay
    a frame; a frame at other shapes than the captured ones raises."""
    world, pts, mask = room
    rc = SlamConfig().registration
    kw = _gicp_kw(rc)
    pipe = SlamPipeline(SlamConfig(), device="cpu")
    graphs = None
    timers = profiling.StageTimers()
    for i, n_map in enumerate((20000, 40000, 60000)):
        pipe.map = type(pipe.map)(pipe.cfg.map, device="cpu")
        pipe.map.integrate_points(world[:n_map], np.ones(n_map, bool),
                                  center=np.zeros(3))
        roi = pipe.map.roi_grid(0.0, 0.0)
        prior = _pose(0.01 * i, [0.1 * i, 0.0, 0.0])
        if graphs is None:
            graphs = cpu_graphs.GicpGraphs(
                roi, len(pts), min_points=rc.min_points_per_voxel,
                min_planarity=rc.min_planarity)
        with profiling.recording(timers):
            got = graphs.register(pts, mask, prior, roi, **kw)
        want = gicp.register(
            torch.as_tensor(pts), torch.as_tensor(mask),
            gicp.plane_grid_from(roi, min_points=rc.min_points_per_voxel,
                                 min_planarity=rc.min_planarity),
            prior, vx.build_dense_index(roi), **kw)
        for a, b in ((got.pose.q, want.pose.q), (got.pose.t, want.pose.t),
                     (got.n_matched, want.n_matched),
                     (got.mean_error, want.mean_error), (got.H, want.H)):
            assert torch.equal(a, b), i
        assert int(got.n_matched) > rc.min_matched_points
    stages = timers.summary()
    assert stages["register_graph"]["count"] == 3
    assert stages["register_graph_capture"]["count"] == 1
    with pytest.raises(ValueError, match="captured at 4096 points"):
        graphs.register(pts[:-1], mask[:-1], prior, roi, **kw)


def test_graphs_warm_up_on_the_first_frame(room, cpu_graphs, monkeypatch):
    """The warm-up before the capture runs the target build on the first
    frame's ROI and the first association on its scan and mask at its
    prior: the inputs the eager path's first association gets, which a
    check of the kernels on the first call at each shape then sees."""
    world, pts, mask = room
    rc = SlamConfig().registration
    pipe = SlamPipeline(SlamConfig(), device="cpu")
    pipe.map.integrate_points(world, np.ones(len(world), bool),
                              center=np.zeros(3))
    roi = pipe.map.roi_grid(0.0, 0.0)
    prior = _pose(0.02, [0.25, -0.1, 0.0])
    first, targets = [], []
    associate, plane_grid_from = gicp.associate, gicp.plane_grid_from

    def seen_associate(p, m, pose, target, dense):
        if not first:
            first.append((p.clone(), m.clone(), pose.q.clone(),
                          pose.t.clone(), target, dense))
        return associate(p, m, pose, target, dense)

    def seen_target(grid, **kw):
        targets.append(tuple(x.clone() for x in grid))
        return plane_grid_from(grid, **kw)

    monkeypatch.setattr(gicp, "associate", seen_associate)
    monkeypatch.setattr(gicp, "plane_grid_from", seen_target)
    graphs = cpu_graphs.GicpGraphs(roi, len(pts),
                                   min_points=rc.min_points_per_voxel,
                                   min_planarity=rc.min_planarity)
    assert not first and not targets           # nothing runs until a frame
    graphs.register(pts, mask, prior, roi, **_gicp_kw(rc))
    p, m, q, t, target, dense = first[0]
    assert torch.equal(p[0], torch.as_tensor(pts))
    assert torch.equal(m[0], torch.as_tensor(mask))
    assert torch.equal(q[0], prior.q) and torch.equal(t[0], prior.t)
    for a, b in zip(targets[0], roi):
        assert torch.equal(a, b)
    assert _tree_equal(target, plane_grid_from(
        roi, min_points=rc.min_points_per_voxel,
        min_planarity=rc.min_planarity))
    assert _tree_equal(dense, vx.build_dense_index(roi))


def _tree_equal(a, b) -> bool:
    """Tensors in NamedTuples, at any depth, equal to the bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
