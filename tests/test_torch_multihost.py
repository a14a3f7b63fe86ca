"""The port's distributed SLAM session and its tools on several processes.

  * DistributedSlamSession on two Gloo CPU ranks over the "small" drive of
    tests/fixtures/multihost_golden_seed3.npz (the JAX session on two
    processes: tests/test_multihost.py's 1 s drive), through
    chip_smoke.multichip_session_rank and check_multihost_session, the
    card phase's own rank body and gates: the ranks equal to the bit;
    frames, keyframes, closures and landmarks equal to the JAX session's;
    owned tiles disjoint, each rank's the JAX rank's, their union the
    port's single-process map's; positions within per_frame's gates of
    the JAX ranks' and within 5 cm of the port's single-process
    run_offline (tests/test_multihost.py's gate).
  * apps/scaling_bench on two Gloo CPU ranks: one JSON line.
  * On a card (marked `cuda`, skipped here without one): world 1 over
    NCCL against the single-process functions, and NCCL refusing two
    ranks on one card.

This module imports no jax, so on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_multihost.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_multihost_worker as worker
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    gold = np.load(cs.MULTICHIP_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    return gold, cfg, {d["name"]: d for d in cfg["drives"]}


def test_session_matches_the_jax_session_on_two_ranks(golden, tmp_path):
    gold, cfg, drives = golden
    drive = drives["small"]
    paths, _ = cs.write_multihost_drive(drive, cfg["model"], str(tmp_path))
    ranks = dist.spawn_ranks(cs.multichip_session_rank, cfg["n_procs"],
                             backend="gloo", device="cpu",
                             args=(drive["slam"], paths), timeout_s=300)
    single, tiles = cs.run_single_offline(paths, drive,
                                          torch.device("cpu"))
    summary = cs.check_multihost_session(ranks, single, tiles, gold,
                                         "small")
    assert "ranks equal to the bit" in summary
    # tests/test_multihost.py's own gate on this drive: 5 cm.
    assert np.linalg.norm(ranks[0]["stream_positions"] - single,
                          axis=1).max() < 0.05
    for r in ranks:
        # One all_gather per registration (8 iterations, re-associated
        # every 8) and one scalar allgather per ROI refresh.
        n_reg = int(r["registered"].sum())
        assert r["collectives"]["all_gather"] >= n_reg
        assert r["collectives"]["ring"] == 0


def test_scaling_bench_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "veloslam_tpu_torch.apps.scaling_bench",
         "--nprocs", "2", "--backend", "gloo", "--device", "cpu",
         "--points", "4096", "--capacity", "4096", "--iters", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["metric"] == "multiprocess_register_ms"
    assert rec["processes"] == 2 and rec["backend"] == "gloo"
    assert rec["ms"] > 0 and rec["halo_ms"] > 0
    assert rec["collectives_per_registration"]["all_gather"] == 4
    assert "not scaling numbers" in rec["note"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nccl_world_one_on_card(card):
    """World 1 over NCCL on the card: register_sharded equal to
    gicp.register on the same card within 1e-6 and n_matched equal,
    decode_packets_sharded equal to decode_packets to the bit, the
    registration kernels launched on the sharded path."""
    inp = cs.multichip_inputs(cs.MULTICHIP_SIZES["small"])
    args = {"grid": inp["target"], "src": inp["pts"],
            "src_mask": inp["mask"], "packets": inp["packets"]}
    (r,) = dist.spawn_ranks(worker.nccl_rank, 1, backend="nccl",
                            device="cuda", args=(args,), timeout_s=300)
    assert r["backend"] == "nccl"
    for k in ("q", "t"):
        np.testing.assert_allclose(r["sharded"][k], r["single"][k],
                                   atol=1e-6)
    assert r["sharded"]["n_matched"] == r["single"]["n_matched"] > 1000
    assert r["decode_equal"]
    assert all(r["launches"][k] > 0 for k in r["launches"]), r["launches"]


@pytest.mark.cuda
def test_nccl_refuses_more_ranks_than_cards(card):
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="one rank per card"):
        dist.spawn_ranks(worker.nccl_rank, n, backend="nccl",
                         device="cuda", args=({},), timeout_s=120)
