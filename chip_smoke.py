"""Drive the PyTorch port's main paths once on one CUDA card: bulk
odometry, device full SLAM with its end-of-stream finalize, the
user-facing pipeline from pcap to trajectory, landmarks and tiled map
(batched, and per frame: slam_run's default mode, with each of its
registration methods), the streaming odometry's fused and chained
paths and slam_run --fast's engine, live mode over UDP (per frame and
fast), the tools (slam_run --bev, inspect, the landmark extractors),
the matrix-free PCG graph solvers that sessions above 2048 keyframes
run, the multi-device slice (sharded registration, decode and graph
solves, the distributed session) on ranks sharing the card, and the
HDL-64 and VLP-16 sensor families through every single-card entry
point.

Run on a machine with an NVIDIA H100, from the repository root or any
other directory (the script puts its own directory first on sys.path):

    python3 chip_smoke.py

Phases, one printed line each (or more); any failure raises and the exit
code is non-zero:
  1. device   — require CUDA; print the card's name and power limit;
                turn TF32 off for float32 matmuls and convolutions.
  2. build    — compile csrc/normal_equations.cu, csrc/gather.cu and
                csrc/chain.cu with nvcc, one process per source, started
                together.
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
                library call torch.index_select.  The chain kernel
                (chain_factor, chain_solve) vs its plain version on the
                solver's own blocks at CHAIN_SHAPES (1 step, both sides of
                the 32- and 64-step chunks, 4096, 4097, 16384), both vs a
                float64 CPU run, two calls equal to the bit; at 4096 and
                16384 ns per step beside the latency bound (the dependent
                operations of a step at the card's top SM clock).
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
                counted; the 5 measured runs equal to the bit; frames/s.
  7. pipeline — the same drive written as a pcap + INS log by the port's
                simulator, through SlamPipeline(device="cuda").
                run_offline_batched(batch=4096, defer_map=True) +
                finalize() (GPS grounding, landmarks, the landmark-Schur
                graph solve, the tiled map) with bench.py's full-SLAM
                config, against the JAX package's golden
                (tests/fixtures/pipeline_golden_seed3.npz): a warm run and
                2 measured runs, each checked (frames and times,
                keyframes, closure pairs, trajectory, landmark counts,
                ATE) with its launches counted, both equal to the bit
                (trajectory, keyframes, closures, landmarks, map counts);
                pipeline frames/s as
                bench.py::run_full_slam defines it; then one run that
                synchronizes at each stage's end, for the stage seconds.
  8. bench    — bench_torch.py's stages but the live sweep: the bulk step
                on _bulk_inputs' arrays from a warm map and, in turns,
                from the empty map (its launches: 16 normal-equations,
                2 of each gather a step), the primitive rates and the roofline
                (every fraction at most 1.05), the full-SLAM stage on
                bench.py's 20 s drive (run_offline_batched + finalize())
                against the JAX golden (tests/fixtures/
                bench_golden_seed3.npz: frames, times and keyframes equal,
                closures equal or within 2%, trajectory, ATE), and the
                headline record parsed back.
  9. per_frame — slam_run's default mode: the same pcap + INS log
                through SlamPipeline(device="cuda").run_offline +
                finalize() (512-packet batches; per frame the ROI's dense
                index, 16 GN iterations on 16384 points, the map
                integration; closure sweeps every 10 keyframes with the
                graph solve and the map downdate) with bench.py's
                full-SLAM config, against the JAX package's golden
                (tests/fixtures/perframe_golden_seed3.npz): a warm run
                whose registration-kernel inputs are recorded at every
                shape the path gives them (a frame against the ROI,
                closure verification's C candidates) and each kernel
                held against its plain version on them (NE and the GN
                step at the kernel phase's tolerances, the gathers
                bitwise) and timed at a frame's shape; 2 measured runs,
                each checked (frames and times,
                keyframe times, closures mid-session and in all,
                trajectory, landmark count, ATE), both equal to the bit;
                the registration kernels launched, the chain kernel not;
                a checkpoint round trip; frames/s; then one run that
                synchronizes at each stage's end, for the stage seconds
                and the synchronizing operations by call site.
  10. paths    — the paths ported last, against the JAX golden
                (tests/fixtures/paths_golden_seed3.npz): the per-frame
                pipeline of phase per_frame with registration method
                "d2d" and then "ndt" (a warm run whose kernel inputs are
                captured, 2 runs each checked with the registered flags
                and equal to the bit, the last synchronized at each
                stage's end with its synchronizing operations counted;
                gather_i32 launched at least once per GN iteration of
                every frame after the first); StreamingOdometry with the
                JAX defaults (fused, 1 m voxels, 16384 points, 8 GN
                iterations, the exact binary-search lookup) on the two
                odometry golden drives in 512-packet batches, the chained
                path equal to it to the bit, and slam_run --fast's engine
                (batched, frame sampling, binary search) in 2048-packet
                batches (frames and times exact, positions within 1 cm,
                launches exactly one per GN iteration and association,
                synchronizing operations a batch); the batched pipeline
                with use_dense_index=False with phase pipeline's gates;
                every kernel held against its plain version on these
                paths' own inputs and timed at their first shape.
  11. live    — SlamPipeline.run_online on bench.py's drive at the
                production width (512-packet batches), against the JAX
                golden (tests/fixtures/live_golden_seed3.npz): the
                golden's session through the scripted receiver
                (ScriptedUdp: the InsPVA datagrams the port's
                replay_ins_txt builds from the INS log, equal to the
                golden's, then the pcap's LiDAR packets), per frame and
                fast, each + finalize(), with phase per_frame's gates and
                the health dicts and counts equal, the registration
                kernels launched and held against their plain versions on
                these runs' inputs; the same datagrams over real loopback
                UDP (the packet pump's receiver and sender), INS ahead and
                LiDAR at the sensor's pace, per frame: none lost or
                dropped, frames, times and poses equal to the bit to the
                scripted run; then measure_live_loopback (INS interleaved
                at 100 Hz): fast at 1x and 2x, per frame at 1x, none lost
                or dropped, sustained pkt/s and the batch feed time beside
                the batch period.
  12. apps    — slam_run (per frame) with --bev and --checkpoint-dir on
                the drive's pcap, inspect --checkpoint (every frame
                fetched, 0 failures) and inspect --pcap --frame 3 with
                every dump (point counts equal the frame's), and
                extract_landmarks on the checkpoint map's largest patch
                on the card against a CPU run.
  13. pcg     — solve_pcg at K = 16384 (16000 poses) and
                solve_pcg_landmarks at K = 4096 alone, at the production
                8 GN x 96 CG iterations, twice each, against the JAX
                golden (tests/fixtures/pcg_golden.npz) and the JAX tests'
                gates; time, launches, syncs and their call sites, peak
                memory; the device finalize's proposal and solve at the
                keyframe ring's cap of 16384.
  14. long_drive — tests/test_fullslam.py's unbounded session (44 s at
                3600 rpm, ~2640 keyframes in a 4096-row ring, every solve
                on PCG) once through SlamPipeline on the card, every stage
                synchronized, against the JAX golden
                (tests/fixtures/long_drive_golden_seed3.npz); the chain
                kernel must launch in the device finalize and in the
                landmark solve.
  15. multichip — the multi-device slice (veloslam_tpu_torch/parallel/,
                the port of __graft_entry__.py::dryrun_multichip), every
                rank a process spawned with the "spawn" start method:
                world 1 over NCCL held to the single-process functions on
                the card (decode_packets_sharded on 16384 packets,
                register_sharded of a 16384-point scan against the
                65536-row map with a DenseIndex per shard,
                register_halo_sharded, solve_graph_sharded with and
                without landmarks on a 1024-keyframe graph), worlds 2 and
                4 over Gloo with every rank on the card (the replicas
                equal to the bit, each within its tolerance of world 1,
                ms per call, collectives per registration), the
                DistributedSlamSession on 2 Gloo ranks on bench.py's
                drive per frame + finalize() against the JAX session's
                golden (tests/fixtures/multihost_golden_seed3.npz), and
                apps/scaling_bench at 1 (NCCL) and 2 (Gloo) ranks; the
                registration kernels held against their plain versions on
                the sharded path's and the session's own inputs.
  16. models  — the two other sensor families, the HDL-64 (with a
                per-unit calibration file, db.xml, written by the port's
                to_xml and read through SensorConfig.calibration_path) and
                the VLP-16, against the JAX golden
                (tests/fixtures/models_golden_seed3.npz): per model the
                bulk step at bench.py's width (16384 packets, the model's
                slots_for_batch frame slots: 50 and 222), then bench.py's
                7 s drive through FullSlam + finalize_device,
                run_offline_batched + finalize(), run_offline + finalize()
                and slam_run --fast, each twice, equal to the bit, with
                the gates of phases fullslam, pipeline, per_frame and
                paths; the HDL-64 also live: scripted per frame and fast
                against the golden, then over loopback UDP at 1x its
                3617 pkt/s (fast: none lost).  Every registration kernel
                held against its plain version on each part's own inputs,
                at the bulk step's shapes with its device µs beside the
                bound.
Then one JSON line with the kernel records (launches: one pipeline run,
the chain kernel's one long-drive run; bench_launches: one bulk step and
the 20 s full-SLAM run of phase bench; per_frame_launches: one per_frame
run; per_frame_max_abs_err: the largest |Δ| from the plain version on the
per_frame path's own inputs; paths_launches and paths_max_abs_err: the
same for each part of phase paths; live_launches and live_max_abs_err:
the same for each run of phase live; multichip_launches and
multichip_max_abs_err: rank 0's in each world and in the session of phase
multichip; models_launches and models_max_abs_err: each part of phase
models, the bulk step's for one batch), and last the result line.
Imports nothing of JAX or of the JAX package, and checks that before the
result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# The port is imported from this checkout, whatever the working directory
# and under `python -P` (which leaves the script's directory off
# sys.path).
sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "fixtures", "odometry_golden_seed23.npz")
FULLSLAM_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "fullslam_golden_seed3.npz")
PIPELINE_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "pipeline_golden_seed3.npz")
BENCH_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                            "bench_golden_seed3.npz")
KERNEL_SOURCES = ("normal_equations", "gather", "chain")
# The registration kernels, which every SLAM path launches.
REG_KERNELS = ("fused_normal_equations", "gather_i32", "gather_rows8")
# Closure verification of the full-SLAM drive registers 128 candidates
# of 8192 keyframe points against per-candidate targets of 8192 voxel
# rows (2048 in the coarse pass): F x V = 1 << 20 (1 << 18) table rows,
# seven key searches per point, one row per point.
KERNEL_SHAPES = ((96, 16384), (128, 8192), (3, 1000), (1, 1))
# The normal equations are also checked at the per-frame path's slot
# counts and at the warm map's 56% and the VLP-16 bulk step's 1% hits
# (F, P, hit rate), and timed at the bulk shapes of the three sensor
# families (96, 50, 222 slots), closure verification's and the per-frame
# path's.
NE_EXTRA_CASES = ((1, 16384, 0.8), (8, 16384, 0.8), (96, 16384, 0.56),
                  (222, 16384, 0.01))
NE_TIMED_CASES = ((96, 16384, 0.8), (96, 16384, 0.56), (50, 16384, 0.8),
                  (222, 16384, 0.8), (222, 16384, 0.01), (128, 8192, 0.8),
                  (1, 16384, 0.8), (8, 16384, 0.8))
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
PIPELINE_RUNS = 2
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device-memory bytes/s, and float32 and float64 FLOP/s outside the
# tensor cores.  A kernel's bound is the larger of the bytes it must move
# (each input byte read once, each output byte written once) and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# Float64 operations per point with a correspondence in the normal
# equations: pose transform 21, residual 8, Huber weight 3, Jacobian 9,
# the 29 sums 69 (an FMA counts 2).
NE_FLOP_PER_HIT = 110
# Corrected trajectory against the JAX golden: x, y within 5 cm; z within
# Z_LIMIT_M.  On this drive the stream's height drifts by metres in both
# packages, so z follows the order of float sums: with every sum of the
# port in a fixed order, its z lands 0.0185 m (phase fullslam) and 0.0131
# m (phase pipeline) from the golden's on the card, the same bits in every
# run, and 0.105 m on the CPU (other sum orders in torch's CPU ops), while
# every accepted closure's measured z agrees to 1e-6 m.  The bound is the
# CPU reading, the largest, with 0.045 m (43%) margin, so a rehearsal on
# the CPU holds it too (see _check_fullslam).
Z_LIMIT_M = 0.15
PCG_GOLDEN = os.path.join(REPO, "tests", "fixtures", "pcg_golden.npz")
# The PCG solvers' graphs (pcg_graph): the JAX package's own scale tests
# (tests/test_graph.py), the pose-only chain run to 16000 poses in the
# keyframe ring's cap of 16384 rows, the landmark chain at 4096.
PCG_GRAPHS = {
    "chain": dict(n=16000, K=16384, E=2 * 16384, lap=500, radius=80.0,
                  seed=3, sigma=0.01, info=100.0, closure_every=100,
                  closure_info=1000.0),
    "landmarks": dict(n=4096, K=4096, E=2 * 4096, lap=256, radius=50.0,
                      seed=5, sigma=0.01, info=100.0, n_landmarks=16, M=64,
                      O=8192, obs_every=8, obs_range=25.0, obs_sigma=0.02,
                      obs_info=25.0),
}
# The production solve: graph.pcg's defaults.
PCG_ITERATIONS, PCG_CG_ITERS = 8, 96
# The landmark test's own solve (iterations, cg_iters), under which it
# gates the error against the truth to half its start: at the production
# solve the JAX package lands at 0.61 of it on this graph (a converged
# fit of the noisy landmarks, not the truth), so that gate is held here.
LANDMARK_TEST_SOLVE = (4, 64)
# Chain lengths the chain kernel is checked at: one step, both sides of
# the old 32-step and the current 64-step staging chunk, the long drive's
# 4096-row ring and one past it, the ring's cap.  Timed at CHAIN_TIMED.
CHAIN_SHAPES = (1, 31, 32, 33, 63, 64, 65, 4096, 4097, 16384)
CHAIN_TIMED = (4096, 16384)
# The chain kernel's latency bound: each step of its recurrences waits on
# the step before, so a call takes at least K x (the dependent float
# operations of one step) x OP_CYCLES cycles at the card's top SM clock
# (nvidia-smi clocks.max.sm).  OP_CYCLES is the latency assumed for an
# FMA, FADD or FMUL on Hopper, and for each instruction of the reciprocal.
OP_CYCLES = 4
# A solve step: forward 6 FMAs and the subtraction from r; backward 6
# FMAs, the subtraction from y, then 6 FMAs.
CHAIN_SOLVE_OPS = 20
# The dependent instructions of chain_factor_kernel's IEEE reciprocal
# 1.0f / pivot on its fast path, read from its SASS (profile_chain.py
# prints them): MUFU.RCP, FFMA, FADD.FTZ, FFMA.
CHAIN_RCP_OPS = 4
# A factor step: L's 6-FMA chain, U's 6 FMAs and the subtraction from D,
# then per pivot column the reciprocal, the scaling of the pivot row and
# the eliminating FMA (the pivot search runs beside the reciprocal).
CHAIN_FACTOR_OPS = 13 + 6 * (CHAIN_RCP_OPS + 2)
PERFRAME_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "perframe_golden_seed3.npz")
PERFRAME_RUNS = 2
PATHS_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                            "paths_golden_seed3.npz")
# Runs of each per-frame method after the warm one: the last synchronizes
# at each stage's end, the others are timed; all are checked and compared.
PATHS_RUNS = 2
PATHS_MIN_CLOSURES = {"d2d_full": 3, "ndt_full": 3, "d2d_small": 1,
                      "ndt_small": 1}
# Every this many D2D / NDT registrations of the warm run are run again
# on a CPU copy of their inputs.
PATHS_RECHECK_EVERY = 8
# Closures the per-frame drives must accept in all (and at least one of
# them mid-session, which runs the graph solve and the map downdate).
PERFRAME_MIN_CLOSURES = {"full": 3, "small": 1, "small_search": 1}
LONG_DRIVE_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                                 "long_drive_golden_seed3.npz")
# The long drive's 2-D ATE against the golden's (0.776 m): with every sum
# in a fixed order the port's runs on the card read 0.7213 m, the same in
# every run (the stream's 0.8399 m).  Float sums in other orders moved it
# over 0.54-1.09 m, so the bound, golden + 0.15 m = 0.926 m, leaves
# 0.205 m (28%) above the reading for a change that reorders sums.
LONG_DRIVE_ATE_M = 0.15
MULTICHIP_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                                "multihost_golden_seed3.npz")
# Phase multichip: the Gloo worlds beside world 1 (every rank on the one
# card), and the sizes: "full" at the production width (a 16384-point
# scan, the 65536-row rolling map at 0.5 m, bench.py's 16384-packet
# batch, a 1024-keyframe graph with closures and post observations);
# "small" for a CPU rehearsal.
MULTICHIP_WORLDS = (2, 4)
MULTICHIP_SIZES = {
    "full": dict(points=16384, rows=65536, voxel=0.5, packets=16384,
                 graph=dict(n=1000, K=1024, E=2048, lap=250, radius=40.0,
                            seed=7, sigma=0.01, info=100.0,
                            closure_every=50, closure_info=1000.0,
                            n_landmarks=16, M=64, O=2048, obs_every=8,
                            obs_range=25.0, obs_sigma=0.02, obs_info=25.0)),
    "small": dict(points=4096, rows=16384, voxel=0.5, packets=512,
                  graph=dict(n=100, K=128, E=256, lap=50, radius=20.0,
                             seed=7, sigma=0.01, info=100.0,
                             closure_every=25, closure_info=1000.0,
                             n_landmarks=8, M=64, O=512, obs_every=4,
                             obs_range=25.0, obs_sigma=0.02, obs_info=25.0)),
}
MULTICHIP_BENCH = {"full": {}, "small": dict(points=4096, capacity=4096,
                                             iters=4)}
# The production registration schedule and the graph's GN iterations
# (RegistrationConfig, GraphConfig defaults).
MULTICHIP_ITERATIONS, MULTICHIP_REASSOCIATE, MULTICHIP_GN = 16, 8, 8
# Tolerances.  World 1 against the port's single-process functions on the
# same device: register_sharded is gicp.register's arithmetic on the
# same correspondences (held to 1e-6); the halo step adds the damping
# as one term, the JAX halo's form (float32 rounding of the 6x6 solve);
# the graph solves sum the same pieces in the same order (the all_reduce
# of one rank is a copy), but a multithreaded CPU BLAS need not repeat
# its products (1.1e-5 m between two CPU rehearsals).  Worlds 2 and 4 against world 1: the
# registrations' correspondences come from each shard's own index, the
# NE sums of the halo path run per rank; the graph's partial normal
# equations are summed in another order, which the float32 Cholesky of
# the 6144-row system amplifies (1.03 cm at most at world 2 of the
# 1024-keyframe pose-only graph on an H100): phase pcg's gates between
# two float32 solves of one graph, 1 cm RMS and 5 cm at most.
MULTICHIP_REG_ONE = 1e-6
MULTICHIP_HALO_ONE = 1e-4
MULTICHIP_GRAPH_ONE = 1e-4
MULTICHIP_REG_WORLD = 1e-4
MULTICHIP_GRAPH_WORLD = {"rms_m": 0.01, "max_m": 0.05, "q": 1e-3}
MULTICHIP_TIMEOUT_S = 300
LIVE_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                           "live_golden_seed3.npz")
# run_online's ports in a scripted session (no socket is bound there).
LIVE_PORTS = {"lidar": 2368, "ins": 6777, "position": 8308}
# LiDAR packets a scripted receiver returns a poll: no divisor of the
# batch sizes, so batches form across polls.
LIVE_CHUNK = 300
# A scripted session ends after this idle time (its packets are all
# there at once).
LIVE_IDLE_S = 0.2
# Closures the live drives must accept in all (run_online + finalize()).
LIVE_MIN_CLOSURES = {"full": 3, "small": 0, "gps": 0}
# The real-loopback runs: INS sent ahead, 2 ms a datagram; the session's
# idle timeout covers the gap between the INS burst and the first LiDAR
# packet.
LIVE_INS_GAP_S = 0.002
LIVE_LOOPBACK_IDLE_S = 2.5
# The post landmarks' greedy clustering (graph/landmark_assoc.py) decides
# each detection by its distance to a cluster against a radius; a
# decision the reference took closer than this to the radius may go the
# other way in the port, whose keyframe poses differ from the reference's
# by up to ~1 mm (float rounding in decode and registration).  The live
# golden records each session's smallest margin ("<name>_assoc_margin").
ASSOC_MARGIN_M = 1e-3
# Where that margin is under ASSOC_MARGIN_M, the finalized positions'
# bound in x, y: the live "full" per-frame session, whose one detection
# clustered the other way moves frames 10-30 by 5.45 cm after finalize's
# landmark solve (the card and the CPU alike; run_online's own
# trajectory 1.0 mm from the golden's), and CPU reruns move its live
# stream by up to 3.8 mm.  8 cm leaves 2.2 cm above the reading.
ASSOC_FLIP_LIMIT_M = 0.08
MODELS_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                             "models_golden_seed3.npz")
# Phase `models`: runs of each entry point per model (the first with its
# kernel inputs captured; all equal to the bit), and the bulk step's
# packets (bench.py's width) and timed steps.
MODELS_RUNS = 2
MODELS_BULK_PACKETS = 16384
MODELS_BULK_STEPS = 5


def _quat_mul_np(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _quat_rotate_np(q, v):
    u, w = q[..., 1:], q[..., :1]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _conj_np(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def pcg_graph(p: dict):
    """A graph of PCG_GRAPHS' kind as GraphArrays fields (numpy: float32,
    int32, bool; padded to capacity as PoseGraph.arrays pads), numpy only,
    so the JAX golden's generator and the port build the same graph.

    Poses step around a circle of `lap` poses per lap; the odometry edges
    measure the true relative motion with N(0, sigma) noise on the
    translation, and the estimates are those noisy edges chained from the
    identity, so they drift.  "chain" adds a closure every 100 poses from
    the second lap on, to the pose of the first lap at the same angle
    (tests/test_graph.py::test_pcg_scales_past_dense_ceiling); "landmarks"
    adds 16 posts on the circle, 0.2 m off, seen from every 8th true pose
    within 25 m (::test_pcg_landmarks_scales_past_dense_ceiling).
    Returns (fields, true positions (n, 3) float32)."""
    rng = np.random.default_rng(p["seed"])
    n, K, E = p["n"], p["K"], p["E"]
    ang = (np.arange(n) % p["lap"]) * (2 * np.pi / p["lap"])
    R = p["radius"]
    true_t = np.stack([R * np.sin(ang), R * (1 - np.cos(ang)),
                       np.zeros(n)], -1)
    true_q = np.stack([np.cos(ang / 2), np.zeros(n), np.zeros(n),
                       np.sin(ang / 2)], -1)
    inv_q = _conj_np(true_q[:-1])
    rel_q = _quat_mul_np(inv_q, true_q[1:])
    rel_t = _quat_rotate_np(inv_q, true_t[1:] - true_t[:-1])
    noisy_t = rel_t + rng.normal(0, p["sigma"], (n - 1, 3))
    # est_k = est_{k-1} ∘ (rel_q, noisy_t) from the identity: the
    # rotations are exact, so est_q = true_q and the translations sum.
    est_t = np.concatenate([np.zeros((1, 3)), np.cumsum(
        _quat_rotate_np(true_q[:-1], noisy_t), axis=0)])
    e_i, e_j = list(range(n - 1)), list(range(1, n))
    e_q, e_t = list(rel_q), list(noisy_t)
    e_info = [[p["info"]] * 6] * (n - 1)
    every = p.get("closure_every")
    for k in range(p["lap"], n, every) if every else ():
        e_i.append(k)
        e_j.append(k % p["lap"])
        e_q.append([1.0, 0, 0, 0])
        e_t.append([0.0, 0, 0])
        e_info.append([p["closure_info"]] * 6)
    ne = len(e_i)

    def pad(rows, cap, width, fill=0.0):
        out = np.full((cap, width), fill, np.float32)
        out[:len(rows)] = np.reshape(rows, (len(rows), width))
        return out

    q = pad(true_q, K, 4)
    q[n:, 0] = 1.0
    eq = pad(e_q, E, 4)
    eq[ne:, 0] = 1.0
    f = dict(q=q, t=pad(est_t, K, 3), n_poses=np.int32(n),
             e_i=pad(np.asarray(e_i)[:, None], E, 1)[:, 0].astype(np.int32),
             e_j=pad(np.asarray(e_j)[:, None], E, 1)[:, 0].astype(np.int32),
             e_q=eq, e_t=pad(e_t, E, 3), e_info=pad(e_info, E, 6),
             e_valid=np.arange(E) < ne)
    M, O = p.get("M", 1), p.get("O", 1)
    lm = np.zeros((0, 3))
    o_i, o_l, o_z = (np.zeros(0, np.int64),) * 2 + (np.zeros((0, 3)),)
    if p.get("n_landmarks"):
        a = np.linspace(0, 2 * np.pi, p["n_landmarks"], endpoint=False)
        true_lm = np.stack([R * np.sin(a), R * (1 - np.cos(a)),
                            np.full_like(a, 2.0)], -1)
        lm = true_lm + rng.normal(0, 0.2, true_lm.shape)
        ks = np.arange(0, n, p["obs_every"])
        kk, mm = np.meshgrid(ks, np.arange(len(a)), indexing="ij")
        kk, mm = kk.ravel(), mm.ravel()
        z = _quat_rotate_np(_conj_np(true_q[kk]), true_lm[mm] - true_t[kk])
        seen = np.linalg.norm(z, axis=1) < p["obs_range"]
        o_i, o_l = kk[seen], mm[seen]
        o_z = z[seen] + rng.normal(0, p["obs_sigma"], (int(seen.sum()), 3))
    f.update(l_pos=pad(lm, M, 3), n_landmarks=np.int32(len(lm)),
             o_i=pad(o_i[:, None], O, 1)[:, 0].astype(np.int32),
             o_l=pad(o_l[:, None], O, 1)[:, 0].astype(np.int32),
             o_z=pad(o_z, O, 3),
             o_info=pad(np.full((len(o_i), 3), p.get("obs_info", 0.0)), O, 3),
             o_valid=np.arange(O) < len(o_i))
    return f, true_t.astype(np.float32)


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


def _device_us(fn, calls: int = 20, tries: int = 3, skip: str = "") -> float:
    """Device time per call of `fn()` in µs, which launches each of its
    kernels once a call: over `calls` back-to-back calls under
    torch.profiler (host time excluded), each kernel's mean time a launch,
    summed over the kernels but those whose name holds `skip`.  A mean a
    launch is unchanged by a trace that lost some launches, as traces on
    the card have been seen to.  A trace that caught no kernel is taken
    again, up to `tries` times; 0 if none caught one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not (skip and skip in e.key))
        if us > 0:
            return us
    return 0.0


def _cold_events_ms(fn, flush, runs: int) -> float:
    """Time of one call of `fn()` by CUDA events, each call after
    `flush()` (outside the events; a flush that keeps the card busy
    longer than the host takes to enqueue the call leaves no idle gap
    inside them); the median of `runs` calls."""
    times = []
    for _ in range(runs):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(nbytes: float, flops: float = 0.0,
           flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    """(bound_ms, bound_by): the least time the card could take."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_per_s * 1e3
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
    b, the sums and the new pose out (~220 B); the arithmetic in float64."""
    return _bound(F * P + 36 * hits + 248 * F, NE_FLOP_PER_HIT * hits,
                  FP64_FLOP_PER_S)


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
    from veloslam_tpu_torch.graph import chain
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import normal_equations as ne
    ne.LAUNCHES = 0
    for counts in (ga.LAUNCHES, chain.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from veloslam_tpu_torch.graph import chain
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import normal_equations as ne
    return {"fused_normal_equations": ne.LAUNCHES, **ga.LAUNCHES,
            **chain.LAUNCHES}


def _check_launches(where: str, got: dict, want: dict, device) -> None:
    """Kernel launches of a path against the counts its shapes imply; a
    kernel that `want` does not name must not launch (the chain kernel
    below DENSE_MAX_POSES).  On the CPU, a rehearsal, the wrappers take
    the plain path: none."""
    want = {k: want.get(k, 0) if device.type == "cuda" else 0 for k in got}
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
    factor fails: step rejected).  With F ≥ 5, slots 3 and 4 are
    with_nan_slots' NaN in a point without a correspondence and NaN pose:
    H and b NaN there too (w = 0 times a NaN J or r), steps rejected."""
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
    if edge_slots and F >= 5:
        hit[3, 7] = 0
        pts[3, 7, 1] = np.nan
        q[4, 2] = np.nan

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


def _f64(x):
    """Float tensors (in Poses too) as float64; the rest as they are."""
    if isinstance(x, tuple):
        items = [_f64(y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.double() if x.is_floating_point() else x


def _check_ne(F: int, P: int, args, **kw) -> dict:
    """NE-only mode against normal_equations_plain evaluated in float64 on
    the same float32 inputs (the kernel's arithmetic is float64; the
    plain version's float32 evaluation is itself up to 1e-2 off b where
    b's terms cancel): |Δ| ≤ 1e-4·max|ref| + 1e-3 on H and b, 1e-4
    relative on the sums, n_hit exact, two launches bitwise equal.  `kw`:
    huber_delta, max_dist."""
    from veloslam_tpu_torch.registration import normal_equations as ne
    got = ne.fused_normal_equations(*args, **kw)
    again = ne.fused_normal_equations(*args, **kw)
    ref = ne.normal_equations_plain(*(_f64(a) for a in args), **kw)
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


def _check_gn(F: int, P: int, args, damping: float = 1e-6,
              edge_slots: bool = True, **kw) -> dict:
    """gn_iteration's kernel against gn_iteration_plain evaluated in
    float64 on the same float32 inputs (as _check_ne): the ok and clamp
    decisions exactly (and, with `edge_slots`, the expected ones of
    _ne_inputs' edge slots), n_hit exact,
    H, b and err at _check_ne's tolerances with NaNs counted equal, a
    rejected slot's pose unchanged bitwise (but the q of the NaN-pose
    edge slot, held, NaN entries included, to the float64 step below),
    two calls bitwise equal.  The
    new pose is held within 1e-5 m and 1e-6 per quaternion component of
    the plain step taken in float64 from the kernel's own H, b and n_hit
    (the float32 H, b it returns): both solve the same 6×6 system in
    float64.  The fully plain pose also differs by H's and b's rounding to
    float32 times the conditioning of H; its offset is printed.  `kw`:
    huber_delta, max_dist."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import normal_equations as ne
    pts, q, t, mu, n, hit = args
    pose = se3.Pose(q, t)
    got = ne.gn_iteration(pts, pose, mu, n, hit, damping=damping, **kw)
    again = ne.gn_iteration(pts, pose, mu, n, hit, damping=damping, **kw)
    ref = ne.gn_iteration_plain(*_f64((pts, pose, mu, n)), hit,
                                damping=damping, **kw)
    own = ne._gn_step(_f64(pose), got.H.double(), got.b.double(), got.n_hit,
                      damping)
    torch.cuda.synchronize()

    def leaves(g):
        return (g.pose.q, g.pose.t, g.H, g.b, g.err, g.n_hit, g.step)
    if not all(_same_bits(a, b) for a, b in zip(leaves(got), leaves(again))):
        raise AssertionError(f"gn_iteration not bitwise repeatable at {F}x{P}")
    if not torch.equal(got.step, ref.step):
        raise AssertionError(f"step decisions differ at {F}x{P}: "
                             f"{got.step.tolist()} vs {ref.step.tolist()}")
    want = (([0, 2, 0] + [0, 0] * (F >= 5) if F >= 3 else [0])
            if edge_slots else [])
    if got.step[:len(want)].tolist() != want:
        raise AssertionError(f"edge slots at {F}x{P}: steps "
                             f"{got.step[:len(want)].tolist()}, want {want}")
    if not torch.equal(got.n_hit, ref.n_hit):
        raise AssertionError(f"gn_iteration n_hit differs at {F}x{P}")
    kept = got.step == 0
    kept_q = kept.clone()
    if edge_slots and F >= 5:
        kept_q[4] = False   # its NaN in q spreads through exp(0) ∘ q; t stays
    if not (_same_bits(got.pose.q[kept_q], q[kept_q])
            and _same_bits(got.pose.t[kept], t[kept])):
        raise AssertionError(f"a rejected step moved the pose at {F}x{P}")
    errs = {"gn_H": _ne_diff("H", F, P, got.H, ref.H),
            "gn_b": _ne_diff("b", F, P, got.b, ref.b),
            "gn_err_rel": _ne_diff("err", F, P, got.err, ref.err, True)}
    # An empty slot of a batched step may enter with a NaN prior (no
    # frame start): NaN entries must agree, the rest is compared.
    errs["pose_t"] = _diff("pose t", got.pose.t, own.t)
    errs["pose_q"] = _diff("pose q", got.pose.q, own.q)
    if not (errs["pose_t"] <= 1e-5 and errs["pose_q"] <= 1e-6):
        raise AssertionError(f"pose at {F}x{P}: |dt| {errs['pose_t']} m, "
                             f"|dq| {errs['pose_q']} from the plain float64 "
                             "step on the kernel's H, b")
    errs["plain_pose_t"] = _diff("plain pose t", got.pose.t, ref.pose.t)
    errs["plain_pose_q"] = _diff("plain pose q", got.pose.q, ref.pose.q)
    # Shown, not gated: how far the plain version's float32 evaluation
    # lands from its float64 one (b), and a float32 step on the kernel's
    # own H, b from the float64 step.
    ref32 = ne.gn_iteration_plain(pts, pose, mu, n, hit, damping=damping,
                                  **kw)
    own32 = ne._gn_step(pose, got.H, got.b, got.n_hit, damping)
    errs["f32_b"] = _diff("float32 b", ref32.b, ref.b)
    errs["f32_step_t"] = _diff("float32 step t", own32.t, own.t)
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
    for F, P, rate in NE_EXTRA_CASES:
        args = _ne_inputs(F, P, seed=F * 100003 + P, device=device,
                          hit_rate=rate, edge_slots=True)
        errs = {**_check_ne(F, P, args),
                **_check_gn(F, P, args, edge_slots=F >= 3)}
        print(f"[kernel] F={F} P={P} hits {rate:.0%} NE and GN step ok"
              f"{', NaN slots NaN' if F >= 5 else ''}, bitwise repeatable; "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items()),
              flush=True)
    record.update(time_normal_equations(device))
    return record


def time_normal_equations(device, step: bool = True) -> dict:
    """Times of the normal-equations kernel at NE_TIMED_CASES: NE-only,
    and with `step` the whole GN step (gn_iteration, as the paths call
    it), each beside its plain version, with the host's share of a call
    (CUDA-event time less the profiler's device time).  No single PyTorch
    call computes the function: no library time.  Returns the record's
    times, from the bulk shape at 80% (the GN step; NE-only without
    `step`, which also times a tree whose wrapper has no gn_iteration,
    for a comparison in one call)."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.registration import normal_equations as ne
    record = {}
    for F, P, rate in NE_TIMED_CASES:
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
                  f"device {dev_us:.2f} µs per call (profiler), host "
                  f"{times['ms'] * 1e3 - dev_us:.2f} µs; bound "
                  f"{bound_ms * 1e3:.2f} µs ({bound_by}), "
                  f"{_share(bound_ms, dev_us)}; every byte of p, μ, n "
                  f"{_bound(F * P * 37 + 248 * F)[0] * 1e3:.2f} µs",
                  flush=True)
            if (F, P, rate) == (96, 16384, 0.8):
                record.update(times, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=None)
    # What the card reads in practice: torch.sum over as many bytes as p,
    # μ and n and the flags of the bulk shape.
    F, P = KERNEL_SHAPES[0]
    x = torch.zeros(F * P * 37 // 4, dtype=torch.float32, device=device)
    print(f"[kernel] torch.sum over {x.numel() * 4 / 1e6:.1f} MB (p, μ, n "
          f"and flags at {F}x{P}): device {_device_us(x.sum):.2f} µs per "
          "call (profiler)", flush=True)
    return record


# Bytes read before each timed gather call, more than the card's 50 MB
# L2: back to back, a call's output lines still in L2 were written again
# by the next call without reaching device memory, which put the row
# gather below the bound of the bytes it must write.
L2_FLUSH_BYTES = 64 << 20
# ~0.1 ms of spinning on the card after the flush, in which the host
# enqueues the timed call.
COLD_SPIN_CYCLES = 200_000


def _time_gather(name: str, table, idx) -> dict:
    """Times of one gather kernel beside its plain version and the
    library call `torch.index_select(table, 0, idx)` (int32 idx; a
    yardstick only, the port never calls it), each call after a read of
    L2_FLUSH_BYTES (left out of the times), and its bound: each index
    read, each output written, and each table row the indices touch read
    once (rows that L2 serves again are not counted)."""
    from veloslam_tpu_torch.registration import gather as ga
    kernel = getattr(ga, name)
    plain = getattr(ga, f"{name}_plain")
    flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=idx.device)

    def library():
        return torch.index_select(table, 0, idx)

    def flush():
        flush_buf.sum()
        torch.cuda._sleep(COLD_SPIN_CYCLES)

    def cold(fn):
        return lambda: (flush_buf.sum(), fn())

    m = idx.shape[0]
    row_bytes = table[:1].numel() * table.element_size()
    nbytes = m * (4 + row_bytes) + torch.unique(idx).numel() * row_bytes
    bound_ms, bound_by = _bound(nbytes)
    calls = {"kernel": lambda: kernel(table, idx),
             "plain": lambda: plain(table, idx), "library": library}
    ms = {k: _cold_events_ms(fn, flush, TIMED_RUNS)
          for k, fn in calls.items()}
    out = {"ms": ms["kernel"], "plain_ms": ms["plain"],
           "library_ms": ms["library"], "bound_ms": bound_ms,
           "bound_by": bound_by}
    # torch.sum's kernel (reduce_kernel) is the flush: left out.  Every
    # kernel runs once a call (the plain version's two: the index cast and
    # the indexing); a trace on the card has been seen to hold 1 of 20.
    dev = {k: _device_us(cold(fn), skip="reduce_kernel")
           for k, fn in calls.items()}
    rate = (f"{nbytes / dev['kernel'] / 1e3:.0f} GB/s"
            if dev["kernel"] > 0 else "no GB/s")
    out["line"] = (
        f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
        f"index_select {out['library_ms']:.4f} ms per call (median of "
        f"{TIMED_RUNS} calls, each after a {L2_FLUSH_BYTES >> 20} MB read "
        f"that leaves the L2 cold); device µs per call (profiler): "
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
            model=cfg["model"], batched=True, use_dense=True,
            **cfg["odometry"])
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


def _bulk_inputs(device, batch_packets: int = 16384, model: str = "hdl32",
                 calib=None):
    """bench.py's bulk inputs, built with the port's simulator
    (bench_torch._host_inputs): a 0.35 s drive of `model` (simulated with
    `calib`, else its built-in table) tiled to `batch_packets` at the
    model's packet rate, a 64-sample straight-line INS window."""
    import bench_torch
    return [torch.as_tensor(a, device=device) for a in
            bench_torch._host_inputs(0, batch_packets, model, calib)]


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
              map_decay=reg["map_decay"], use_dense=True,
              sample_assembly=True)

    def step(state):
        return odo.odometry_step_batched(
            state, pkts, calib, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, **kw)

    fresh = odo.init_state(device=device, map_capacity=reg["map_capacity"],
                           voxel_size=reg["voxel_size"],
                           sample_assembly=True)
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
    seq = simulate_drive(drive, model)
    track = sim.truth_track(seq, drift_rate=drive["drift_rate"])

    def engine():
        return FullSlam(DeviceCalib.from_host(calibration.default_for(model),
                                              device=device),
                        model=model, use_dense=True, **drive["engine"])
    return seq, track, engine


def run_fullslam(seq, track, eng, drive: dict, floor: int) -> tuple:
    """Stream the drive, then queue and read the finalize sweep (its
    candidate budget the drive's "max_candidates", else sweep_budget's
    from `floor`): returns (results on the host, stream s, finalize s);
    each timed span ends in a device synchronize."""
    from veloslam_tpu_torch.runtime.pipeline import sweep_budget
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    eng.run_device(seq["packets"], seq["pkt_times_us"], track,
                   batch=drive["batch"])
    sync()
    t1 = time.perf_counter()
    budget = drive.get("max_candidates") or sweep_budget(eng, floor)
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
    runs, hosts = [], []
    for _ in range(FULLSLAM_RUNS):
        eng = engine()
        _reset_launches()
        host, stream_s, fin_s = run_fullslam(seq, track, eng, drive,
                                             cfg["budget_floor"])
        runs.append((stream_s, fin_s, _launches()))
        _check_fullslam(host, eng, seq, drive, gold, runs[-1][2], device)
        hosts.append(host)
    n = int(hosts[0]["n_frames"])
    stream_s, fin_s = (float(np.median([r[i] for r in runs]))
                       for i in (0, 1))
    launches = runs[-1][2]
    total = stream_s + fin_s
    # The stream's and the finalize's float sums run in a fixed order, so
    # every run gives the same bits: trajectories, keyframes, candidate
    # and accepted pairs, measurements, solved poses, all of it.
    _check_repeats("fullslam", hosts)
    print(f"[fullslam] the {FULLSLAM_RUNS} runs equal to the bit in all "
          f"{len(hosts[0])} outputs (trajectory, odometry, keyframes, "
          "candidate and accepted pairs, closure measurements, solved "
          "poses): z spread 0 m", flush=True)
    print(f"[fullslam] stream {stream_s:.3f} s + finalize {fin_s:.3f} s = "
          f"{total:.3f} s: {n / total:.1f} frames/s ({n / stream_s:.1f} "
          f"stream only; medians of {FULLSLAM_RUNS} runs, each from a fresh "
          f"engine, each checked); launches per run {launches}; {smi}",
          flush=True)
    return launches


def _check_repeats(where: str, runs: list) -> None:
    """Every run's outputs (dicts of numpy arrays and scalars) equal to
    the first run's to the bit."""
    first = runs[0]
    for k, run in enumerate(runs[1:], 1):
        if run.keys() != first.keys():
            raise AssertionError(f"{where}: run {k} has other outputs")
        differ = [key for key in first
                  if np.asarray(run[key]).tobytes()
                  != np.asarray(first[key]).tobytes()]
        if differ:
            raise AssertionError(f"{where}: run {k} differs from run 0 in "
                                 f"{differ}")


def _check_fullslam(host, eng, seq, drive, gold, launches, device,
                    name: str = "full"):
    """One run of a drive against the JAX golden's "<name>_*" record: at
    least 3 closures accepted (as many as the golden where it has fewer)."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"{name}_{k}"]

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
    if n_acc < min(3, int(g("accept").sum())):
        raise AssertionError(f"fullslam: {n_acc} closures accepted, want 3+")
    pos = host["traj_t"][:n]
    if not (np.isfinite(pos).all() and np.isfinite(host["traj_q"][:n]).all()):
        raise AssertionError("fullslam: non-finite corrected trajectory")
    # x, y within 5 cm; z within Z_LIMIT_M: on this drive the odometry's
    # height drifts by metres in both packages (z is barely observed), so
    # float sums taken in another order (the JAX package's, torch's CPU
    # ops') move the stream's z by up to a decimetre.  The finalize's
    # correction (corrected - stream) is printed beside it: it moves with
    # the stream's z, a few cm at most.
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
    print(f"[fullslam] {name}: {len(seq['packets'])} packets in {nb} "
          f"batches of "
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


# Sequences of the golden drives, simulated once per process: phases
# fullslam, pipeline, per_frame, paths, live, apps and multichip all
# replay bench.py's 7 s drive (~10 s of host simulation each time).
# SIM_SECONDS: seconds spent simulating, and seconds a reuse saved.
_SEQUENCES = {}
SIM_SECONDS = {"simulated": 0.0, "saved": 0.0}


def simulate_drive(drive: dict, model: str, calib=None) -> dict:
    """sim.generate_sequence of a golden drive (on its circle, or with
    "circle": None the simulator's default trajectory; with `calib`, a
    LaserCalib, else the model's built-in table).  Drives with the
    built-in table are simulated once and the same arrays returned to
    every caller, which only reads them."""
    from veloslam_tpu_torch.io import simulate as sim
    circle = drive.get("circle")
    key = json.dumps([drive["duration_s"], model, drive["seed"],
                      drive["world"], circle], sort_keys=True)
    if calib is None and key in _SEQUENCES:
        seq, secs = _SEQUENCES[key]
        SIM_SECONDS["saved"] += secs
        return seq
    t0 = time.perf_counter()
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=model, seed=drive["seed"],
        world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**circle) if circle else None,
        calib=calib)
    secs = time.perf_counter() - t0
    SIM_SECONDS["simulated"] += secs
    if calib is None:
        _SEQUENCES[key] = seq, secs
    return seq


def write_pipeline_drive(drive: dict, model: str, out_dir: str,
                         calib=None):
    """A golden drive as bench.py::_make_drive writes it, with the port's
    writers: the sequence (on a circle, or with "circle": None the
    simulator's default trajectory; simulated with `calib`, a LaserCalib,
    else the model's built-in table), its pcap (position packets every
    1 s) and INS log, the INS positions drifted in +y."""
    from veloslam_tpu_torch.io import packets as pk
    from veloslam_tpu_torch.io import simulate as sim
    seq = simulate_drive(drive, model, calib)
    paths = sim.write_sequence(seq, out_dir, name=drive["name"])
    ins = pk.read_ins_txt(paths["ins"])
    ts = (ins["t_us"] - ins["t_us"][0]) * 1e-6
    pk.write_ins_txt(paths["ins"], ins["t_us"],
                     ins["pos_xy"] + np.stack(
                         [np.zeros_like(ts), drive["drift_rate"] * ts], -1),
                     np.deg2rad(ins["yaw_deg"]), speed=ins["speed"])
    return paths, seq


def unit_calibration(spec: dict):
    """A per-unit calibration as the sensor's db.xml carries it: the
    model's built-in table with seeded perturbations of the two terms the
    simulator encodes (io/simulate.py: the rotational and the vertical
    correction of each laser), normal with the spec's deviations."""
    from veloslam_tpu_torch.decode import calibration
    base = calibration.default_for(spec["model"])
    rng = np.random.default_rng(spec["seed"])
    n = base.n_lasers
    return base._replace(
        rot_correction_deg=base.rot_correction_deg
        + rng.normal(0.0, spec["rot_sd_deg"], n),
        vert_correction_deg=base.vert_correction_deg
        + rng.normal(0.0, spec["vert_sd_deg"], n))


def write_models_drive(drive: dict, out_dir: str) -> tuple:
    """A drive of models_golden_seed3.npz written as write_pipeline_drive
    writes it, for its sensor `drive["model"]`; with a per-unit
    `drive["calibration"]` (unit_calibration's spec) the sequence is
    simulated with that calibration, the port's to_xml writes it to
    <out_dir>/db.xml, and the SlamConfig reads it from there.  Returns
    (paths, the sequence, the drive's SlamConfig as a dict)."""
    from veloslam_tpu_torch.decode import calibration
    spec = drive.get("calibration")
    calib = unit_calibration(spec) if spec else None
    paths, seq = write_pipeline_drive(drive, drive["model"], out_dir, calib)
    slam = json.loads(json.dumps(drive["slam"]))
    if calib is not None:
        paths["calibration"] = os.path.join(out_dir, "db.xml")
        calibration.to_xml(calib, paths["calibration"])
        slam["sensor"]["calibration_path"] = paths["calibration"]
    return paths, seq, slam


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
        walls, launches, outs = [], None, []
        for _ in range(PIPELINE_RUNS):
            _reset_launches()
            pipe, res, wall = run_pipeline(paths, drive, device)
            launches = _launches()
            _check_pipeline(pipe, res, seq, gold, name, launches,
                            fullslam_launches, device)
            walls.append(wall)
            outs.append(_pipeline_outputs(pipe, res))
        # Fixed-order sums in the stream, the finalize and the graph
        # solves: the runs repeat to the bit.
        _check_repeats("pipeline", outs)
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
          f"checked, equal to the bit in trajectory, keyframes, closures, "
          f"landmarks and map counts); launches per run {launches}; {smi}",
          flush=True)
    print(f"[pipeline] stage seconds, synchronized at each stage's end "
          f"({wall_sync:.3f} s wall, {sum(stages.values()):.3f} s in "
          f"stages): {stages}; {smi}", flush=True)
    return launches


def _pipeline_outputs(pipe, res) -> dict:
    """A batched-pipeline run's outputs for the bit-for-bit comparison of
    repeats: trajectory, keyframes, closures, landmarks, map counts."""
    g = pipe.graph
    return {**{k: res[k] for k in ("times_us", "positions", "quaternions",
                                   "keyframe_positions", "keyframe_times_us",
                                   "n_landmarks", "n_landmark_obs",
                                   "map_patches")},
            "closures": np.asarray(pipe.closures),
            "landmarks": g.l_pos[:g.n_landmarks],
            "obs_kept": g.o_ok[:g.n_obs],
            "map_count": map_tiles(pipe)[1]}


def _check_pipeline(pipe, res, seq, gold, name, launches, fullslam_launches,
                    device, max_ate: float = 0.15) -> None:
    """One pipeline run against the JAX golden; its launches equal to
    `fullslam_launches` unless that is None; the 2-D ATE at most the
    golden's + 0.02 m and at most `max_ate` (0.15 m: bench.py's HDL-32
    drive, whose golden reads 0.07 m)."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"{name}_{k}"]

    n = res["n_frames"]
    if n != int(g("n_frames")) or not np.array_equal(res["times_us"],
                                                     g("times_us")):
        raise AssertionError(f"pipeline {name}: {n} frames / times differ "
                             f"from the golden's {int(g('n_frames'))}")
    if res["n_keyframes"] != int(g("n_keyframes")) or not np.array_equal(
            res["keyframe_times_us"], g("keyframe_times_us")):
        raise AssertionError(f"pipeline {name}: {res['n_keyframes']} "
                             f"keyframes / times, golden "
                             f"{int(g('n_keyframes'))}")
    # As sets: near-tied proposal values may permute the slots on the card
    # (see _check_fullslam), not the graph.
    closures = sorted(pipe.closures)
    if closures != sorted(map(tuple, g("closures").tolist())):
        raise AssertionError(f"pipeline {name}: closure pairs {closures} "
                             f"differ from the golden's "
                             f"{g('closures').tolist()}")
    if len(closures) < min(3, len(g("closures"))):
        raise AssertionError(f"pipeline {name}: {len(closures)} closures, "
                             f"want 3+")
    pos = res["positions"]
    if not (np.isfinite(pos).all() and np.isfinite(res["quaternions"]).all()):
        raise AssertionError("pipeline: non-finite trajectory")
    off = float(np.linalg.norm(pos[:, :2] - g("positions")[:, :2],
                               axis=1).max())
    off_z = float(np.abs(pos[:, 2] - g("positions")[:, 2]).max())
    if not (off <= 0.05 and off_z <= Z_LIMIT_M):
        raise AssertionError(f"pipeline {name}: trajectory {off} m from the "
                             f"JAX golden in x, y, {off_z} m in z")
    counts = {k: (res[k], int(g(k))) for k in ("n_landmarks",
                                              "n_landmark_obs")}
    for k, (got, want) in counts.items():
        if not abs(got - want) <= 0.05 * want:
            raise AssertionError(f"pipeline {name}: {k} {got}, golden {want} "
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
    limit = min(float(g("ate")) + 0.02, max_ate)
    if not rmse <= limit:
        raise AssertionError(f"pipeline {name}: ATE {rmse} m > {limit} m")
    if device.type == "cuda" and not all(launches[k] for k in REG_KERNELS):
        raise AssertionError(f"pipeline {name}: a kernel was not launched: "
                             f"{launches}")
    if fullslam_launches is not None:
        _check_launches("pipeline", launches, fullslam_launches, device)
    print(f"[pipeline] {name}: {n} frames, {res['n_keyframes']} keyframes, "
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


def phase_bench(device, smi: str, reg: dict) -> dict:
    """bench_torch.py's stages on the card but the live sweep (phase live
    runs live mode): the bulk step from a warm map on _bulk_inputs' arrays
    with its launches counted, the primitive rates and the roofline
    (every fraction at most 1.05), the full-SLAM stage on bench.py's 20 s
    drive against the JAX golden (tests/fixtures/bench_golden_seed3.npz),
    and the headline record.  `reg`: the production registration config,
    which bench_torch's constants must equal.  Returns the launches of one
    bulk step and of the full-SLAM run."""
    import bench_torch as bt
    consts = {"reg_points": bt.REG_POINTS,
              "reg_iterations": bt.REG_ITERATIONS,
              "reassociate_every": bt.REASSOCIATE_EVERY,
              "map_capacity": bt.MAP_CAPACITY, "voxel_size": bt.VOXEL_SIZE}
    if any(reg[k] != v for k, v in consts.items()):
        raise AssertionError(f"bench: bench_torch's config {consts} is not "
                             f"the production one {reg}")
    inputs = bt._build_inputs(device=device)
    arrays = [x for k, x in enumerate(inputs) if k != 1]
    if not all(torch.equal(a, b) for a, b in zip(arrays,
                                                  _bulk_inputs(device))):
        raise AssertionError("bench: bulk inputs differ from _bulk_inputs'")
    _reset_launches()
    bulk = bt.run_bulk(inputs=inputs, device=device, empty_map_too=True)
    got = _launches()
    blocks = -(-bt.REG_ITERATIONS // bt.REASSOCIATE_EVERY)
    per_step = {"fused_normal_equations": bt.REG_ITERATIONS,
                "gather_i32": blocks, "gather_rows8": blocks}
    _check_launches(f"bench bulk ({bulk['steps']} steps)", got,
                    {k: v * bulk["steps"] for k, v in per_step.items()},
                    device)
    print(f"[bench] bulk step from a warm map: {bulk['ms']:.3f} ms/batch "
          f"(median of {len(bulk['ms_runs'])}, spread "
          f"{bulk['ms_spread'][0]:.3f}-{bulk['ms_spread'][1]:.3f}), "
          f"{bulk['frames_per_s']:.1f} frames/s; from the empty map, in "
          f"turns with it, {bulk['ms_from_empty_map']:.3f} ms (spread "
          f"{bulk['ms_from_empty_map_spread'][0]:.3f}-"
          f"{bulk['ms_from_empty_map_spread'][1]:.3f}); launches {got} over "
          f"{bulk['steps']} steps; {smi}", flush=True)
    card = bt.device_info(device)
    rates = bt.primitive_rates(device)
    roof = bt.run_roofline(bulk["ms"], rates, card)
    print(f"[bench] rates GB/s "
          f"{ {k: round(v['gb_per_s'], 1) for k, v in rates.items()} }; "
          f"roofline: {roof['bytes_per_batch_MB']} MB, HBM floor "
          f"{roof['hbm_floor_ms']} ms, primitive floor "
          f"{roof['primitive_floor_ms']} ms "
          f"{roof['primitive_floor_terms_ms']}, fractions "
          f"{roof['fraction_of_primitive_floor']} / "
          f"{roof['fraction_of_hbm_floor']}", flush=True)

    gold = np.load(BENCH_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = cfg["drives"][0]
    slam = dataclasses.asdict(bt._slam_cfg())
    slam.pop("mesh")
    if json.loads(json.dumps(slam)) != drive["slam"]:
        raise AssertionError("bench: bench_torch._slam_cfg() is not the "
                             "golden's config")
    seen = {}

    def check(pipe, res, seq):
        seen["launches"] = _launches()
        _check_bench_full(pipe, res, seq, gold, seen["launches"], device)

    _reset_launches()
    fs = bt.run_full_slam(duration_s=drive["duration_s"],
                          batch=drive["batch"], warm_s=0, device=device,
                          check=check)
    print(f"[bench] full SLAM on bench.py's {drive['duration_s']:.0f} s "
          f"drive: {fs}; launches {seen['launches']}; {smi}", flush=True)
    rec = json.loads(json.dumps(bt.headline(bulk["frames_per_s"], {
        "bulk_ms_per_batch": bulk["ms"], "full_slam": fs,
        "roofline": roof, "device": card})))
    if not (rec["metric"] == "hdl32_bulk_odometry_frames_per_s_per_chip"
            and np.isfinite(rec["value"]) and rec["value"] > 0):
        raise AssertionError(f"bench: bad headline record {rec}")
    print(f"[bench] headline {rec['metric']} = {rec['value']} "
          f"{rec['unit']}, vs_baseline {rec['vs_baseline']}", flush=True)
    return {"bulk_step": {k: v // max(bulk["steps"], 1)
                          for k, v in got.items()},
            "full_slam_20s": seen["launches"]}


def _check_bench_full(pipe, res, seq, gold, launches, device) -> None:
    """bench.py's 20 s full-SLAM run against the JAX golden: frames and
    times, keyframes and their times equal; closures equal as sets, or
    their count within 2% (the long drive's gate); trajectory within 5 cm
    in x, y and Z_LIMIT_M in z; 2-D ATE at most the golden's + 0.02 m;
    the registration kernels launched, the chain kernel not (at most 2048
    keyframes: dense solves)."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"full_{k}"]

    n = res["n_frames"]
    if n != int(g("n_frames")) or not np.array_equal(res["times_us"],
                                                     g("times_us")):
        raise AssertionError(f"bench: {n} frames / times differ from the "
                             f"golden's {int(g('n_frames'))}")
    if res["n_keyframes"] != int(g("n_keyframes")) or not np.array_equal(
            res["keyframe_times_us"], g("keyframe_times_us")):
        raise AssertionError(f"bench: {res['n_keyframes']} keyframes / "
                             f"times, golden {int(g('n_keyframes'))}")
    got = set(pipe.closures)
    want = set(map(tuple, g("closures").tolist()))
    if got != want and not abs(len(got) - len(want)) <= 0.02 * len(want):
        raise AssertionError(f"bench: {len(got)} closures, golden "
                             f"{len(want)} (more than 2% apart)")
    pos = res["positions"]
    if not (np.isfinite(pos).all() and np.isfinite(res["quaternions"]).all()):
        raise AssertionError("bench: non-finite trajectory")
    off = float(np.linalg.norm(pos[:, :2] - g("positions")[:, :2],
                               axis=1).max())
    off_z = float(np.abs(pos[:, 2] - g("positions")[:, 2]).max())
    if not (off <= 0.05 and off_z <= Z_LIMIT_M):
        raise AssertionError(f"bench: trajectory {off} m from the JAX "
                             f"golden in x, y, {off_z} m in z")
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    rmse = ate(pos[:, :2], truth[:, :2], align=False)["rmse"]
    limit = float(g("ate")) + 0.02
    if not rmse <= limit:
        raise AssertionError(f"bench: ATE {rmse} m > {limit} m")
    if device.type == "cuda":
        if not all(launches[k] for k in REG_KERNELS):
            raise AssertionError(f"bench: a kernel was not launched: "
                                 f"{launches}")
        if launches["chain_factor"] or launches["chain_solve"]:
            raise AssertionError(f"bench: the chain kernel launched below "
                                 f"the dense bound: {launches}")
    print(f"[bench] full: {n} frames, {res['n_keyframes']} keyframes equal "
          f"to the JAX golden's; closures {len(got)} (golden {len(want)}, "
          f"{len(got - want)} not in it, {len(want - got)} missing); "
          f"trajectory max {off:.2e} m from it in x, y, {off_z:.2e} m in z; "
          f"landmarks {res['n_landmarks']} (golden "
          f"{int(g('n_landmarks'))}); 2-D ATE {rmse:.4f} m (golden "
          f"{float(g('ate')):.4f}, limit {limit:.4f})", flush=True)


def run_perframe(paths: dict, drive: dict, device, timers=None) -> tuple:
    """One user run of slam_run's default mode: a fresh SlamPipeline,
    run_offline (pcap read included) + finalize; returns (pipeline,
    results, the closures accepted during the stream, wall s).  `timers`
    replaces the pipeline's stage timers."""
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]), device=device)
    if timers is not None:
        pipe.timers = timers
    sync()
    t0 = time.perf_counter()
    pipe.run_offline(paths["pcap"], paths["ins"])
    mid = list(pipe.closures)
    res = pipe.finalize()
    sync()
    return pipe, res, mid, time.perf_counter() - t0


def map_tiles(pipe) -> tuple:
    """(tile keys (T, 2) int64, per-tile voxel counts (T,) float64) in
    tile order, resident and spilled (the golden generators' reading)."""
    keys = sorted(set(pipe.map._patches) | set(pipe.map._spilled))
    counts = [float(pipe.map._materialize(k, create=False).count.sum())
              for k in keys]
    return (np.asarray(keys, np.int64).reshape(-1, 2),
            np.asarray(counts, np.float64))


def check_perframe(pipe, res, mid, seq, gold, name: str,
                   flags: bool = False, min_closures=None) -> str:
    """One per-frame run against the JAX golden (perframe_golden_seed3,
    or paths_golden_seed3 for the other registration methods): frames
    and their times, keyframe times and the landmark count equal; the
    closures accepted during the stream and in all equal as sets, at
    least `min_closures` (PERFRAME_MIN_CLOSURES[name]) in all; with
    `flags`, the per-frame registered flags equal; trajectory within
    5 cm in x, y and Z_LIMIT_M in z; 2-D ATE at most the golden's +
    0.02 m.  Where the golden records that the JAX package does not
    reproduce its own trajectory within those 5 cm when only the packet
    batching changes ("<name>_self_spread", paths_golden_seed3's NDT on
    the full drive), the gates that follow from the trajectory
    (keyframes, closures, landmarks, positions) are not applied: frames
    and times, the registered flags and the ATE are.  Where the golden
    records that its landmark clustering took a decision within
    ASSOC_MARGIN_M of the radius ("<name>_assoc_margin", live_golden_seed3's
    sessions), the finalized positions are held within ASSOC_FLIP_LIMIT_M
    in x, y instead of 5 cm.  Raises on a failure; returns a summary."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions

    def g(k):
        return gold[f"{name}_{k}"]

    n = res["n_frames"]
    fails = []
    if n != int(g("n_frames")) or not np.array_equal(res["times_us"],
                                                     g("times_us")):
        raise AssertionError(f"per_frame {name}: {n} frames / times differ "
                             f"from the golden's {int(g('n_frames'))}")
    spread = (float(g("self_spread")) if f"{name}_self_spread" in gold
              else 0.0)
    steady = spread <= 0.05
    margin = (float(g("assoc_margin")) if f"{name}_assoc_margin" in gold
              else np.inf)
    clustered = margin >= ASSOC_MARGIN_M
    if steady and not np.array_equal(res["keyframe_times_us"],
                                     g("keyframe_times_us")):
        fails.append(f"keyframe times ({res['n_keyframes']} keyframes, "
                     f"golden {int(g('n_keyframes'))})")
    want_mid = sorted(map(tuple, g("closures_mid").tolist()))
    want_all = sorted(map(tuple, g("closures").tolist()))
    if steady and sorted(mid) != want_mid:
        fails.append(f"mid-session closures {sorted(mid)}, golden "
                     f"{want_mid}")
    if steady and (sorted(pipe.closures) != want_all or len(
            pipe.closures) < (PERFRAME_MIN_CLOSURES[name]
                              if min_closures is None else min_closures)):
        fails.append(f"closures {sorted(pipe.closures)}, golden {want_all}")
    if steady and res["n_landmarks"] != int(g("n_landmarks")):
        fails.append(f"{res['n_landmarks']} landmarks, golden "
                     f"{int(g('n_landmarks'))}")
    reg = np.asarray([f.registered for f in pipe.trajectory])
    if flags and not np.array_equal(reg, g("registered")):
        fails.append(f"registered flags differ in frames "
                     f"{np.flatnonzero(reg != g('registered')).tolist()}")
    pos = res["positions"]
    off = off_z = float("inf")
    if np.isfinite(pos).all() and np.isfinite(res["quaternions"]).all():
        off = float(np.linalg.norm(pos[:, :2] - g("positions")[:, :2],
                                   axis=1).max())
        off_z = float(np.abs(pos[:, 2] - g("positions")[:, 2]).max())
    xy_limit = 0.05 if clustered else ASSOC_FLIP_LIMIT_M
    if steady and not (off <= xy_limit and off_z <= Z_LIMIT_M):
        fails.append(f"trajectory {off} m from the golden in x, y (limit "
                     f"{xy_limit} m), {off_z} m in z")
    truth = interpolate_positions(res["times_us"], seq["ins_t_us"],
                                  seq["ins_pos"])
    rmse = ate(pos[:, :2], truth[:, :2], align=False)["rmse"]
    limit = float(g("ate")) + 0.02
    if not rmse <= limit:
        fails.append(f"ATE {rmse} m > {limit} m")
    if fails:
        raise AssertionError(f"per_frame {name}: {'; '.join(fails)}")
    tiles, counts = map_tiles(pipe)
    same_tiles = np.array_equal(tiles, g("map_tiles"))
    rel = (float(np.abs(counts / g("map_tile_counts") - 1).max())
           if same_tiles else float("nan"))
    which = "the golden tiles" if same_tiles else "other tiles than golden"
    same = ", equal to the JAX golden's as sets" if steady else ""
    held = ("" if steady else
            f"the JAX package's own trajectory moves {spread:.3f} m with "
            f"its packet batching (golden self spread), so keyframes, "
            f"closures, landmarks and positions are shown, not gated "
            f"(keyframes {res['n_keyframes']}, golden "
            f"{int(g('n_keyframes'))}); ")
    if not clustered:
        held += (f"the golden's landmark clustering decided a detection "
                 f"{margin * 1e6:.0f} um from its radius, so the finalized "
                 f"positions are held within {ASSOC_FLIP_LIMIT_M} m in x, "
                 f"y; ")
    return (f"{held}{n} frames ({int(reg.sum())} registered, golden "
            f"{int(g('registered').sum())}), {res['n_keyframes']} "
            f"keyframes, closures {len(mid)} mid-session + "
            f"{len(pipe.closures) - len(mid)} at finalize"
            f"{same}; trajectory max {off:.2e} m from it in x, y, "
            f"{off_z:.2e} m in z; {res['n_landmarks']} landmarks (golden "
            f"{int(g('n_landmarks'))}), {res['n_landmark_obs']} "
            f"observations (golden {int(g('n_landmark_obs'))}); map "
            f"{len(tiles)} tiles ({which}), per-tile counts at most "
            f"{rel:.2e} from the golden's; 2-D ATE "
            f"{rmse:.4f} m (golden {float(g('ate')):.4f}, limit "
            f"{limit:.4f})")


def _perframe_outputs(pipe, res) -> dict:
    """A run's outputs for the bit-for-bit comparison of repeats."""
    g = pipe.graph
    tiles, counts = map_tiles(pipe)
    return {**{k: res[k] for k in ("times_us", "positions", "quaternions",
                                   "keyframe_positions", "keyframe_times_us",
                                   "n_landmarks", "n_landmark_obs")},
            "closures": np.asarray(pipe.closures),
            "landmarks": g.l_pos[:g.n_landmarks],
            "obs_kept": g.o_ok[:g.n_obs], "map_tiles": tiles,
            "map_tile_counts": counts}


def check_checkpoint(pipe, dirname: str) -> str:
    """save_checkpoint, then a fresh pipeline's load_checkpoint: equal
    frame meta (times, car poses, point counts, pcap sources) and frame
    payloads, INS track, graph and map tiles.  Returns a summary."""
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    t0 = time.perf_counter()
    pipe.save_checkpoint(dirname)
    saved = time.perf_counter() - t0
    other = SlamPipeline(pipe.cfg, device=pipe.device)
    other.load_checkpoint(dirname)
    (ta, va), (tb, vb) = (pipe.frames.all_frame_meta(),
                          other.frames.all_frame_meta())
    diff = []
    if not (np.array_equal(ta, tb) and va.keys() == vb.keys() and all(
            np.array_equal(va[k], vb[k]) for k in va)):
        diff.append("frame meta")
    if other.frames._sources != pipe.frames._sources:
        diff.append("frame sources")
    for t_us in (int(ta[0]), int(ta[len(ta) // 2]), int(ta[-1])):
        a, b = pipe.frames.get_frame_at(t_us), other.frames.get_frame_at(t_us)
        if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                           for k in a):
            diff.append(f"frame {t_us}")
    (qa, tra), (qb, trb) = (pipe.track.timeline.arrays(),
                            other.track.timeline.arrays())
    if not (np.array_equal(qa, qb) and all(np.array_equal(tra[k], trb[k])
                                           for k in tra)):
        diff.append("INS track")
    ga, gb = pipe.graph, other.graph
    for f in ("q", "t", "e_i", "e_j", "e_q", "e_t", "e_info", "l_pos",
              "o_i", "o_l", "o_z", "o_ok"):
        if not np.array_equal(getattr(ga, f), getattr(gb, f)):
            diff.append(f"graph {f}")
    keys = sorted(set(pipe.map._patches) | set(pipe.map._spilled))
    if keys != sorted(set(other.map._patches) | set(other.map._spilled)):
        diff.append("map tiles")
    else:
        for k in keys:
            pa = pipe.map._materialize(k, create=False)
            pb = other.map._materialize(k, create=False)
            if not all(np.array_equal(getattr(pa, f), getattr(pb, f))
                       for f in ("coords", "count", "s1", "s2")):
                diff.append(f"map tile {k}")
    if diff:
        raise AssertionError(f"checkpoint round trip differs in {diff}")
    return (f"checkpoint round trip: {len(ta)} frames' meta and payloads, "
            f"{len(qa)} INS poses, {ga.n_poses} keyframes / {ga.n_edges} "
            f"edges / {ga.n_landmarks} landmarks, {len(keys)} map tiles "
            f"equal after load_checkpoint (saved in {saved:.2f} s)")


def _tree_to(x, device=None):
    """Tensors (in NamedTuples, at any depth) cloned, onto `device` if
    given."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device or x.device, copy=True)
    if isinstance(x, tuple):
        items = [_tree_to(y, device) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def capturing_kernel_inputs(seen: dict, latest: bool = False):
    """While in the block, record the inputs (cloned) and keyword
    arguments of the first call (with `latest`, the last) of each
    registration kernel's wrapper at each distinct shape and keyword set,
    as registration/gicp.py, registration/voxel.py and
    parallel/sharded.py call them:
    `seen[(name, shapes, kw)] = (args, kw)`.  A stream's first frames
    meet an empty map; its last ones, a built one."""
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.parallel import sharded
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import voxel as vx

    def recorder(name, fn):
        def call(*args, **kw):
            key = (name, tuple(tuple(getattr(a, "shape", ())) for a in args
                               if not isinstance(a, se3.Pose)),
                   tuple(sorted(kw.items())))
            if latest or key not in seen:
                seen[key] = (_tree_to(args), dict(kw))
            return fn(*args, **kw)
        return call

    hooks = ((gicp, "gn_iteration"), (gicp, "fused_normal_equations"),
             (gicp, "gather_rows8"), (vx, "gather_i32"),
             (sharded, "gn_iteration"))
    saved = [getattr(mod, attr) for mod, attr in hooks]
    for (mod, attr), fn in zip(hooks, saved):
        setattr(mod, attr, recorder(attr, fn))
    try:
        yield seen
    finally:
        for (mod, attr), fn in zip(hooks, saved):
            setattr(mod, attr, fn)


CAPTURED = ("gn_iteration", "fused_normal_equations", "gather_i32",
            "gather_rows8")


def check_captured(seen: dict, smi: str, where: str = "per_frame",
                   want=CAPTURED, timed: bool = True) -> dict:
    """Each registration kernel against its plain version on the inputs a
    run gave it (capturing_kernel_inputs), at every shape of that run:
    the GN step and NE-only mode at _check_gn's and _check_ne's
    tolerances (no edge slots on real inputs), the gathers bitwise.  At
    the first shape of each the kernel's time beside its plain version's:
    on the per-frame path a frame's registration against the ROI for the
    GN step and the gathers, closure verification for NE-only (its only
    caller); without `timed`, no times.  Every wrapper in `want` must
    have been captured.  Returns the largest |Δ| of each kernel (H and b
    for the normal equations)."""
    from veloslam_tpu_torch.registration import gather as ga
    from veloslam_tpu_torch.registration import normal_equations as ne
    worst = dict.fromkeys(REG_KERNELS, 0.0)   # the gathers: bitwise
    done = set()
    for (name, _, _), (args, kw) in seen.items():
        if name in ("gn_iteration", "fused_normal_equations"):
            F, P = args[0].shape[:2]
            if name == "gn_iteration":
                pts, pose, mu, n, hit = args
                flat = (pts, pose.q, pose.t, mu, n, hit)
                errs = _check_gn(F, P, flat, edge_slots=False, **kw)
                kernel, plain = ne.gn_iteration, ne.gn_iteration_plain
            else:
                errs = _check_ne(F, P, args, **kw)
                kernel = ne.fused_normal_equations
                plain = ne.normal_equations_plain
            H, b = (errs["gn_H"], errs["gn_b"]) if "gn_H" in errs else (
                errs["H"], errs["b"])
            worst["fused_normal_equations"] = max(
                worst["fused_normal_equations"], H, b)
            line = (f"F={F} P={P} {kw}: within tolerance, bitwise "
                    f"repeatable; " + " ".join(f"{k}={v:.3g}"
                                               for k, v in errs.items()))
        else:
            table, idx = args
            kernel, plain = getattr(ga, name), getattr(ga, f"{name}_plain")
            got, ref = kernel(table, idx), plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{where} {name} at table "
                                     f"{tuple(table.shape)}, M "
                                     f"{idx.numel()}: not bitwise equal to "
                                     "the plain version")
            line = (f"table {tuple(table.shape)} M {idx.numel()} "
                    f"({torch.unique(idx).numel()} distinct): bitwise equal")
        if timed and name not in done:
            done.add(name)
            ms = [_events_ms(lambda f=f: f(*args, **kw), TIMED_RUNS, 10)
                  for f in (kernel, plain)]
            line += (f"; kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms per "
                     f"call (median of {TIMED_RUNS} runs of 10 calls); {smi}")
        print(f"[{where}] {name} on the warm run's own inputs at {line}",
              flush=True)
    missing = [k for k in want if not any(key[0] == k for key in seen)]
    if missing:
        raise AssertionError(f"{where}: no call of {missing} captured")
    return worst


def phase_per_frame(device, smi: str, name: str = "full") -> dict:
    """slam_run's default mode, the per-frame pipeline, on bench.py's
    full-SLAM drive (or, for a CPU rehearsal, `name="small"`) against the
    JAX golden (perframe_golden_seed3.npz): a warm run, whose kernel
    inputs are captured and each kernel held against its plain version
    on them (check_captured), PERFRAME_RUNS measured runs, each checked
    and all equal to the bit, the checkpoint round trip, then one run
    synchronized at each stage's end that counts the synchronizing
    operations by call site.  Returns (the kernel launches of one
    measured run, check_captured's largest |Δ| per kernel)."""
    import tempfile
    gold = np.load(PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    with tempfile.TemporaryDirectory() as tmp:
        paths, seq = write_pipeline_drive(drive, cfg["model"], tmp)
        # The warm run (the card's libraries) also records each
        # registration kernel's inputs at every shape the path gives it.
        with capturing_kernel_inputs({}) as seen:
            run_perframe(paths, drive, device)
        errs = dict.fromkeys(REG_KERNELS)       # not compared on the CPU
        if device.type == "cuda":
            errs = check_captured(seen, smi)
        print(f"[per_frame] {len(seen)} kernel shapes captured: "
              f"{sorted(seen)}", flush=True)
        del seen
        walls, outs = [], []
        for _ in range(PERFRAME_RUNS):
            _reset_launches()
            pipe, res, mid, wall = run_perframe(paths, drive, device)
            launches = _launches()
            summary = check_perframe(pipe, res, mid, seq, gold, name)
            if device.type == "cuda" and not (
                    all(launches[k] for k in REG_KERNELS)
                    and launches["chain_factor"] == launches["chain_solve"]
                    == 0):
                raise AssertionError(f"per_frame: launches {launches}: "
                                     f"want each of {REG_KERNELS} > 0 and "
                                     f"no chain launch")
            walls.append(wall)
            outs.append(_perframe_outputs(pipe, res))
        _check_repeats("per_frame", outs)
        ckpt = check_checkpoint(pipe, os.path.join(tmp, "checkpoint"))
        timers = SyncCountingStages()
        spipe, sres, smid, wall_sync = run_perframe(paths, drive, device,
                                                    timers)
        check_perframe(spipe, sres, smid, seq, gold, name)
        busy = "not measured (no card)"
        if device.type == "cuda":
            # The card's busy time in one more run: every kernel and copy
            # torch.profiler sees, over the measured runs' median wall.
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_perframe(paths, drive, device)
            busy_s = _kernel_us(prof) * 1e-6
            busy = (f"{busy_s:.3f} s busy (torch.profiler, one more run) "
                    f"of the {np.median(walls):.3f} s median wall: "
                    f"{1 - busy_s / np.median(walls):.1%} idle")
    wall = float(np.median(walls))
    n = res["n_frames"]
    print(f"[per_frame] {summary}; {smi}", flush=True)
    print(f"[per_frame] the {PERFRAME_RUNS} runs equal to the bit "
          f"(trajectory, keyframes, closures, landmarks, per-tile map "
          f"counts); {ckpt}; {smi}", flush=True)
    print(f"[per_frame] {n} frames in {wall:.3f} s: {n / wall:.2f} frames/s "
          f"(run_offline + finalize, pcap read included; median of "
          f"{PERFRAME_RUNS} runs {[round(w, 3) for w in walls]}); launches "
          f"per run {launches}; the card {busy}; {smi}", flush=True)
    stages = {k: round(v["total_s"], 4) for k, v in sres["timing"].items()}
    sites = {}
    for per_stage in timers.sites.values():
        for site, c in per_stage.items():
            sites[site] = sites.get(site, 0) + c
    top = sorted(sites.items(), key=lambda kv: -kv[1])
    stage_launches = {k: {kk: vv for kk, vv in v.items() if vv}
                      for k, v in timers.launches.items()}
    print(f"[per_frame] stage seconds, synchronized at each stage's end "
          f"({wall_sync:.3f} s wall; nested stages: 'frame' holds "
          f"'register', 'map_update' and the keyframes' sweeps): {stages}; "
          f"{smi}", flush=True)
    print(f"[per_frame] synchronizing operations: "
          f"{sum(sites.values())} in the run, "
          f"{sum(sites.values()) / n:.1f} per frame; per stage "
          f"{timers.syncs}; per frame by call site "
          f"{ {k: round(v / n, 2) for k, v in top} }; launches per stage "
          f"{stage_launches}; {smi}", flush=True)
    return launches, errs


@contextlib.contextmanager
def capturing_registrations(calls: list, every: int):
    """While in the block, record every `every`-th call of the D2D and NDT
    registrations (`d2d.register_d2d`, `ndt.register`, as the per-frame
    pipeline calls them) with its inputs cloned: `calls` gets (function,
    args, kwargs)."""
    from veloslam_tpu_torch.registration import d2d, ndt
    hooks = ((d2d, "register_d2d"), (ndt, "register"))
    saved = [getattr(mod, attr) for mod, attr in hooks]

    def recorder(fn):
        seen = [0]

        def call(*args, **kw):
            if seen[0] % every == 0:
                calls.append((fn, _tree_to(args), dict(kw)))
            seen[0] += 1
            return fn(*args, **kw)
        return call

    for (mod, attr), fn in zip(hooks, saved):
        setattr(mod, attr, recorder(fn))
    try:
        yield calls
    finally:
        for (mod, attr), fn in zip(hooks, saved):
            setattr(mod, attr, fn)


def check_registrations(calls: list, where: str) -> str:
    """Each recorded registration run again on its own inputs and on a
    CPU copy of them (the port's CPU path, which the CPU tests hold to
    the JAX package): positions within 1 mm, quaternions within 1e-4,
    matches within 1%.  Returns a summary."""
    dt = dq = dm = 0.0
    for fn, args, kw in calls:
        got = fn(*args, **kw)
        ref = fn(*_tree_to(args, "cpu"), **kw)
        dt = max(dt, float((got.pose.t.cpu() - ref.pose.t).abs().max()))
        dq = max(dq, float((got.pose.q.cpu() - ref.pose.q).abs().max()))
        m, r = int(got.n_matched), int(ref.n_matched)
        dm = max(dm, abs(m - r) / max(r, 1))
    if not (calls and dt <= 1e-3 and dq <= 1e-4 and dm <= 0.01):
        raise AssertionError(f"{where}: {len(calls)} registrations against "
                             f"their CPU runs: |Δt| {dt}, |Δq| {dq}, "
                             f"matches {dm:.2%} apart")
    return (f"{len(calls)} of its registrations run again on the CPU on "
            f"the same inputs: |Δt| ≤ {dt:.2e} m, |Δq| ≤ {dq:.2e}, "
            f"matches within {dm:.2%}")


def run_odometry(seq, track, device, model: str, batch: int, calib=None,
                 **flags):
    """One StreamingOdometry run over a whole drive (the engine built
    with `flags`, on `calib`, else the model's built-in table); returns
    (results, wall s, engine)."""
    from veloslam_tpu_torch.decode import calibration
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.runtime.odometry import StreamingOdometry
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    eng = StreamingOdometry(
        DeviceCalib.from_host(calib or calibration.default_for(model),
                              device=device),
        model=model, **flags)
    sync()
    t0 = time.perf_counter()
    res = eng.run(seq["packets"], seq["pkt_times_us"], track, batch=batch)
    sync()
    return res, time.perf_counter() - t0, eng


def _paths_per_frame(device, smi, gold, cfg, drive, tmp) -> tuple:
    """Part 1 of phase `paths`: the per-frame pipeline with registration
    method D2D or NDT against the golden: a warm run whose kernel inputs
    are captured and held against the plain versions, then PATHS_RUNS
    runs, each checked (check_perframe with the registered flags) and
    all equal to the bit; the last synchronizes at each stage's end and
    counts the synchronizing operations.  Returns (launches of one run,
    check_captured's largest |Δ| or None on the CPU)."""
    name = drive["name"]
    paths, seq = write_pipeline_drive(drive, cfg["model"], tmp)
    with capturing_kernel_inputs({}) as seen, \
            capturing_registrations([], PATHS_RECHECK_EVERY) as calls:
        run_perframe(paths, drive, device)
    errs = (check_captured(seen, smi, f"paths {name}")
            if device.type == "cuda" else None)
    rechecked = check_registrations(calls, f"paths {name}")
    del seen, calls
    walls, outs = [], []
    timers = SyncCountingStages()
    for i in range(PATHS_RUNS):
        last = i == PATHS_RUNS - 1
        _reset_launches()
        pipe, res, mid, wall = run_perframe(paths, drive, device,
                                            timers if last else None)
        launches = _launches()
        summary = check_perframe(pipe, res, mid, seq, gold, name, flags=True,
                                 min_closures=PATHS_MIN_CLOSURES[name])
        outs.append(_perframe_outputs(pipe, res))
        if not last:
            walls.append(wall)
    _check_repeats(f"paths {name}", outs)
    n = res["n_frames"]
    # Every GN iteration of a frame with a map around it searches its
    # correspondences once: one gather_i32 launch.
    iters = pipe.cfg.registration.max_iterations
    if device.type == "cuda" and not (
            launches["gather_i32"] >= iters * (n - 1)
            and launches["chain_factor"] == launches["chain_solve"] == 0):
        raise AssertionError(f"paths {name}: launches {launches}: want "
                             f"gather_i32 >= {iters * (n - 1)}, no chain")
    wall = float(np.median(walls))
    stages = {k: round(v["total_s"], 4) for k, v in res["timing"].items()}
    syncs = sum(sum(v.values()) for v in timers.sites.values())
    print(f"[paths] per_frame {name}: {summary}; {rechecked}; {smi}",
          flush=True)
    print(f"[paths] per_frame {name}: the {PATHS_RUNS} runs equal to the "
          f"bit; {n} frames in {wall:.3f} s: {n / wall:.2f} frames/s "
          f"(run_offline + finalize, pcap read included; median of "
          f"{len(walls)} unsynchronized runs {[round(w, 3) for w in walls]}"
          f"); launches per run {launches} ({launches['gather_i32'] / n:.1f}"
          f" gather_i32 a frame); stage seconds, synchronized: {stages}; "
          f"{syncs} synchronizing operations, {syncs / n:.1f} a frame; "
          f"{smi}", flush=True)
    return launches, errs


def _check_odometry(where: str, res, gold, key: str) -> float:
    """An odometry run against its golden: frames and times exact,
    positions within 1 cm; returns the largest offset."""
    if res["n_frames"] != int(gold[f"{key}_n_frames"]) or not \
            np.array_equal(res["times_us"], gold[f"{key}_times_us"]):
        raise AssertionError(f"{where}: {res['n_frames']} frames / times "
                             f"differ from the golden's")
    off = float(np.linalg.norm(res["positions"] - gold[f"{key}_positions"],
                               axis=1).max())
    if not (np.isfinite(res["quaternions"]).all() and off <= 0.01):
        raise AssertionError(f"{where}: {off} m from the JAX golden")
    return off


def _paths_odometry(device, smi, gold, cfg) -> tuple:
    """Parts 2 and 3 of phase `paths`: StreamingOdometry with the JAX
    defaults (fused, exact search) in PATHS_FUSED_BATCH-packet batches,
    and slam_run --fast's engine (batched, frame sampling, exact search)
    in PATHS_FAST_BATCH-packet batches, on the odometry golden's two
    drives against the paths golden; the chained path (fused=False)
    equal to the fused one to the bit.  A warm run of each drive and
    engine records the kernel inputs and counts the synchronizing
    operations.  Returns ({part: launches over both drives}, the kernel
    inputs seen)."""
    from veloslam_tpu_torch.io import simulate as sim
    oc = cfg["odometry"]
    model = oc["model"]
    engines = {"fused": ({}, cfg["fused_batch"]),
               "fast": (dict(n_beams=32, batched=True), cfg["fast_batch"])}
    launches = {part: {} for part in engines}
    seen = {}
    for drive in oc["drives"]:
        seq = sim.generate_sequence(duration_s=oc["duration_s"], model=model,
                                    seed=oc["seed"],
                                    world=sim.World.demo(**drive["world"]))
        track = sim.truth_track(seq, drift_rate=drive["drift_rate"])
        for part, (flags, batch) in engines.items():
            key = f"{part}_{drive['name']}"
            with capturing_kernel_inputs(seen, latest=True), \
                    _watching_syncs({}) as sites:
                _, _, warm = run_odometry(seq, track, device, model, batch,
                                          **flags)
            _reset_launches()
            res, secs, eng = run_odometry(seq, track, device, model, batch,
                                          **flags)
            got = _launches()
            nb, n = eng.batches_fed, res["n_frames"]
            # One association and one GN step per iteration: a frame at a
            # time on the fused path, a batch at a time on the batched.
            steps = eng.reg_iterations * (nb if part == "fast" else n)
            _check_launches(f"paths {key}", got, {
                k: steps for k in REG_KERNELS}, device)
            launches[part] = {k: launches[part].get(k, 0) + v
                              for k, v in got.items()}
            off = _check_odometry(f"paths {key}", res, gold, key)
            line = (f"[paths] {key}: {n} frames in {nb} batches (up to "
                    f"{batch} packets), {secs:.3f} s: {n / secs:.1f} "
                    f"frames/s; max "
                    f"{off:.2e} m from the JAX golden, times exact; launches "
                    f"{got}; {sum(sites.values())} synchronizing operations "
                    f"in the warm run, "
                    f"{sum(sites.values()) / warm.batches_fed:.2f} a batch "
                    f"({sites})")
            if part == "fused":
                chained, _, _ = run_odometry(seq, track, device, model,
                                             batch, fused=False)
                _check_repeats(f"paths chained {key}", [
                    {k: res[k] for k in ("times_us", "positions",
                                         "quaternions")},
                    {k: chained[k] for k in ("times_us", "positions",
                                             "quaternions")}])
                line += "; the chained path equal to it to the bit"
            print(f"{line}; {smi}", flush=True)
    return launches, seen


def _paths_batched(device, smi, gold, cfg, drive, tmp) -> tuple:
    """Part 4 of phase `paths`: the batched pipeline with
    use_dense_index=False (the exact binary-search lookup) against the
    golden with phase `pipeline`'s gates: a warm run whose kernel inputs
    are captured, then PIPELINE_RUNS runs, each checked, all equal to the
    bit.  Returns (launches of one run, the kernel inputs seen)."""
    name = drive["name"]
    paths, seq = write_pipeline_drive(drive, cfg["model"], tmp)
    with capturing_kernel_inputs({}, latest=True) as seen:
        run_pipeline(paths, drive, device)
    walls, outs = [], []
    for _ in range(PIPELINE_RUNS):
        _reset_launches()
        pipe, res, wall = run_pipeline(paths, drive, device)
        launches = _launches()
        _check_pipeline(pipe, res, seq, gold, name, launches, None, device)
        walls.append(wall)
        outs.append({k: res[k] for k in ("times_us", "positions",
                                         "quaternions", "keyframe_positions",
                                         "n_landmarks", "n_landmark_obs")}
                    | {"closures": np.asarray(pipe.closures)})
    _check_repeats(f"paths {name}", outs)
    wall = float(np.median(walls))
    n = res["n_frames"]
    print(f"[paths] batched {name}: {n} frames in {wall:.3f} s: "
          f"{n / wall:.1f} frames/s (median of {PIPELINE_RUNS} runs "
          f"{[round(w, 3) for w in walls]}, each checked, equal to the "
          f"bit); launches per run {launches}; {smi}", flush=True)
    return launches, seen


def phase_paths(device, smi: str, size: str = "full") -> tuple:
    """The paths ported last, against paths_golden_seed3.npz: the
    per-frame pipeline with D2D and with NDT registration, StreamingOdometry
    with the JAX defaults (fused, and chained to the bit), slam_run
    --fast's engine, and the batched pipeline with the binary-search
    lookup; `size="small"` takes the small drives (a CPU rehearsal).
    Every kernel is held against its plain version on the inputs these
    paths gave it.  Returns ({part: launches}, the largest |Δ| per
    kernel)."""
    import tempfile
    gold = np.load(PATHS_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    frame_drives = {d["name"]: d for d in cfg["per_frame"]}
    launches, worst = {}, dict.fromkeys(REG_KERNELS, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for method in ("d2d", "ndt"):
            got, errs = _paths_per_frame(device, smi, gold, cfg,
                                         frame_drives[f"{method}_{size}"],
                                         tmp)
            launches[f"per_frame_{method}"] = got
            for k, v in (errs or {}).items():
                worst[k] = max(worst[k], v)
        odo_launches, seen = _paths_odometry(device, smi, gold, cfg)
        launches.update(odo_launches)
        search = {d["name"]: d for d in cfg["batched"]}[f"search_{size}"]
        launches["batched_search"], seen_b = _paths_batched(
            device, smi, gold, cfg, search, tmp)
    seen.update(seen_b)
    if device.type == "cuda":
        errs = check_captured(seen, smi, "paths odometry and batched",
                              want=("gn_iteration", "gather_i32",
                                    "gather_rows8"))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    print(f"[paths] {len(seen)} kernel shapes captured on the odometry and "
          f"batched paths: {sorted(seen)}", flush=True)
    return launches, worst


class ScriptedUdp:
    """A recorded live session standing in for io.udp.UdpReceiver in
    SlamPipeline.run_online, the port's or the JAX package's (install it
    with `scripted_udp`): `streams` maps a port to its datagrams, a list
    of (payload bytes, receive time µs).  Every other port's datagrams
    come first, each port's in polls of up to max_packets; then the LiDAR
    port's in chunks of `chunk`; then empty polls, so the session ends
    at run_online's idle timeout.  With the time base latched on the
    first INS datagram or position packet and batches of a fixed size,
    run_online's result depends only on the datagrams, not on how polls
    chunk them: the deterministic stand-in for real UDP."""

    def __init__(self, streams: dict, lidar_port: int,
                 chunk: int = LIVE_CHUNK):
        self.queues = {p: list(v) for p, v in streams.items()}
        self.lidar_port = lidar_port
        self.chunk = chunk

    def _take(self, port: int, max_packets: int) -> list:
        q = self.queues.get(port, [])
        n = max_packets
        if port == self.lidar_port:
            if any(v for p, v in self.queues.items() if p != port):
                return []
            n = min(self.chunk, max_packets)
        self.queues[port] = q[n:]
        return q[:n]

    def receiver_class(self):
        """A UdpReceiver-shaped class over this session."""
        script = self

        class ScriptedReceiver:
            dropped = 0

            def __init__(self, port, payload_size, capacity=16384,
                         force_python=False, variable=False):
                self.port, self.payload_size = port, payload_size

            def poll_var(self, max_packets=4096):
                items = script._take(self.port, max_packets)
                pkts = np.zeros((len(items), self.payload_size), np.uint8)
                lens = np.zeros(len(items), np.int32)
                for i, (d, _) in enumerate(items):
                    pkts[i, :len(d)] = np.frombuffer(d, np.uint8)
                    lens[i] = len(d)
                return pkts, lens, np.asarray([t for _, t in items],
                                              np.int64)

            def poll(self, max_packets=4096):
                pkts, _, times = self.poll_var(max_packets)
                return pkts, times

            def close(self):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.close()

        return ScriptedReceiver


@contextlib.contextmanager
def scripted_udp(udp_module, script: ScriptedUdp):
    """While in the block, `udp_module.UdpReceiver` (io/udp.py of either
    package, which run_online looks up when it runs) is the script's."""
    saved = udp_module.UdpReceiver
    udp_module.UdpReceiver = script.receiver_class()
    try:
        yield script
    finally:
        udp_module.UdpReceiver = saved


def ins_payloads(replay_ins_txt, udp_module, ins_path: str, origin) -> list:
    """The InsPVA datagrams `replay_ins_txt` (apps/replay.py of either
    package) sends for an INS text log, captured from `udp_module.
    send_struct` instead of sent, unpaced."""
    sent = []
    saved = udp_module.send_struct
    udp_module.send_struct = (lambda payload, dest_ip="127.0.0.1", port=0:
                              sent.append(bytes(payload)))
    try:
        replay_ins_txt(ins_path, "127.0.0.1", 0, origin,
                       rate_hz=float("inf"))
    finally:
        udp_module.send_struct = saved
    return sent


def live_streams(drive: dict, paths: dict, ins: list) -> dict:
    """A live drive's datagrams by port, as ScriptedUdp takes them: the
    pcap's LiDAR packets at their record times; with drive["ins"] the
    InsPVA payloads `ins` (receive time 0), with drive["position"] the
    pcap's position packets."""
    from veloslam_tpu_torch.io.pcap import (read_lidar_packets,
                                            read_position_packets)
    pkts, times, _ = read_lidar_packets(paths["pcap"])
    streams = {LIVE_PORTS["lidar"]: [(p.tobytes(), int(t))
                                     for p, t in zip(pkts, times)]}
    if drive["ins"]:
        streams[LIVE_PORTS["ins"]] = [(p, 0) for p in ins]
    if drive["position"]:
        pos, ptimes = read_position_packets(paths["pcap"])
        streams[LIVE_PORTS["position"]] = [(p.tobytes(), int(t))
                                           for p, t in zip(pos, ptimes)]
    return streams


def run_live_scripted(pipe, udp_module, streams: dict, fast: bool,
                      origin) -> tuple:
    """One scripted live session of `pipe` (either package's
    SlamPipeline): run_online over `streams`, then finalize().  Returns
    (the run_online result, the closures accepted before finalize, the
    finalize result)."""
    script = ScriptedUdp(streams, LIVE_PORTS["lidar"])
    with scripted_udp(udp_module, script):
        live = pipe.run_online(lidar_port=LIVE_PORTS["lidar"],
                               ins_port=LIVE_PORTS["ins"],
                               position_port=LIVE_PORTS["position"],
                               origin_llh_deg=origin,
                               idle_timeout_s=LIVE_IDLE_S, fast=fast)
    mid = list(pipe.closures)
    return live, mid, pipe.finalize()


def assoc_margin(q, t, keyframe_posts, radius: float) -> float:
    """The smallest |distance - radius| over the decisions that
    graph/landmark_assoc.py::associate_and_add's greedy clustering takes
    on these keyframe poses and detections (its arithmetic, float32):
    how near the clustering came to deciding otherwise."""
    centers, counts, worst = [], [], np.inf
    for k, dets in enumerate(keyframe_posts):
        if k >= len(q) or len(dets) == 0:
            continue
        w0, x, y, z = (float(v) for v in q[k])
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w0 * z),
             2 * (x * z + w0 * y)],
            [2 * (x * y + w0 * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w0 * x)],
            [2 * (x * z - w0 * y), 2 * (y * z + w0 * x),
             1 - 2 * (x * x + y * y)]], np.float32)
        world = (np.asarray(dets, np.float32) @ R.T
                 + np.asarray(t[k], np.float32))
        for wp in world:
            for c_idx, c in enumerate(centers):
                dist = np.linalg.norm(wp[:2] - c[:2])
                worst = min(worst, abs(float(dist) - radius))
                if dist < radius:
                    n = counts[c_idx]
                    centers[c_idx] = (c * n + wp) / (n + 1)
                    counts[c_idx] += 1
                    break
            else:
                centers.append(wp.copy())
                counts.append(1)
    return worst


def check_live_stream(where: str, live: dict, gold, key: str) -> float:
    """The trajectory run_online returns (before finalize) against the
    golden's: frames and times equal, positions within 5 cm in x, y and
    Z_LIMIT_M in z.  Returns the x, y offset."""
    want = gold[f"{key}_stream_positions"]
    pos = live["positions"]
    if not (np.array_equal(live["times_us"], gold[f"{key}_stream_times_us"])
            and pos.shape == want.shape and np.isfinite(pos).all()):
        raise AssertionError(f"{where}: run_online's frames or times differ "
                             f"from the golden's")
    off = float(np.linalg.norm(pos[:, :2] - want[:, :2], axis=1).max())
    off_z = float(np.abs(pos[:, 2] - want[:, 2]).max())
    if not (off <= 0.05 and off_z <= Z_LIMIT_M):
        raise AssertionError(f"{where}: run_online's trajectory {off} m from "
                             f"the golden's in x, y, {off_z} m in z")
    return off


def stream_ate(times_us, positions, seq) -> float:
    """2-D ATE (RMSE, unaligned) of a trajectory against the drive's
    truth at its frame times."""
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
    truth = interpolate_positions(np.asarray(times_us), seq["ins_t_us"],
                                  seq["ins_pos"])
    return ate(np.asarray(positions)[:, :2], truth[:, :2],
               align=False)["rmse"]


def live_counts(pipe, live: dict, res: dict) -> dict:
    """What a live session must reproduce exactly besides its frames:
    the INS and GPS health, the IMU log's length and live_stats' counts."""
    keep = ("lidar_packets", "ins_datagrams", "position_packets", "batches",
            "lidar_dropped", "ins_dropped")
    return {"ins_health": res["ins_health"], "gps_health": res["gps_health"],
            "imu_log": len(pipe.imu_log),
            "live_stats": {k: live["live_stats"][k] for k in keep}}


def check_live_counts(where: str, got: dict, want: dict) -> None:
    """Health dicts and counts equal (floats as JSON gives them back)."""
    got = json.loads(json.dumps(got))
    if got != want:
        raise AssertionError(f"{where}: live counts {got}, golden {want}")


def _live_gate(where: str, launches: dict, device) -> None:
    """The registration kernels launched on a live path, the chain kernel
    not (K stays under DENSE_MAX_POSES); on the CPU none."""
    if device.type != "cuda":
        _check_launches(where, launches, {}, device)
        return
    if not (all(launches[k] for k in REG_KERNELS)
            and launches["chain_factor"] == launches["chain_solve"] == 0):
        raise AssertionError(f"{where}: launches {launches}: want each of "
                             f"{REG_KERNELS} > 0 and no chain launch")


def _loopback_ins_ahead(device, slam, origin, ins: list, pkts,
                        pkt_per_s: float) -> tuple:
    """run_online per frame over real loopback UDP with the native
    receiver and sender: every InsPVA datagram first (LIVE_INS_GAP_S
    apart), then the LiDAR packets at `pkt_per_s` on average
    (udp.replay_packets).  Returns (pipeline, result, packets sent, the
    LiDAR sender's udp.paced stats, s from the last packet sent to the
    session's end less the idle timeout)."""
    import threading

    from veloslam_tpu_torch.apps import replay
    from veloslam_tpu_torch.io import udp
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    ports = [replay.free_udp_port() for _ in range(3)]
    sent = {}

    def send():
        for p in ins:
            udp.send_struct(p, "127.0.0.1", ports[1])
            time.sleep(LIVE_INS_GAP_S)
        sent["lidar"] = udp.replay_packets(pkts, "127.0.0.1", ports[0],
                                           1e6 / pkt_per_s, stats=sent)
        sent["done"] = time.monotonic()

    sender = threading.Thread(target=send, daemon=True)
    pipe = SlamPipeline(slam, device=device)
    live = pipe.run_online(lidar_port=ports[0], ins_port=ports[1],
                           position_port=ports[2], origin_llh_deg=origin,
                           idle_timeout_s=LIVE_LOOPBACK_IDLE_S,
                           on_ready=sender.start)
    end = time.monotonic()
    sender.join(timeout=60)
    if sender.is_alive() or "lidar" not in sent:
        raise AssertionError("live loopback: the sender did not finish")
    return (pipe, live, sent["lidar"], sent,
            end - sent["done"] - LIVE_LOOPBACK_IDLE_S)


def phase_live(device, smi: str, name: str = "full") -> tuple:
    """Live mode (SlamPipeline.run_online) on bench.py's drive (or, for a
    CPU rehearsal, `name="small"`), against live_golden_seed3.npz:

    1. Scripted: the JAX golden's session through ScriptedUdp, per frame
       and fast, each + finalize(), with phase per_frame's gates, the
       health dicts and counts equal; the registration kernels launched
       and each held against its plain version on the inputs these runs
       gave it.  The InsPVA payloads are the port's replay_ins_txt's,
       equal to the golden's.
    2. Real loopback, INS ahead, per frame: the same datagrams over
       localhost UDP (the packet pump's receiver and sender), LiDAR at
       the sensor's pace; none lost or dropped, and the frames, times
       and poses equal to the bit to step 1's run_online.
    3. Real loopback, INS interleaved at 100 Hz (measure_live_loopback,
       both senders on one clock): fast at 1× and 2× the sensor's pace,
       then per frame at 1×; none lost or dropped, every INS datagram
       received, frames at least the golden's - 1, every position
       finite, run_online's 2-D ATE against the drive's truth at most
       the golden session's + 0.02 m; sustained pkt/s, the INS sender's
       Hz, both senders' worst lateness and the batch feed time beside
       the batch period.

    Returns ({part: launches}, the largest |Δ| per kernel)."""
    import tempfile

    from veloslam_tpu_torch.apps import replay
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.io import udp
    from veloslam_tpu_torch.io.pcap import read_lidar_packets
    from veloslam_tpu_torch.runtime.odometry import packets_per_second
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    gold = np.load(LIVE_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    origin = tuple(cfg["origin"])
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    slam = SlamConfig.from_dict(drive["slam"])
    launches, worst, scripted = {}, dict.fromkeys(REG_KERNELS, 0.0), {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, seq = write_pipeline_drive(drive, cfg["model"], tmp)
        ins = ins_payloads(replay.replay_ins_txt, udp, paths["ins"], origin)
        if ins != [r.tobytes() for r in gold[f"{name}_ins_payloads"]]:
            raise AssertionError("live: replay_ins_txt's InsPVA payloads "
                                 "differ from the JAX package's")
        streams = live_streams(drive, paths, ins)
        for mode in drive["modes"]:
            key = f"{name}_{mode}"
            pipe = SlamPipeline(slam, device=device)
            _reset_launches()
            t0 = time.perf_counter()
            with capturing_kernel_inputs({}, latest=True) as seen:
                live, mid, res = run_live_scripted(pipe, udp, streams,
                                                   mode == "fast", origin)
            wall = time.perf_counter() - t0
            got = launches[f"scripted_{mode}"] = _launches()
            stream_off = check_live_stream(f"live {key}", live, gold, key)
            summary = check_perframe(pipe, res, mid, seq, gold, key,
                                     min_closures=LIVE_MIN_CLOSURES[name])
            check_live_counts(f"live {key}", live_counts(pipe, live, res),
                              json.loads(str(gold[f"{key}_live"])))
            _live_gate(f"live scripted {mode}", got, device)
            if device.type == "cuda":
                errs = check_captured(
                    seen, smi, f"live {mode}",
                    want=CAPTURED if mode == "per_frame"
                    else ("gn_iteration", "gather_i32"))
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
            del seen
            scripted[mode] = live
            print(f"[live] scripted {mode}: run_online's trajectory "
                  f"{stream_off:.2e} m from the golden's before finalize; "
                  f"after it {summary}; health and counts "
                  f"equal to the golden's ({live['live_stats']}); "
                  f"run_online + finalize {wall:.3f} s with the kernel "
                  f"inputs captured; launches {got}; {smi}", flush=True)
        pkts, _, _ = read_lidar_packets(paths["pcap"])
        pps = packets_per_second(cfg["model"])
        B = slam.pipeline.packets_per_batch
        if drive["ins"]:
            _reset_launches()
            pipe, live, sent, pacing, lag = _loopback_ins_ahead(
                device, slam, origin, ins, pkts, pps)
            got = launches["loopback_ins_ahead_per_frame"] = _launches()
            st = live["live_stats"]
            ref = scripted["per_frame"]
            same = all(np.array_equal(live[k], ref[k]) for k in
                       ("times_us", "positions", "quaternions"))
            if not (sent - st["lidar_packets"] == 0
                    and st["lidar_dropped"] == 0 and st["ins_dropped"] == 0
                    and st["ins_datagrams"] == len(ins) and same):
                raise AssertionError(
                    f"live loopback, INS ahead: sent {sent}, stats {st}, "
                    f"{len(ins)} INS sent; equal to the scripted run to "
                    f"the bit: {same}")
            _live_gate("live loopback INS ahead", got, device)
            print(f"[live] loopback, INS ahead, per frame at 1x "
                  f"({pps:.1f} pkt/s, {B / pps * 1e3:.1f} ms a "
                  f"{B}-packet batch): {sent} sent in "
                  f"{pacing['send_s']:.3f} s ({(sent - 1) / pacing['send_s']:.1f}"
                  f" pkt/s, at worst {pacing['max_late_ms']:.3f} ms behind "
                  f"the sender's clock), 0 lost, 0 dropped; "
                  f"{live['n_frames']} frames, times and poses equal to the "
                  f"bit to the scripted run; batch feed ms mean "
                  f"{st['batch_feed_ms_mean']} max "
                  f"{st['batch_feed_ms_max']:.3f}; the session ended "
                  f"{lag:.3f} s after the last packet was sent (idle "
                  f"timeout excluded); launches {got}; {smi}", flush=True)
        if drive["ins"] and "fast" in drive["modes"]:
            for mode, rate in (("fast", 1.0), ("fast", 2.0),
                               ("per_frame", 1.0)):
                _reset_launches()
                r = replay.measure_live_loopback(
                    rate=rate, fast=mode == "fast", warm=False,
                    origin=origin, device=device, pcap=paths["pcap"],
                    ins=paths["ins"], config=slam)
                part = f"loopback_interleaved_{mode}_{rate:g}x"
                got = launches[part] = _launches()
                times, pos = r.pop("times_us"), r.pop("positions")
                key = f"{name}_{mode}"
                want = int(gold[f"{key}_n_frames"])
                rmse = stream_ate(times, pos, seq)
                limit = stream_ate(gold[f"{key}_stream_times_us"],
                                   gold[f"{key}_stream_positions"],
                                   seq) + 0.02
                if not (r["lost"] == 0 and r["receiver_dropped"] == 0
                        and r["received_ins"] == r["sent_ins"]
                        and r["n_frames"] >= want - 1
                        and np.isfinite(pos).all() and rmse <= limit):
                    raise AssertionError(
                        f"live {part}: {r}; 2-D ATE {rmse} m (limit "
                        f"{limit} m, golden {want} frames)")
                _live_gate(f"live {part}", got, device)
                print(f"[live] loopback, INS interleaved at 100 Hz x "
                      f"{rate:g}, {mode}: {r}; {r['n_frames']} frames "
                      f"(golden {want}), all finite; run_online's 2-D ATE "
                      f"{rmse:.4f} m (limit {limit:.4f}, the golden "
                      f"session's + 0.02); launches {got}; {smi}",
                      flush=True)
    return launches, worst


def phase_apps(device, smi: str, name: str = "full") -> None:
    """The port's tools on bench.py's drive (or `name="small"`, a CPU
    rehearsal), as a user runs them, on `device`:
    `slam_run` (per frame, the default mode) with `--bev` and
    `--checkpoint-dir`: the BEV HTML holds the run's trajectory rows, the
    registration kernels launched; `inspect --checkpoint` fetches every
    frame of the checkpoint with 0 failures; `inspect --pcap --frame 3
    --bev --pcd --txt`: the PCD header's and the text dump's point counts
    equal the frame's mask.sum(), the BEV image written; and
    `extract_landmarks` on the checkpoint map's largest patch on the
    device against a CPU run: counts equal, plane normals within 1e-4."""
    import io
    import re
    import tempfile

    from veloslam_tpu_torch.apps import inspect as insp
    from veloslam_tpu_torch.apps import slam_run
    from veloslam_tpu_torch.config import MapConfig
    from veloslam_tpu_torch.map import landmarks as lm
    from veloslam_tpu_torch.map.voxelmap import VoxelMap
    gold = np.load(PERFRAME_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = {d["name"]: d for d in cfg["drives"]}[name]

    def run(main, argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"apps: {argv} exited {rc}")
        return out.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = write_pipeline_drive(drive, cfg["model"], tmp)
        out, ck = os.path.join(tmp, "out"), os.path.join(tmp, "ckpt")
        _reset_launches()
        t0 = time.perf_counter()
        run(slam_run.main, ["--pcap", paths["pcap"], "--ins", paths["ins"],
                            "--out-dir", out, "--bev", "--checkpoint-dir",
                            ck, "--device", device.type])
        wall = time.perf_counter() - t0
        _live_gate("apps slam_run", _launches(), device)
        traj = np.loadtxt(os.path.join(out, "trajectory.txt"), ndmin=2)
        html = open(os.path.join(out, "bev.html")).read()
        data = json.loads(re.search(r"const D = (\{.*?\});\n", html,
                                    re.S).group(1))
        rows = np.asarray([[p["x"], p["y"]] for p in data["traj"]])
        # The HTML rounds each position to 3 decimals, trajectory.txt to
        # 6: a position within 5e-7 of a half-millimetre rounds either
        # way from the file's value, so each row is held to the
        # millimetre grid within half a step (+ 5e-7) of the file's.
        if not (len(rows) == len(traj) > 0
                and np.abs(rows * 1e3 - np.round(rows * 1e3)).max() < 1e-6
                and np.abs(rows - traj[:, 1:3]).max() <= 5e-4 + 5e-7 + 1e-9
                and data["stats"]["frames"] == len(traj)):
            raise AssertionError(f"apps: the BEV HTML holds {len(rows)} "
                                 f"rows, the trajectory {len(traj)}")
        text = run(insp.main, ["--checkpoint", ck])
        m = re.search(r"(\d+) frames indexed", text)
        f = re.search(r"failures (\d+)", text)
        fetched = len(re.findall(r"^frame \d+ @", text, re.M))
        if not (m and f and int(f.group(1)) == 0
                and int(m.group(1)) == fetched == len(traj)):
            raise AssertionError(f"apps: inspect --checkpoint: {text[:400]}")
        dump = os.path.join(tmp, "f3")
        text3 = run(insp.main, ["--pcap", paths["pcap"], "--ins",
                                paths["ins"], "--frame", "3", "--bev", dump,
                                "--pcd", dump + ".pcd", "--txt",
                                dump + ".txt", "--device", device.type])
        n = int(re.search(r"^frame 3 @ \d+ us: (\d+) points", text3,
                          re.M).group(1))
        header = open(dump + ".pcd").read(400)
        bev = re.search(r"bev -> (\S+)", text3).group(1)
        n_txt = sum(1 for _ in open(dump + ".txt"))
        if not (f"\nPOINTS {n}\n" in header and n_txt == n > 0
                and os.path.getsize(bev) > 0):
            raise AssertionError(f"apps: inspect --pcap frame 3: {n} points,"
                                 f" PCD header {header!r}, {n_txt} text "
                                 "rows")
        mcfg = MapConfig()
        vmap = VoxelMap.load(os.path.join(ck, "map"), mcfg, device="cpu")
        keys = sorted(set(vmap._patches) | set(vmap._spilled))
        patch = max((vmap._materialize(k, create=False) for k in keys),
                    key=lambda p: p.n_voxels)
        a = lm.extract_landmarks(patch, mcfg.voxel_size, device=device)
        b = lm.extract_landmarks(patch, mcfg.voxel_size, device="cpu")
        counts = {k: (len(x), len(y)) for (k, x), y in zip(
            a.to_arrays().items(), b.to_arrays().values())}
        d_n = (float(np.abs(a.planes[:, :3] - b.planes[:, :3]).max())
               if len(a.planes) and len(a.planes) == len(b.planes) else 0.0)
        if any(x != y for x, y in counts.values()) or d_n > 1e-4 or not (
                np.array_equal(a.posts, b.posts)):
            raise AssertionError(f"apps: extract_landmarks on {device} vs "
                                 f"the CPU: counts {counts}, normals {d_n}")
    print(f"[apps] slam_run --bev --checkpoint-dir ({len(traj)} frames, "
          f"{wall:.2f} s with the process's first pcap and BEV writes): "
          f"the BEV HTML holds every trajectory row; inspect --checkpoint "
          f"fetched {fetched} frames, 0 failures; inspect --pcap --frame 3: "
          f"{n} points in the PCD header and the text dump, BEV "
          f"{os.path.basename(bev)}; extract_landmarks on a "
          f"{patch.n_voxels}-voxel patch on {device} equal to the CPU's "
          f"(posts {len(a.posts)}, planes {len(a.planes)}, complexes "
          f"{len(a.cplx_meta)}; normals within {d_n:.2e}); {smi}",
          flush=True)


def chain_inputs(K: int, device, seed: int = 11):
    """The chain kernel's inputs as the solver makes them: D (the 1e6
    gauge on pose 0, 1e-4 damping, the 2% floor) and B of a drifted chain
    of K poses (pcg_graph's "chain" graph, no closures), and r ~ N(0, 1)."""
    from veloslam_tpu_torch.graph import pcg
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    p = dict(PCG_GRAPHS["chain"], n=K, K=K, E=K, seed=seed,
             closure_every=None)
    f, _ = pcg_graph(p)
    g = GraphArrays(**{k: torch.as_tensor(v, device=device)
                       for k, v in f.items()})
    seg = pcg._segments(g, K)
    res, J, w = pcg._edge_terms(g)
    _, D, _ = pcg._assemble_rhs_diag(seg, res, J, w, 1e-4, 1e6)
    r = np.random.default_rng(seed).normal(size=(K, 6)).astype(np.float32)
    return (pcg._chain_floor(D), pcg._chain_terms(seg, J, w),
            torch.as_tensor(r, device=device))


def _chain_err(x, ref) -> float:
    """max |x − ref| over max |ref|."""
    return float((x.double().cpu() - ref).abs().max() / ref.abs().max())


def sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def chain_latency_ms(K: int, ops: int, clock_hz: float) -> float:
    """The least time K dependent steps of `ops` operations can take."""
    return K * ops * OP_CYCLES / clock_hz * 1e3


def phase_chain(device) -> dict:
    """The chain kernel (chain_factor, chain_solve) against its plain
    version on the card at CHAIN_SHAPES: |Δ| ≤ 1e-4·max|ref| + 1e-6 on
    Uinv, L and z (float32 6×6 inverses and products in another order,
    carried through K steps), the solve checked on the plain factors so
    each entry point is held alone; both against a float64 run of the same
    recurrence on the CPU (printed); two calls equal to the bit.  At
    CHAIN_TIMED, times by CUDA events, ns per step and the share of the
    latency bound reached (chain_latency_ms).  Returns the kernel record:
    one factor and one solve at K = 4096, the unit of a Gauss-Newton
    iteration's preconditioner (one factor, then cg_iters + 1 solves)."""
    from veloslam_tpu_torch.graph import chain
    record = {}
    clock = sm_clock_hz()
    for K in CHAIN_SHAPES:
        D, B, r = chain_inputs(K, device)
        U, L = chain.chain_factor(D, B)
        Up, Lp = chain.chain_factor_plain(D, B)
        z = chain.chain_solve(Up, Lp, B, r)
        zp = chain.chain_solve_plain(Up, Lp, B, r)
        again = (*chain.chain_factor(D, B), chain.chain_solve(Up, Lp, B, r))
        torch.cuda.synchronize()
        if not all(_same_bits(a, b) for a, b in zip((U, L, z), again)):
            raise AssertionError(f"chain at K={K}: two calls differ")
        errs = {}
        for name, x, ref in (("Uinv", U, Up), ("L", L, Lp), ("z", z, zp)):
            d = (x - ref).abs().max().item()
            lim = 1e-4 * ref.abs().max().item() + 1e-6
            if not d <= lim:
                raise AssertionError(f"chain {name} at K={K}: |d| {d} > {lim}")
            errs[name] = d
        U64, L64 = chain.chain_factor_plain(D.double().cpu(), B.double().cpu())
        z64 = chain.chain_solve_plain(U64, L64, B.double().cpu(),
                                      r.double().cpu())
        vs64 = {f"{name}_{who}": _chain_err(x, ref) for name, ref, pair in (
            ("Uinv", U64, (U, Up)), ("L", L64, (L, Lp)),
            ("z", z64, (chain.chain_solve(U, L, B, r), zp)))
            for who, x in zip(("kernel", "plain"), pair)}
        line = (f"[kernel] chain K={K}: two calls equal to the bit, within "
                f"tolerance of the plain version (|d| Uinv {errs['Uinv']:.3g}"
                f", L {errs['L']:.3g}, z {errs['z']:.3g}); relative to a "
                "float64 CPU run: "
                + " ".join(f"{k} {v:.3g}" for k, v in vs64.items()))
        if K not in CHAIN_TIMED:
            print(line, flush=True)
            continue
        runs = 20 if K <= 4096 else 5
        t = {"factor": _events_ms(lambda: chain.chain_factor(D, B), runs),
             "solve": _events_ms(lambda: chain.chain_solve(U, L, B, r), runs),
             "factor_plain": _events_ms(
                 lambda: chain.chain_factor_plain(D, B), 1 if K > 4096 else 3),
             "solve_plain": _events_ms(
                 lambda: chain.chain_solve_plain(U, L, B, r),
                 1 if K > 4096 else 3)}
        lat = {"factor": chain_latency_ms(K, CHAIN_FACTOR_OPS, clock),
               "solve": chain_latency_ms(K, CHAIN_SOLVE_OPS, clock)}
        # The pair's bytes / operations bound: the factor reads D, B and
        # writes Uinv, L (576 B a pose), the solve reads Uinv, L, B, r and
        # writes z (480 B); 864 FMAs a factor step (L, U, the Gauss-Jordan
        # inverse), 108 a solve step.
        bound_ms, bound_by = _bound(1056 * K, 2 * 972 * K)
        print(line + "; " + "; ".join(
            f"{k} {t[k]:.4f} ms per call ({t[k] * 1e6 / K:.1f} ns/step), "
            f"latency bound {lat[k]:.4f} ms ({lat[k] * 1e6 / K:.1f} ns/step:"
            f" {ops} dependent operations x {OP_CYCLES} cycles at "
            f"{clock / 1e9:.3f} GHz), {lat[k] / t[k]:.0%} of it"
            for k, ops in (("factor", CHAIN_FACTOR_OPS),
                           ("solve", CHAIN_SOLVE_OPS)))
              + f" (CUDA events, median of {runs}); plain factor "
              f"{t['factor_plain']:.2f} ms, solve {t['solve_plain']:.2f} ms; "
              f"bytes/operations bound of the pair {bound_ms * 1e3:.2f} µs "
              f"({bound_by})", flush=True)
        if K == 4096:
            record = {"max_abs_err": max(errs.values()),
                      "ms": t["factor"] + t["solve"],
                      "plain_ms": t["factor_plain"] + t["solve_plain"],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "latency_bound_ms": lat["factor"] + lat["solve"],
                      "library_ms": None}
    return record


@contextlib.contextmanager
def _watching_syncs(sites: dict):
    """Adds to `sites` {"file:line": count} of the operations run inside
    that synchronized the host with the card (torch.cuda's sync debug mode
    warns at the Python line that called each; without a card, a CPU
    rehearsal, nothing is watched).  Nests: an inner watch takes the
    operations run inside it, and the outer one watches on after it."""
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(before)
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1


class SyncCountingStages:
    """StageTimers (synchronized at each stage's end) that also count,
    per stage, the synchronizing operations (_watching_syncs; the
    stage-end synchronize is not watched) and the kernel launches."""

    def __init__(self):
        from veloslam_tpu_torch.utils.profiling import StageTimers
        self._timers = StageTimers(sync=torch.cuda.synchronize
                                   if torch.cuda.is_available() else None)
        self.sites, self.launches = {}, {}

    @property
    def syncs(self) -> dict:
        return {k: sum(v.values()) for k, v in self.sites.items()}

    def summary(self):
        return self._timers.summary()

    def innermost(self):
        return self._timers.innermost()

    @contextlib.contextmanager
    def stage(self, name: str):
        if name.startswith("sync."):
            # A sync span: its operation counts in the enclosing stage.
            with self._timers.stage(name):
                yield
            return
        with self._timers.stage(name):
            before = _launches()
            with _watching_syncs(self.sites.setdefault(name, {})):
                yield
            self.launches[name] = {
                k: self.launches.get(name, {}).get(k, 0) + v - before[k]
                for k, v in _launches().items()}


def _count_syncs(fn):
    """(fn(), {"file:line": count} of the synchronizing operations it
    ran)."""
    with _watching_syncs({}) as sites:
        out = fn()
    return out, sites


def phase_pcg(device, smi: str) -> None:
    """The PCG solvers alone on PCG_GRAPHS, at the production iterations
    and cg_iters, each solved twice, against the JAX golden
    (tests/fixtures/pcg_golden.npz): final cost within 1% of the golden's,
    positions within 1 cm RMS and 5 cm at most of it, the JAX tests' own
    gates (pose-only: cost under twice the noise floor 3·n·σ²·info, the
    error against the truth down; landmarks: cost down, the error halved),
    chain-kernel launches on every solve.  Prints per solve its time
    (CUDA events), launches per CG iteration, synchronizing operations,
    the peak device memory and the spread between the two runs.  Then the
    device finalize's proposal and solve stages on a synthetic ring at the
    keyframe ring's cap, for their syncs and peak memory."""
    from veloslam_tpu_torch.graph import chain, pcg
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    gold = np.load(PCG_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    if cfg != json.loads(json.dumps({"graphs": PCG_GRAPHS,
                                     "iterations": PCG_ITERATIONS,
                                     "cg_iters": PCG_CG_ITERS})):
        raise AssertionError("pcg: the golden's graphs are not PCG_GRAPHS")
    for name, p in PCG_GRAPHS.items():
        f, true_t = pcg_graph(p)
        n = p["n"]
        g = GraphArrays(**{k: torch.as_tensor(v, device=device)
                           for k, v in f.items()})
        kw = dict(max_poses=p["K"], iterations=PCG_ITERATIONS,
                  cg_iters=PCG_CG_ITERS)
        if "M" in p:
            solve, kw["max_landmarks"] = pcg.solve_pcg_landmarks, p["M"]
        else:
            solve = pcg.solve_pcg
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (out, stats), syncs = _count_syncs(lambda: solve(g, **kw))
            end.record()
            end.synchronize()
            runs.append(dict(
                t=out.t[:n].cpu().numpy(), stats=stats, syncs=syncs,
                ms=start.elapsed_time(end), launches=dict(chain.LAUNCHES),
                peak=torch.cuda.max_memory_allocated() - base,
                l_pos=out.l_pos[:int(f["n_landmarks"])].cpu().numpy()))
        for k, r in enumerate(runs):
            _check_pcg(name, p, r, f, true_t, gold, k)
        if "M" in p:
            _check_landmark_test_solve(g, p, f, true_t)
        run = runs[0]
        spread = float(np.abs(runs[0]["t"] - runs[1]["t"]).max())
        # Every kernel launch of one more solve, from a profiler trace.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(g, **kw)
            torch.cuda.synchronize()
        n_launch = sum(e.count for e in prof.key_averages()
                       if e.key == "cudaLaunchKernel")
        cg = PCG_ITERATIONS * PCG_CG_ITERS
        print(f"[pcg] {name} K={p['K']}: {[round(r['ms'], 1) for r in runs]} "
              f"ms per solve (CUDA events; {PCG_ITERATIONS} GN x "
              f"{PCG_CG_ITERS} CG iterations); {n_launch} kernel launches "
              f"per solve (profiler), {n_launch / cg:.1f} per CG iteration; "
              f"chain launches per solve {run['launches']}; "
              f"synchronizing operations per solve "
              f"{[sum(r['syncs'].values()) for r in runs]} (at "
              f"{[r['syncs'] for r in runs]}), peak device memory "
              f"{run['peak'] / 2**20:.0f} MiB above the graph's; positions "
              f"differ by at most "
              f"{spread:.2e} m between the two runs; {smi}", flush=True)
    _finalize_at_cap(device, smi)


def _check_pcg(name, p, run, f, true_t, gold, k) -> None:
    """One PCG solve against the JAX golden and the JAX tests' gates."""
    def g(key):
        return gold[f"{name}_{key}"]
    t, stats = run["t"], run["stats"]
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    if not abs(c1 - float(g("final_cost"))) <= 0.01 * float(g("final_cost")):
        raise AssertionError(f"pcg {name}: final cost {c1}, golden "
                             f"{float(g('final_cost'))}")
    d = np.linalg.norm(t - g("t"), axis=1)
    rms, worst = float(np.sqrt(np.mean(d ** 2))), float(d.max())
    if not (np.isfinite(t).all() and rms <= 0.01 and worst <= 0.05):
        raise AssertionError(f"pcg {name}: positions {rms} m RMS, {worst} m "
                             "max from the golden")
    before = float(np.sqrt(np.mean(np.sum(
        (f["t"][:p["n"]] - true_t) ** 2, -1))))
    after = float(np.sqrt(np.mean(np.sum((t - true_t) ** 2, -1))))
    gates = {"after < before": after < before}
    if "M" in p:
        gates["cost down"] = c1 < c0
        lm = float(np.abs(run["l_pos"] - g("l_pos")).max())
    else:
        floor = 3 * p["n"] * p["sigma"] ** 2 * p["info"]
        gates[f"cost < 2 x noise floor {floor:g}"] = c1 < 2 * floor
    if not all(gates.values()):
        raise AssertionError(f"pcg {name}: gates {gates}")
    launches = run["launches"]
    if not (launches["chain_factor"] == PCG_ITERATIONS
            and launches["chain_solve"]
            == PCG_ITERATIONS * (PCG_CG_ITERS + 1)):
        raise AssertionError(f"pcg {name}: chain launches {launches}")
    print(f"[pcg] {name} run {k}: cost {c0:.6g} -> {c1:.6g} (golden "
          f"{float(g('initial_cost')):.6g} -> {float(g('final_cost')):.6g}); "
          f"positions {rms:.2e} m RMS, {worst:.2e} m max from the JAX golden"
          + (f", landmarks {lm:.2e} m max" if "M" in p else "")
          + f"; error against the truth {before:.4f} -> {after:.4f} m "
          f"(golden {float(g('rmse_after')):.4f}); gates {sorted(gates)} "
          "held", flush=True)


def _check_landmark_test_solve(g, p, f, true_t) -> None:
    """The landmark test's gate at its own solve (LANDMARK_TEST_SOLVE):
    the error against the truth at most half its start, the cost down."""
    from veloslam_tpu_torch.graph import pcg
    it, cg = LANDMARK_TEST_SOLVE
    out, stats = pcg.solve_pcg_landmarks(g, max_poses=p["K"],
                                         max_landmarks=p["M"],
                                         iterations=it, cg_iters=cg)
    n = p["n"]
    before, after = (float(np.sqrt(np.mean(np.sum((x - true_t) ** 2, -1))))
                     for x in (f["t"][:n], out.t[:n].cpu().numpy()))
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    if not (after < 0.5 * before and c1 < c0):
        raise AssertionError(f"pcg landmarks at {it} x {cg}: error {before} "
                             f"-> {after} m, cost {c0} -> {c1}")
    print(f"[pcg] landmarks at the test's {it} GN x {cg} CG iterations: "
          f"error against the truth {before:.4f} -> {after:.4f} m (< half), "
          f"cost {c0:.6g} -> {c1:.6g}", flush=True)


def _finalize_at_cap(device, smi: str) -> None:
    """The device finalize's proposal and solve stages on a synthetic ring
    of FullSlam.MAX_KF_CAPACITY keyframes (16000 occupied: the pose-only
    PCG graph's drifted chain, random scan-context descriptors), with the
    default GraphConfig's proposal values and the full budget of 256
    candidates, each accepted with the current estimates as measurement:
    time, synchronizing operations and peak device memory of each (the
    (K, K) score, distance and top-k tensors of the proposal)."""
    from veloslam_tpu_torch.config import GraphConfig
    from veloslam_tpu_torch.runtime import devfinalize as dv
    from veloslam_tpu_torch.runtime.fullslam import FullSlam
    K = FullSlam.MAX_KF_CAPACITY
    p = dict(PCG_GRAPHS["chain"], K=K)
    f, _ = pcg_graph(p)
    gc = GraphConfig()
    rng = np.random.default_rng(5)
    desc = torch.as_tensor(rng.uniform(0, 3, (K, 16, 60)).astype(np.float32),
                           device=device)
    q, t = (torch.as_tensor(f[k], device=device) for k in ("q", "t"))
    n = torch.tensor(p["n"], dtype=torch.int32, device=device)
    times = torch.arange(K, dtype=torch.float32, device=device) * 0.2
    info = [dv.device_vector(v, device) for v in (gc.odom_edge_info,
                                                  gc.closure_edge_info)]
    lines = []
    state = {}

    def propose():
        return dv.propose_closures(
            desc, q, t, n, min_score=gc.sc_min_score,
            radius=gc.loop_closure_radius_m,
            min_gap=gc.loop_closure_min_gap, max_candidates=256)

    def solve():
        from veloslam_tpu_torch.core import se3
        cand = state["cand"]
        rel = se3.relative(se3.Pose(q[cand.i.long()], t[cand.i.long()]),
                           se3.Pose(q[cand.j.long()], t[cand.j.long()]))
        return dv.solve_and_correct(
            q, t, times, n, cand, rel.q, rel.t, cand.valid, *info,
            q, t, times, n, gn_iterations=gc.gn_iterations)

    for stage, fn in (("propose_closures", propose),
                      ("solve_and_correct", solve)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out, syncs = _count_syncs(fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        if stage == "propose_closures":
            state["cand"] = out
            extra = f", {int(out.valid.sum())} candidates"
        else:
            if not all(bool(torch.isfinite(x).all()) for x in out[:4]):
                raise AssertionError("finalize at the cap: non-finite poses")
            extra = ""
        lines.append(f"{stage} {secs:.3f} s, {sum(syncs.values())} "
                     f"synchronizing operations {syncs}, peak "
                     f"{peak / 2**30:.2f} GiB above the inputs{extra}")
    print(f"[pcg] device finalize stages at K={K} (16000 keyframes): "
          + "; ".join(lines) + f"; {smi}", flush=True)


def phase_long_drive(device, smi: str) -> dict:
    """tests/test_fullslam.py::test_unbounded_session_end_to_end on the
    card through the user entry point, once: the drive of
    tests/fixtures/long_drive_golden_seed3.npz (44 s of HDL-32 at 3600
    rpm, ~2600 keyframes in a 4096-row ring) through
    SlamPipeline(device="cuda").run_offline_batched(batch=4096,
    defer_map=True) + finalize(), every stage synchronized at its end.
    Checked against the JAX golden and the test's gates; the chain kernel
    must launch in the device finalize and in the landmark solve.

    The 2-D ATE is held under the test's 3.0 m and within LONG_DRIVE_ATE_M
    of the golden's, and finalize() (the landmark PCG solves: posts seen
    on every lap tie the drifted laps together) must lower the stream's
    ATE (after run_offline_batched, whose device finalize finds no
    closure on this drive).  Every float sum of the run is taken in a
    fixed order, so the run repeats to the bit (2638 keyframes, as the
    golden's; ATE 0.7213 m, the stream's 0.8399 m).  Returns the kernel
    launches of the run."""
    import tempfile

    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.graph import pcg
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.evaluate import ate, interpolate_positions
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    gold = np.load(LONG_DRIVE_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive = cfg["drive"]
    t0 = time.perf_counter()
    seq = sim.generate_sequence(
        duration_s=drive["duration_s"], model=cfg["model"], rpm=drive["rpm"],
        seed=drive["seed"], world=sim.World.demo(**drive["world"]),
        trajectory=sim.circle_trajectory(**drive["circle"]))
    sim_s = time.perf_counter() - t0
    def ate_2d(r):
        truth = interpolate_positions(r["times_us"], seq["ins_t_us"],
                                      seq["ins_pos"])
        return ate(r["positions"][:, :2], truth[:, :2], align=False)["rmse"]

    timers = SyncCountingStages()
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_sequence(seq, tmp, name=drive["name"])
        pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]),
                            device=device)
        pipe.timers = timers
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else (lambda: None))
        _reset_launches()
        sync()
        t1 = time.perf_counter()
        stream = pipe.run_offline_batched(paths["pcap"], paths["ins"],
                                          batch=drive["batch"],
                                          defer_map=True)
        res = pipe.finalize()
        sync()
        wall = time.perf_counter() - t1
        launches = _launches()
    n_kf = res["n_keyframes"]
    diffs = {k: res[k] - int(gold[k]) for k in ("n_frames", "n_keyframes")}
    diffs["n_closures"] = res["n_closures"] - len(gold["closures"])
    pos = res["positions"]
    stream_rmse, rmse = ate_2d(stream), ate_2d(res)
    stage_chain = {k: v["chain_factor"] + v["chain_solve"]
                   for k, v in timers.launches.items()}
    checks = {
        "n_keyframes >= 2500 and > DENSE_MAX_POSES":
            n_kf >= 2500 and n_kf > pcg.DENSE_MAX_POSES,
        "graph.n_poses == n_keyframes": pipe.graph.n_poses == n_kf,
        "ring not full": not res["ring_full"],
        "landmarks and observations": res["n_landmarks"] > 0
        and res["n_landmark_obs"] > 0,
        "finite": bool(np.isfinite(pos).all()
                       and np.isfinite(res["quaternions"]).all()
                       and np.isfinite(pipe.graph.poses()[1]).all()),
        f"ATE < 3.0 m and <= golden + {LONG_DRIVE_ATE_M} m":
            rmse < 3.0 and rmse <= float(gold["ate"]) + LONG_DRIVE_ATE_M,
        "finalize lowers the stream's ATE": rmse < stream_rmse,
        "frames equal the golden's": diffs["n_frames"] == 0,
        "keyframes and closures within 2% of the golden's":
            abs(diffs["n_keyframes"]) <= 0.02 * int(gold["n_keyframes"])
            and abs(diffs["n_closures"]) <= 0.02 * len(gold["closures"]),
        "chain kernel in the device finalize and the landmark solve":
            device.type != "cuda"
            or (stage_chain.get("device_finalize_queue", 0) > 0
                and stage_chain.get("graph_solve", 0) > 0),
    }
    stages = {k: round(v["total_s"], 3) for k, v in res["timing"].items()}
    print(f"[long_drive] {res['n_frames']} frames, {n_kf} keyframes (the "
          f"host graph grown to {pipe.graph.K} rows), {res['n_closures']} "
          f"closures, "
          f"{res['n_landmarks']} landmarks / {res['n_landmark_obs']} "
          f"observations; differences from the JAX golden {diffs}; 2-D ATE "
          f"{rmse:.4f} m (golden {float(gold['ate']):.4f}; the stream's "
          f"{stream_rmse:.4f} m before finalize()); chain launches "
          f"per stage {stage_chain}; synchronizing operations per stage "
          f"{timers.syncs}", flush=True)
    for stage in ("device_finalize_queue", "graph_solve"):
        print(f"[long_drive] {stage}'s synchronizing operations at "
              f"{timers.sites.get(stage, {})}", flush=True)
    print(f"[long_drive] simulation {sim_s:.1f} s (host, apart); pipeline "
          f"{wall:.3f} s wall, stage seconds synchronized at each stage's "
          f"end: {stages}; launches {launches}; {smi}", flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"long_drive: failed {failed}")
    return launches


# --- phase multichip: the multi-device slice over torch.distributed --------

def static_scan(world, pos, yaw: float, n_az: int = 900,
                n_vert: int = 32) -> np.ndarray:
    """A full revolution raycast from a static pose (the JAX tests'
    tests/test_registration.py::_static_scan with the port's simulator):
    sensor-frame points (P, 3) float32."""
    from veloslam_tpu_torch.io import simulate as sim
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    vert = np.deg2rad(np.linspace(-30.67, 10.67, n_vert))
    azg, vg = np.meshgrid(az, vert, indexing="ij")
    dirs_s = np.stack([np.cos(vg) * np.sin(azg), np.cos(vg) * np.cos(azg),
                       np.sin(vg)], -1).reshape(-1, 3)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    dirs_w = dirs_s @ R.T
    dist, _ = sim.raycast(world, np.broadcast_to(pos, dirs_w.shape).copy(),
                          dirs_w, max_range=120.0)
    return (dirs_s * dist[:, None])[dist > 0].astype(np.float32)


def multichip_inputs(size: dict) -> dict:
    """The multichip phase's inputs, numpy, from seeds: a registration
    target of `rows` voxel rows (four static scans of World.demo(5) in
    the first scan's frame), a scan of `points` points taken 0.34 m and
    1.5° away (`t_gt`), bench.py's bulk packets, and a pcg_graph of
    MULTICHIP_SIZES' kind (closures and landmark observations)."""
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.registration import gicp
    world = sim.World.demo(seed=5, n_posts=30, n_walls=10)
    base = np.array([0.0, 0.0, 2.0])
    parts = []
    for dx, dy, yaw in ((0.0, 0.0, 0.0), (6.0, 0.0, 0.4), (0.0, 6.0, 1.2),
                        (-6.0, -4.0, 2.4)):
        p = static_scan(world, base + [dx, dy, 0.0], yaw)
        c, s = np.cos(yaw), np.sin(yaw)
        parts.append(p @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
                     + [dx, dy, 0.0])
    tgt = np.concatenate(parts).astype(np.float32)
    t_gt = np.array([0.15, 0.3, 0.02], np.float32)
    src = static_scan(world, base + t_gt, np.deg2rad(1.5))
    P = size["points"]
    src = src[::max(1, len(src) // P)][:P]
    pts = np.zeros((P, 3), np.float32)
    pts[:len(src)] = src
    mask = np.arange(P) < len(src)
    one = gicp.build_plane_grid(
        torch.as_tensor(tgt)[None], torch.ones(1, len(tgt), dtype=torch.bool),
        torch.zeros(3), size["voxel"], capacity=size["rows"])
    target = {"keys": one.grid.keys[0].numpy(),
              "count": one.grid.count[0].numpy(),
              "mean": one.grid.mean[0].numpy(),
              "cov": one.grid.cov[0].numpy(),
              "origin": one.grid.origin[0].numpy(),
              "voxel_size": one.grid.voxel_size[0].numpy(),
              "normal": one.normal[0].numpy(), "usable": one.usable[0].numpy()}
    graph, _ = pcg_graph(size["graph"])
    return {"target": target, "pts": pts, "mask": mask, "t_gt": t_gt,
            "packets": _bulk_inputs(torch.device("cpu"),
                                    size["packets"])[0].numpy(),
            "graph": graph, "K": size["graph"]["K"], "M": size["graph"]["M"],
            "n_poses": size["graph"]["n"]}


def _jax_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "veloslam_tpu"))


def _np_out(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def multichip_rank(device, inp: dict) -> dict:
    """One rank of phase multichip's sharded calls (all ranks on "map";
    decode on "data"): register_sharded (a DenseIndex per shard, the
    production 16 iterations re-associated every 8), register_halo_sharded
    (the scan routed by key range, the same schedule),
    decode_packets_sharded and solve_graph_sharded with and without
    landmarks.  A warm pass records the registration kernels' inputs, and
    rank 0 holds each kernel against its plain version on them
    (check_captured); then the kernel counts are zeroed, the calls run
    once more, and the counts are read.  World 1 (rank 0) also runs the
    port's single-process functions on the same card.  Returns numpy."""
    from veloslam_tpu_torch.config import MeshConfig
    from veloslam_tpu_torch.core import se3
    from veloslam_tpu_torch.decode import calibration as calib_mod
    from veloslam_tpu_torch.decode.decode import DeviceCalib, decode_packets
    from veloslam_tpu_torch.graph import optimize
    from veloslam_tpu_torch.graph.posegraph import GraphArrays
    from veloslam_tpu_torch.parallel import dist, halo, sharded
    from veloslam_tpu_torch.parallel.mesh import block, make_mesh
    from veloslam_tpu_torch.registration import gicp
    from veloslam_tpu_torch.registration import voxel as vx

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    n, rank = dist.process_count(), dist.process_index()
    mesh = dist.global_mesh(device, data_axis=1)
    dmesh = make_mesh(MeshConfig(data_axis=n, map_axis=1), device)
    tl = {k: torch.as_tensor(np.array(v), device=device)
          for k, v in inp["target"].items()}
    full = gicp.make_plane_grid(vx.VoxelGrid(
        keys=tl["keys"], count=tl["count"], mean=tl["mean"], cov=tl["cov"],
        origin=tl["origin"], voxel_size=tl["voxel_size"]), tl["normal"],
        tl["usable"])
    rows, origin, vs = dist.partition_plane_grid_rows(full, rank, n)
    shard = dist.assemble_global_plane_grid(mesh, rows, origin, vs)
    dense = sharded.build_dense_sharded(mesh, shard)
    pts = torch.as_tensor(inp["pts"], device=device)
    mask = torch.as_tensor(inp["mask"], device=device)
    prior = se3.Pose.identity(device=device)
    keys = inp["target"]["keys"]
    h = 2 * halo.required_halo(keys, n) + 16 if n > 1 else 16
    p_r, m_r = halo.partition_points_by_key_ranges(
        keys, inp["pts"], inp["mask"], inp["target"]["origin"],
        float(inp["target"]["voxel_size"]), n)
    hp = block(torch.as_tensor(p_r, device=device), mesh, "map").clone()
    hm = block(torch.as_tensor(m_r, device=device), mesh, "map").clone()
    hshard = sharded.shard_plane_grid(mesh, full)
    pkts = torch.as_tensor(inp["packets"], device=device)
    calib = DeviceCalib.from_host(calib_mod.hdl32(), device=device)
    g = GraphArrays(**{k: torch.as_tensor(np.array(v), device=device)
                       for k, v in inp["graph"].items()})
    K, M = inp["K"], inp["M"]
    kw = dict(iterations=MULTICHIP_ITERATIONS,
              reassociate_every=MULTICHIP_REASSOCIATE)

    def register():
        return sharded.register_sharded(mesh, pts, mask, shard, prior,
                                        dense=dense, **kw)

    def register_halo():
        return halo.register_halo_sharded(mesh, hp, hm, hshard, prior,
                                          halo=h, **kw)

    def solve(lm: bool):
        return sharded.solve_graph_sharded(
            mesh, g, max_poses=K, max_landmarks=M,
            iterations=MULTICHIP_GN, with_landmarks=lm)

    def decode():
        return sharded.decode_packets_sharded(dmesh, pkts, calib,
                                              model="hdl32")

    timer = _events_ms if cuda else _host_ms
    ms = {}

    def timed(name, fn):
        """fn() once, its ms (one call) kept under `name`."""
        got = []
        ms[name] = timer(lambda: got.append(fn()), 1)
        return got[0]

    def sharded_path() -> dict:
        reg = timed("register_once", register)
        reg_h = timed("halo_once", register_halo)
        xyz = timed("decode_once", decode)
        g1, c1 = timed("graph_landmarks", lambda: solve(True))
        g0, c0 = timed("graph", lambda: solve(False))
        return {"register": {"q": reg.pose.q, "t": reg.pose.t,
                             "n_matched": reg.n_matched},
                "halo": {"q": reg_h.pose.q, "t": reg_h.pose.t,
                         "n_matched": reg_h.n_matched},
                "decode": xyz,
                "graph_landmarks": {"q": g1.q, "t": g1.t, "l_pos": g1.l_pos,
                                    "cost": c1},
                "graph": {"q": g0.q, "t": g0.t, "cost": c0}}

    # The warm pass: the kernels' first calls, their inputs recorded;
    # decode and one GN iteration of the graph solve (no kernel of the
    # port) for the card's libraries.
    with capturing_kernel_inputs({}) as seen:
        register(), register_halo(), decode()
    sharded.solve_graph_sharded(mesh, g, max_poses=K, max_landmarks=M,
                                iterations=1, with_landmarks=True)
    errs = (check_captured(seen, "", where=f"multichip world {n}")
            if cuda and rank == 0 else None)
    del seen
    sync()
    _reset_launches()
    before = dict(dist.COLLECTIVES)
    out = sharded_path()
    sync()
    launches = _launches()
    collectives = {k: dist.COLLECTIVES[k] - before[k] for k in before}
    out = {k: ({kk: _np_out(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else _np_out(v))
           for k, v in out.items()}
    per_reg = {}
    for name, fn in (("register", register), ("halo", register_halo)):
        b = dict(dist.COLLECTIVES)
        fn()
        per_reg[name] = {k: dist.COLLECTIVES[k] - b[k] for k in b}
    ms.update(register=timer(register, 3, 5),
              halo=timer(register_halo, 3, 5), decode=timer(decode, 3, 5))
    ref = None
    if n == 1:
        one = gicp.register(pts, mask, full, prior,
                            vx.build_dense_index(full.grid), **kw)
        one_h = gicp.register(pts, mask, full, prior, None, **kw)
        g1, _ = optimize.solve_with_landmarks(
            g, max_poses=K, max_landmarks=M, iterations=MULTICHIP_GN)
        g0, _ = optimize.solve(g, max_poses=K, iterations=MULTICHIP_GN)
        ref = {"register": {"q": _np_out(one.pose.q),
                            "t": _np_out(one.pose.t),
                            "n_matched": _np_out(one.n_matched)},
               "halo": {"q": _np_out(one_h.pose.q),
                        "t": _np_out(one_h.pose.t),
                        "n_matched": _np_out(one_h.n_matched)},
               "decode": _np_out(decode_packets(pkts, calib,
                                                model="hdl32").xyz),
               "graph_landmarks": {"q": _np_out(g1.q), "t": _np_out(g1.t),
                                   "l_pos": _np_out(g1.l_pos)},
               "graph": {"q": _np_out(g0.q), "t": _np_out(g0.t)}}
    if _jax_modules():
        raise AssertionError(f"rank {rank} loaded {_jax_modules()}")
    return {"rank": rank, "out": out, "ref": ref, "launches": launches,
            "collectives": collectives, "per_registration": per_reg,
            "ms": ms, "errs": errs, "halo_rows": h,
            "jax_modules": _jax_modules()}


def _host_ms(fn, runs: int, inner: int = 1) -> float:
    """The CPU rehearsal's stand-in for _events_ms: host ms per call."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) / inner * 1e3)
    return float(np.median(times))


def multichip_session_rank(device, slam: dict, paths: dict) -> dict:
    """One rank of the distributed session on a pcap + INS log: a warm
    run (run_offline + finalize()) whose registration-kernel inputs are
    recorded (rank 0 holds each kernel against its plain version on
    them) and whose stages are synchronized and their synchronizing
    operations counted; then the measured run, kernel counts zeroed just
    before and read just after, the collectives counted.  Returns the
    measured run's results (numpy), the warm run's equal to the bit."""
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.parallel import dist
    from veloslam_tpu_torch.parallel.session import DistributedSlamSession

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device.type == "cuda"
    cfg = SlamConfig.from_dict(slam)

    def run(timers=None):
        sess = DistributedSlamSession(cfg, device=device)
        if timers is not None:
            sess.timers = timers
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stream = sess.run_offline(paths["pcap"], paths["ins"])
        final = sess.finalize()
        if cuda:
            torch.cuda.synchronize(device)
        return sess, stream, final, time.perf_counter() - t0

    timers = SyncCountingStages()
    with capturing_kernel_inputs({}) as seen:
        wsess, wstream, wfinal, _ = run(timers)
    errs = (check_captured(seen, "", where="multichip session")
            if cuda and dist.process_index() == 0 else None)
    del seen
    _reset_launches()
    before = dict(dist.COLLECTIVES)
    sess, stream, final, wall = run()
    launches = _launches()
    collectives = {k: dist.COLLECTIVES[k] - before[k] for k in before}
    for k in ("positions", "quaternions"):
        if not np.array_equal(final[k], wfinal[k]):
            raise AssertionError(f"multichip session rank "
                                 f"{dist.process_index()}: the warm and "
                                 f"measured runs' {k} differ")
    if _jax_modules():
        raise AssertionError(f"rank {dist.process_index()} loaded "
                             f"{_jax_modules()}")
    n = final["n_frames"]
    sites = {}
    for per_stage in timers.sites.values():
        for site, c in per_stage.items():
            sites[site] = sites.get(site, 0) + c
    return {
        "rank": sess.pid, "n_frames": n, "wall_s": wall,
        "times_us": final["times_us"],
        "stream_positions": stream["positions"],
        "positions": final["positions"],
        "quaternions": final["quaternions"],
        "registered": np.asarray([f.registered for f in sess.trajectory]),
        "n_keyframes": final["n_keyframes"],
        "keyframe_times_us": final["keyframe_times_us"],
        "closures": sorted(sess.closures),
        "n_landmarks": final["n_landmarks"],
        "tiles": sorted(sess.owned_tiles()),
        "launches": launches, "collectives": collectives,
        "syncs": sum(sites.values()), "sync_sites": sites,
        "stages": {k: round(v["total_s"], 4)
                   for k, v in wfinal["timing"].items()},
        "errs": errs, "jax_modules": _jax_modules()}


def _spawn(fn, nprocs: int, backend: str, device, *args) -> list:
    """dist.spawn_ranks with the repository on the ranks' PYTHONPATH."""
    from veloslam_tpu_torch.parallel import dist
    return dist.spawn_ranks(fn, nprocs, backend=backend, device=str(device),
                            args=args, timeout_s=MULTICHIP_TIMEOUT_S,
                            env={"PYTHONPATH": REPO})


def _max_diff(a: dict, b: dict, keys) -> dict:
    return {k: float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max())
            for k in keys}


def _check_replicas(where: str, ranks: list) -> None:
    """Every replicated output equal to the bit on every rank."""
    for r in ranks[1:]:
        for k, v in ranks[0]["out"].items():
            if k == "decode":
                same = np.array_equal(r["out"][k], v)
            else:
                same = all(np.array_equal(r["out"][k][kk], vv)
                           for kk, vv in v.items())
            if not same:
                raise AssertionError(f"{where}: rank {r['rank']}'s {k} "
                                     f"differs from rank 0's")


def phase_multichip(device, smi: str, name: str = "full") -> tuple:
    """The multi-device slice (veloslam_tpu_torch/parallel/, the port of
    __graft_entry__.py::dryrun_multichip), every rank a process spawned
    with the "spawn" start method and the repository on PYTHONPATH, each
    asserting it loaded nothing of JAX:

      * world 1 on NCCL (on the CPU, a rehearsal: gloo): multichip_rank's
        calls held to the port's single-process functions on the same
        device — decode equal to the bit, register_sharded within
        MULTICHIP_REG_ONE of gicp.register with the DenseIndex and
        n_matched equal, register_halo_sharded within MULTICHIP_HALO_ONE
        of gicp.register with the binary search (its step adds the
        damping as one term, as the JAX halo does), the graph solves
        within MULTICHIP_GRAPH_ONE of optimize's;
      * worlds MULTICHIP_WORLDS on Gloo, every rank on one card: the same
        calls, the replicas equal to the bit, each within the stated
        tolerances of world 1 (MULTICHIP_REG_WORLD for the registrations:
        the shards' dense boxes are centred on each shard's own voxels;
        MULTICHIP_GRAPH_WORLD for the solves: the all_reduce sums the
        partial normal equations in another order), decode equal to the
        bit; ms per call and collectives per registration (2: one
        all_gather per association block);
      * DistributedSlamSession on 2 Gloo ranks: bench.py's drive per
        frame + finalize() (MULTICHIP_GOLDEN's "full"; "small" on the
        CPU) against the JAX session's golden: the ranks equal to the
        bit, frames, times, keyframes, closures and landmark count equal,
        owned tiles disjoint and each rank's equal to the JAX rank's,
        their union the port's single-process map's tiles; positions
        (stream and final) within per_frame's gates of the JAX ranks';
        the stream within max(5 cm, the JAX session's own distance from
        its single-process oracle + 2 cm) of the port's single-process
        run_offline; frames/s, syncs and collectives per frame;
      * scaling_bench at --nprocs 1 (NCCL) and 2 (gloo), its JSON lines.

    The registration kernels must launch on the sharded path in every
    world and in the session, the chain kernel not.  Returns (kernel
    launches per part, check_captured's largest |Δ| per kernel)."""
    import tempfile

    from veloslam_tpu_torch.apps import scaling_bench
    size = MULTICHIP_SIZES[name]
    cuda = device.type == "cuda"
    card = "cuda" if cuda else "cpu"
    t0 = time.perf_counter()
    inp = multichip_inputs(size)
    print(f"[multichip] inputs: a {len(inp['pts'])}-point scan, a "
          f"{len(inp['target']['keys'])}-row target "
          f"({int((inp['target']['keys'] != 2**31 - 1).sum())} occupied, "
          f"{size['voxel']} m), {len(inp['packets'])} packets, a "
          f"{inp['n_poses']}-keyframe graph (K={inp['K']}, M={inp['M']}) "
          f"({time.perf_counter() - t0:.1f} s, host)", flush=True)
    launches, errs, worlds = {}, dict.fromkeys(REG_KERNELS, 0.0), {}
    for S in (1,) + MULTICHIP_WORLDS:
        backend = "nccl" if S == 1 and cuda else "gloo"
        t1 = time.perf_counter()
        ranks = _spawn(multichip_rank, S, backend, card, inp)
        secs = time.perf_counter() - t1
        _check_replicas(f"multichip world {S}", ranks)
        for r in ranks:
            if r["jax_modules"]:
                raise AssertionError(f"multichip world {S} rank {r['rank']}"
                                     f" loaded {r['jax_modules']}")
        r0 = ranks[0]
        worlds[S] = r0
        launches[f"world{S}"] = r0["launches"]
        if r0["errs"]:
            errs = {k: max(errs[k], v) for k, v in r0["errs"].items()}
        if S == 1:
            ref = r0["ref"]
            diffs = {
                "register": _max_diff(r0["out"]["register"],
                                      ref["register"], ("q", "t")),
                "halo": _max_diff(r0["out"]["halo"], ref["halo"],
                                  ("q", "t")),
                "graph_landmarks": _max_diff(r0["out"]["graph_landmarks"],
                                             ref["graph_landmarks"],
                                             ("q", "t", "l_pos")),
                "graph": _max_diff(r0["out"]["graph"], ref["graph"],
                                   ("q", "t"))}
            fails = []
            if not np.array_equal(r0["out"]["decode"], ref["decode"]):
                fails.append("decode differs from decode_packets")
            for k, lim in (("register", MULTICHIP_REG_ONE),
                           ("halo", MULTICHIP_HALO_ONE),
                           ("graph_landmarks", MULTICHIP_GRAPH_ONE),
                           ("graph", MULTICHIP_GRAPH_ONE)):
                if max(diffs[k].values()) > lim:
                    fails.append(f"{k} {diffs[k]} > {lim}")
            for k in ("register", "halo"):
                if int(r0["out"][k]["n_matched"]) != int(
                        ref[k]["n_matched"]):
                    fails.append(f"{k} n_matched {r0['out'][k]['n_matched']}"
                                 f", single-process {ref[k]['n_matched']}")
            off = np.abs(r0["out"]["register"]["t"] - inp["t_gt"]).max()
            if off > 0.05:
                fails.append(f"register {off} m from the true offset")
            if fails:
                raise AssertionError(f"multichip world 1: {fails}")
            print(f"[multichip] world 1 ({backend}): held to the port's "
                  f"single-process functions on the same device: decode "
                  f"equal to the bit, max |Δ| {diffs}; n_matched "
                  f"{int(r0['out']['register']['n_matched'])} / halo "
                  f"{int(r0['out']['halo']['n_matched'])} equal; "
                  f"registration {off:.4f} m from the true offset", flush=True)
        else:
            w1 = worlds[1]["out"]
            diffs = {k: _max_diff(r0["out"][k], w1[k],
                                  [kk for kk in w1[k] if kk != "n_matched"])
                     for k in ("register", "halo", "graph_landmarks",
                               "graph")}
            fails = [f"{k} {diffs[k]} > {MULTICHIP_REG_WORLD}"
                     for k in ("register", "halo")
                     if max(diffs[k].values()) > MULTICHIP_REG_WORLD]
            lim = MULTICHIP_GRAPH_WORLD
            for k in ("graph_landmarks", "graph"):
                d = r0["out"][k]["t"] - w1[k]["t"]
                diffs[k]["t_rms"] = float(np.sqrt(np.mean(np.sum(
                    d.astype(np.float64) ** 2, axis=1))))
                if not (diffs[k]["t_rms"] <= lim["rms_m"]
                        and diffs[k]["t"] <= lim["max_m"]
                        and diffs[k]["q"] <= lim["q"]):
                    fails.append(f"{k} {diffs[k]} beyond {lim}")
            if not np.array_equal(r0["out"]["decode"], w1["decode"]):
                fails.append("decode differs from world 1")
            if r0["per_registration"]["register"] != {
                    "all_reduce": 0, "all_gather": 2, "ring": 0}:
                fails.append(f"collectives per registration "
                             f"{r0['per_registration']['register']}")
            if fails:
                raise AssertionError(f"multichip world {S}: {fails}")
            print(f"[multichip] world {S} (gloo, {S} ranks on one "
                  f"{'card' if cuda else 'CPU'}): replicas equal to the "
                  f"bit; max |Δ| from world 1 {diffs}; n_matched "
                  f"{int(r0['out']['register']['n_matched'])} (world 1 "
                  f"{int(w1['register']['n_matched'])}), halo "
                  f"{int(r0['out']['halo']['n_matched'])} "
                  f"({int(w1['halo']['n_matched'])}); decode equal to the "
                  f"bit", flush=True)
        if cuda and not (all(r0["launches"][k] for k in REG_KERNELS)
                         and r0["launches"]["chain_factor"]
                         == r0["launches"]["chain_solve"] == 0):
            raise AssertionError(f"multichip world {S}: launches "
                                 f"{r0['launches']}")
        print(f"[multichip] world {S}: ms per call (rank 0, "
              f"{'CUDA events' if cuda else 'host clock'}) "
              f"{ {k: round(v, 3) for k, v in r0['ms'].items()} }; "
              f"collectives per registration {r0['per_registration']}; "
              f"collectives in the sharded calls {r0['collectives']}; halo "
              f"{r0['halo_rows']} rows a side; kernel launches "
              f"{r0['launches']}; {len(ranks)} rank(s) in {secs:.1f} s "
              f"(spawn included); {smi}", flush=True)

    # The distributed session against the JAX session's golden.
    gold = np.load(MULTICHIP_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    session = "full" if name == "full" else "small"
    drive = {d["name"]: d for d in cfg["drives"]}[session]
    with tempfile.TemporaryDirectory() as tmp:
        paths, seq = write_multihost_drive(drive, cfg["model"], tmp)
        t1 = time.perf_counter()
        ranks = _spawn(multichip_session_rank, cfg["n_procs"], "gloo", card,
                       drive["slam"], paths)
        secs = time.perf_counter() - t1
        single, tiles = run_single_offline(paths, drive, device)
    summary = check_multihost_session(ranks, single, tiles, gold, session)
    r0 = ranks[0]
    if r0["errs"]:
        errs = {k: max(errs[k], v) for k, v in r0["errs"].items()}
    launches["session"] = r0["launches"]
    if cuda and not (all(r0["launches"][k] for k in REG_KERNELS)
                     and r0["launches"]["chain_factor"]
                     == r0["launches"]["chain_solve"] == 0):
        raise AssertionError(f"multichip session: launches "
                             f"{r0['launches']}")
    n = r0["n_frames"]
    top = sorted(r0["sync_sites"].items(), key=lambda kv: -kv[1])[:6]
    print(f"[multichip] session ({cfg['n_procs']} gloo ranks on one "
          f"{'card' if cuda else 'CPU'}, the {session} drive): {summary}; "
          f"{n} frames in {r0['wall_s']:.3f} s: {n / r0['wall_s']:.2f} "
          f"frames/s (run_offline + finalize, pcap read included; the "
          f"ranks share the card); collectives per frame "
          f"{ {k: round(v / n, 3) for k, v in r0['collectives'].items()} }"
          f"; synchronizing operations {r0['syncs'] / n:.1f} per frame "
          f"(warm run, top sites {top}); warm run's stage seconds "
          f"synchronized {r0['stages']}; kernel launches {r0['launches']}; "
          f"{cfg['n_procs']} ranks in {secs:.1f} s (spawn, warm and "
          f"measured runs); {smi}", flush=True)

    for nprocs, backend in ((1, "nccl" if cuda else "gloo"), (2, "gloo")):
        rec = scaling_bench.run(nprocs, backend=backend, device=card,
                                timeout_s=MULTICHIP_TIMEOUT_S,
                                **MULTICHIP_BENCH[name])
        print(f"[multichip] scaling_bench --nprocs {nprocs} --backend "
              f"{backend}: {json.dumps(rec)}", flush=True)
    print(f"[multichip] phase {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    return launches, errs


def write_multihost_drive(drive: dict, model: str, out_dir: str):
    """A multihost golden drive as its generator writes it: drifted as
    write_pipeline_drive writes it, or with no drift the simulator's own
    pcap + INS log."""
    if drive["drift_rate"]:
        return write_pipeline_drive(drive, model, out_dir)
    from veloslam_tpu_torch.io import simulate as sim
    seq = simulate_drive(drive, model)
    return sim.write_sequence(seq, out_dir, name=drive["name"]), seq


def run_single_offline(paths: dict, drive: dict, device) -> tuple:
    """The port's single-process oracle of the session check: run_offline
    on one device (no finalize, as the JAX test's oracle); (positions,
    the map's tiles)."""
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]), device=device)
    res = pipe.run_offline(paths["pcap"], paths["ins"])
    tiles = sorted(set(pipe.map._patches) | set(pipe.map._spilled))
    return res["positions"], [tuple(map(int, t)) for t in tiles]


def check_multihost_session(ranks: list, single: np.ndarray, tiles: list,
                            gold, name: str) -> str:
    """The port's distributed session (session ranks' results) against
    the JAX session golden (multihost_golden_seed3.npz) and the port's
    single-process run_offline: see phase_multichip.  Raises on a
    failure; returns a summary."""
    def g(r, k):
        return gold[f"{name}_p{r}_{k}"]

    fails = []
    r0 = ranks[0]
    for r in ranks[1:]:
        for k in ("times_us", "stream_positions", "positions",
                  "quaternions", "registered"):
            if not np.array_equal(r[k], r0[k]):
                fails.append(f"rank {r['rank']}'s {k} differ from rank 0's")
        if r["jax_modules"]:
            fails.append(f"rank {r['rank']} loaded {r['jax_modules']}")
    if not np.array_equal(r0["times_us"], g(0, "times_us")):
        fails.append("frame times differ from the golden's")
    if not np.array_equal(r0["registered"], g(0, "registered")):
        fails.append("registered flags differ from the golden's")
    if (r0["n_keyframes"] != int(g(0, "n_keyframes"))
            or not np.array_equal(r0["keyframe_times_us"],
                                  g(0, "keyframe_times_us"))):
        fails.append(f"{r0['n_keyframes']} keyframes, golden "
                     f"{int(g(0, 'n_keyframes'))}")
    want = sorted(map(tuple, g(0, "closures").tolist()))
    if sorted(map(tuple, r0["closures"])) != want:
        fails.append(f"closures {r0['closures']}, golden {want}")
    if r0["n_landmarks"] != int(g(0, "n_landmarks")):
        fails.append(f"{r0['n_landmarks']} landmarks, golden "
                     f"{int(g(0, 'n_landmarks'))}")
    sets = [set(map(tuple, r["tiles"])) for r in ranks]
    for r, s in zip(ranks, sets):
        if s != set(map(tuple, g(r["rank"], "tiles").tolist())):
            fails.append(f"rank {r['rank']}'s tiles {sorted(s)}, the JAX "
                         f"rank's {g(r['rank'], 'tiles').tolist()}")
    if sum(map(len, sets)) != len(set().union(*sets)):
        fails.append("owned tiles overlap")
    if set().union(*sets) != set(tiles):
        fails.append(f"tiles {sorted(set().union(*sets))}, the "
                     f"single-process map's {tiles}")
    offs = {}
    for k in ("stream_positions", "positions"):
        d = r0[k] - g(0, k)
        offs[k] = (float(np.linalg.norm(d[:, :2], axis=1).max()),
                   float(np.abs(d[:, 2]).max()))
        if not (offs[k][0] <= 0.05 and offs[k][1] <= Z_LIMIT_M):
            fails.append(f"{k} {offs[k]} m from the golden (x, y limit "
                         f"0.05, z {Z_LIMIT_M})")
    jax_own = float(np.linalg.norm(g(0, "stream_positions")
                                   - gold[f"{name}_oracle_stream_positions"],
                                   axis=1).max())
    limit = max(0.05, jax_own + 0.02)
    own = float(np.linalg.norm(r0["stream_positions"] - single,
                               axis=1).max())
    if not own <= limit:
        fails.append(f"stream {own} m from the port's single-process "
                     f"run_offline (limit {limit})")
    if fails:
        raise AssertionError(f"multichip session {name}: {fails}")
    return (f"ranks equal to the bit; {len(r0['times_us'])} frames "
            f"({int(r0['registered'].sum())} registered), "
            f"{r0['n_keyframes']} keyframes, {len(r0['closures'])} closures"
            f", {r0['n_landmarks']} landmarks, each equal to the JAX "
            f"session's; tiles {[len(s) for s in sets]} disjoint, each "
            f"rank's the JAX rank's, their union the single-process map's "
            f"{len(tiles)}; max from the JAX ranks (x, y / z): stream "
            f"{offs['stream_positions'][0]:.2e} / "
            f"{offs['stream_positions'][1]:.2e} m, final "
            f"{offs['positions'][0]:.2e} / {offs['positions'][1]:.2e} m; "
            f"stream {own:.4f} m from the port's single-process run_offline"
            f" (the JAX session {jax_own:.4f} m from its own; limit "
            f"{limit:.4f})")


def models_drives(name: str = "full") -> tuple:
    """models_golden_seed3.npz: (the golden, its config, {model: that
    model's drive of size `name`})."""
    gold = np.load(MODELS_GOLDEN)
    cfg = json.loads(str(gold["config"]))
    return gold, cfg, {d["model"]: d for d in cfg["drives"]
                       if d["name"] == f"{d['model']}_{name}"}


def _time_ms(device, fn, runs: int) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    return (_events_ms(fn, runs) if device.type == "cuda"
            else _host_ms(fn, runs))


def _bulk_kernel_lines(seen: dict, smi: str, where: str) -> None:
    """Each registration kernel on a bulk step's own inputs: device µs
    (torch.profiler) beside its bound, the GN step at _ne_bound, the
    gathers by _time_gather (with their plain version and index_select)."""
    from veloslam_tpu_torch.registration import normal_equations as ne
    for (name, _, _), (args, kw) in seen.items():
        if name == "gn_iteration":
            pts, pose, mu, n, hit = args
            F, P = pts.shape[:2]
            bound_ms, bound_by = _ne_bound(F, P, int(hit.sum()))
            dev = _device_us(lambda: ne.gn_iteration(*args, **kw))
            print(f"[models] {where} GN step F={F} P={P}, "
                  f"{float(hit.float().mean()):.0%} hits: device "
                  f"{dev:.2f} µs per call (profiler); bound "
                  f"{bound_ms * 1e3:.2f} µs ({bound_by}), "
                  f"{_share(bound_ms, dev)}; {smi}", flush=True)
        elif name in ("gather_i32", "gather_rows8"):
            table, idx = args
            line = _time_gather(name, table, idx)["line"]
            print(f"[models] {where} {name} table {tuple(table.shape)} M "
                  f"{idx.numel()}: {line}; {smi}", flush=True)


def _models_bulk(device, smi: str, model: str, calib, reg: dict) -> tuple:
    """One model's bulk step at bench.py's width (MODELS_BULK_PACKETS
    packets of that sensor, slots_for_batch slots, the production
    registration config `reg`, a warm map): the frame-slot count the
    kernels see equal to slots_for_batch, one step's launches exact, the
    kernels held against their plain versions on that step's inputs and
    their device µs beside the bound, then MODELS_BULK_STEPS timed steps.
    Returns (one step's launches, check_captured's largest |Δ|)."""
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.runtime import odometry as odo
    packets = MODELS_BULK_PACKETS
    slots = odo.slots_for_batch(model, packets)
    pkts, rel_s, track_rel, track_q, track_t, track_v = _bulk_inputs(
        device, packets, model=model, calib=calib)
    dcal = DeviceCalib.from_host(calib, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    kw = dict(model=model, n_beams=calib.n_lasers,
              reg_points=reg["reg_points"],
              reg_iterations=reg["reg_iterations"], max_frames_batch=slots,
              reassociate_every=reg["reassociate_every"],
              map_decay=reg["map_decay"], use_dense=True,
              sample_assembly=True)

    def step(state):
        return odo.odometry_step_batched(
            state, pkts, dcal, rel_s, zero, zero, track_rel, track_q,
            track_t, track_v, **kw)[0]

    fresh = odo.init_state(calib.n_lasers, device=device,
                           map_capacity=reg["map_capacity"],
                           voxel_size=reg["voxel_size"],
                           sample_assembly=True)
    warm = step(fresh)                          # fills the map
    _reset_launches()
    with capturing_kernel_inputs({}, latest=True) as seen:
        after = step(warm)
    launches = _launches()
    blocks = -(-reg["reg_iterations"] // reg["reassociate_every"])
    _check_launches(f"models bulk {model}", launches, {
        "fused_normal_equations": reg["reg_iterations"],
        "gather_i32": blocks, "gather_rows8": blocks}, device)
    shapes = {key[1][0][:2] for key in seen if key[0] == "gn_iteration"}
    if shapes != {(slots, reg["reg_points"])}:
        raise AssertionError(f"models bulk {model}: the GN step saw "
                             f"{shapes}, want ({slots}, "
                             f"{reg['reg_points']}) slots x points")
    n_done = int(after.n_frames) - int(warm.n_frames)
    if not (0 < n_done <= slots and torch.isfinite(after.traj_t).all()
            and torch.isfinite(after.map_grid.mean).all()):
        raise AssertionError(f"models bulk {model}: {n_done} frames done "
                             f"of {slots} slots, or a non-finite result")
    errs = dict.fromkeys(REG_KERNELS)            # not compared on the CPU
    if device.type == "cuda":
        errs = check_captured(seen, smi, f"models bulk {model}",
                              want=("gn_iteration", "gather_i32",
                                    "gather_rows8"))
        _bulk_kernel_lines(seen, smi, f"bulk {model}")
    del seen
    ms = _time_ms(device, lambda: step(warm), MODELS_BULK_STEPS)
    print(f"[models] bulk {model}: {packets} packets "
          f"({packets / odo.packets_per_second(model):.3f} s of the sensor), "
          f"{slots} frame slots = slots_for_batch, {n_done} frames a "
          f"batch: {ms:.3f} ms a batch, {n_done / (ms * 1e-3):.1f} "
          f"frames/s (median of {MODELS_BULK_STEPS} steps from a warm "
          f"map); launches a batch {launches}; {smi}", flush=True)
    return launches, errs


def _worst(worst: dict, errs: dict) -> None:
    for k, v in errs.items():
        if v is not None:
            worst[k] = max(worst[k] or 0.0, v)


def _models_fullslam(device, smi, gold, drive, seq, calib, key) -> tuple:
    """FullSlam.run_device + finalize_device on the drive against the
    golden's "<key>" record, MODELS_RUNS runs equal to the bit.  Returns
    (one run's launches, check_captured's largest |Δ|)."""
    from veloslam_tpu_torch.decode.decode import DeviceCalib
    from veloslam_tpu_torch.io import simulate as sim
    from veloslam_tpu_torch.runtime.fullslam import FullSlam
    track = sim.truth_track(seq, drift_rate=drive["drift_rate"])
    hosts, errs = [], dict.fromkeys(REG_KERNELS)
    for k in range(MODELS_RUNS):
        eng = FullSlam(DeviceCalib.from_host(calib, device=device),
                       model=drive["model"], use_dense=True,
                       **drive["engine"])
        _reset_launches()
        with capturing_kernel_inputs({}) as seen:
            host, stream_s, fin_s = run_fullslam(seq, track, eng, drive,
                                                 drive["budget_floor"])
        launches = _launches()
        _check_fullslam(host, eng, seq, drive, gold, launches, device, key)
        if k == 0 and device.type == "cuda":
            errs = check_captured(seen, smi, f"models {key}", timed=False)
        del seen
        hosts.append(host)
    _check_repeats(f"models {key}", hosts)
    n = int(hosts[0]["n_frames"])
    print(f"[models] {key}: the {MODELS_RUNS} runs equal to the bit; "
          f"stream {stream_s:.3f} s + finalize {fin_s:.3f} s: "
          f"{n / (stream_s + fin_s):.1f} frames/s ({n / stream_s:.1f} "
          f"stream only; the last run); launches per run {launches}; "
          f"{smi}", flush=True)
    return launches, errs


def _models_pipeline(device, smi, gold, drive, paths, seq, key,
                     fullslam_launches) -> tuple:
    """run_offline_batched + finalize() against the golden's "<key>"
    record with phase pipeline's gates, MODELS_RUNS runs equal to the bit;
    launches equal to the same engine's FullSlam run's.  Returns (one
    run's launches, check_captured's largest |Δ|)."""
    outs, errs = [], dict.fromkeys(REG_KERNELS)
    for k in range(MODELS_RUNS):
        _reset_launches()
        with capturing_kernel_inputs({}) as seen:
            pipe, res, wall = run_pipeline(paths, drive, device)
        launches = _launches()
        # The ATE at most the golden's + 0.02 m, without the HDL-32
        # drive's 0.15 m cap: the VLP-16's own golden reads 0.169 m.
        _check_pipeline(pipe, res, seq, gold, key, launches,
                        fullslam_launches, device, max_ate=np.inf)
        if k == 0 and device.type == "cuda":
            errs = check_captured(seen, smi, f"models {key}", timed=False)
        del seen
        outs.append(_pipeline_outputs(pipe, res))
    _check_repeats(f"models {key}", outs)
    n = res["n_frames"]
    print(f"[models] {key}: the {MODELS_RUNS} runs equal to the bit; "
          f"{n} frames in {wall:.3f} s: {n / wall:.1f} frames/s "
          f"(run_offline_batched + finalize, pcap read included; the last "
          f"run); launches per run {launches}; {smi}", flush=True)
    return launches, errs


def _models_per_frame(device, smi, gold, drive, paths, seq, key) -> tuple:
    """run_offline + finalize() (slam_run's default mode) against the
    golden's "<key>" record with phase per_frame's gates (its closures,
    as many as the golden accepts), MODELS_RUNS runs equal to the bit.
    Returns (one run's launches, check_captured's largest |Δ|)."""
    outs, errs = [], dict.fromkeys(REG_KERNELS)
    want = len(gold[f"{key}_closures"])
    for k in range(MODELS_RUNS):
        _reset_launches()
        with capturing_kernel_inputs({}) as seen:
            pipe, res, mid, wall = run_perframe(paths, drive, device)
        launches = _launches()
        summary = check_perframe(pipe, res, mid, seq, gold, key,
                                 min_closures=want)
        _live_gate(f"models {key}", launches, device)
        if k == 0 and device.type == "cuda":
            errs = check_captured(seen, smi, f"models {key}", timed=False,
                                  want=CAPTURED if want else
                                  ("gn_iteration", "gather_i32",
                                   "gather_rows8"))
        del seen
        outs.append(_perframe_outputs(pipe, res))
    _check_repeats(f"models {key}", outs)
    n = res["n_frames"]
    print(f"[models] {key}: {summary}; the {MODELS_RUNS} runs equal to "
          f"the bit; {n} frames in {wall:.3f} s: {n / wall:.2f} frames/s "
          f"(run_offline + finalize, pcap read included; the last run); "
          f"launches per run {launches}; {smi}", flush=True)
    return launches, errs


def _models_fast(device, smi, gold, drive, paths, key) -> tuple:
    """`slam_run --model M [--calibration db.xml] --fast` (the port's
    CLI) on the drive's pcap + INS log against the JAX app's
    trajectory.txt in the golden: times exact, positions within 1 cm;
    MODELS_RUNS runs equal; the three kernels launched equally often, a
    whole number of GN iterations.  Returns (one run's launches,
    check_captured's largest |Δ|)."""
    import io
    import tempfile

    from veloslam_tpu_torch.apps import slam_run
    args = ["--pcap", paths["pcap"], "--ins", paths["ins"], "--model",
            drive["model"], "--fast", "--batch", str(drive["fast_batch"]),
            "--device", device.type]
    if "calibration" in paths:
        args += ["--calibration", paths["calibration"]]
    want = gold[f"{key}_trajectory"]
    runs, errs = [], dict.fromkeys(REG_KERNELS)
    for k in range(MODELS_RUNS):
        with tempfile.TemporaryDirectory() as out:
            _reset_launches()
            with capturing_kernel_inputs({}, latest=True) as seen, \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = slam_run.main([*args, "--out-dir", out])
            launches = _launches()
            got = np.loadtxt(os.path.join(out, "trajectory.txt"), ndmin=2)
            with open(os.path.join(out, "metrics.json")) as f:
                metrics = json.load(f)
        off = (float(np.abs(got[:, 1:4] - want[:, 1:4]).max())
               if got.shape == want.shape else float("inf"))
        if not (rc == 0 and got.shape == want.shape
                and np.array_equal(got[:, 0], want[:, 0]) and off <= 0.01):
            raise AssertionError(f"models {key}: slam_run --fast rc {rc}, "
                                 f"{len(got)} frames (golden {len(want)}), "
                                 f"{off} m from the JAX app's trajectory")
        # One GN step, association and lookup per iteration of the
        # engine's 8 (StreamingOdometry's default) in every batch.
        counts = {launches[k] for k in REG_KERNELS}
        if device.type == "cuda" and not (
                len(counts) == 1 and min(counts) > 0
                and min(counts) % 8 == 0
                and launches["chain_factor"] == launches["chain_solve"] == 0):
            raise AssertionError(f"models {key}: launches {launches}")
        if k == 0 and device.type == "cuda":
            errs = check_captured(seen, smi, f"models {key}", timed=False,
                                  want=("gn_iteration", "gather_i32",
                                        "gather_rows8"))
        del seen
        runs.append(got)
    if not np.array_equal(runs[0], runs[-1]):
        raise AssertionError(f"models {key}: the runs' trajectories differ")
    print(f"[models] {key}: slam_run --fast, {len(got)} frames, times "
          f"equal to the JAX app's, positions max {off:.2e} m from it; the "
          f"{MODELS_RUNS} runs equal; {metrics['timing']} (the last run); "
          f"launches per run {launches}; {smi}", flush=True)
    return launches, errs


def _models_live(device, smi, gold, cfg, drive, paths, seq, slam,
                 key) -> tuple:
    """The drive as a live session (HDL-64): the golden's datagrams
    through ScriptedUdp, per frame and fast, each + finalize(), against
    the golden's "<key>_live_<mode>" records with phase live's gates;
    then measure_live_loopback at 1x the sensor's rate (INS interleaved
    at 100 Hz), fast (none lost or dropped, every INS datagram received,
    run_online's 2-D ATE within the golden session's + 0.02 m) and per
    frame (its keep-up shown: lost, feed time, lag).  Returns ({part:
    launches}, check_captured's largest |Δ|)."""
    from veloslam_tpu_torch.apps import replay
    from veloslam_tpu_torch.config import SlamConfig
    from veloslam_tpu_torch.io import udp
    from veloslam_tpu_torch.runtime.pipeline import SlamPipeline
    origin = tuple(cfg["origin"])
    config = SlamConfig.from_dict(slam)
    launches, worst = {}, dict.fromkeys(REG_KERNELS)
    ins = ins_payloads(replay.replay_ins_txt, udp, paths["ins"], origin)
    if ins != [r.tobytes() for r in gold[f"{key}_live_ins_payloads"]]:
        raise AssertionError(f"models {key}: replay_ins_txt's InsPVA "
                             "payloads differ from the JAX package's")
    streams = live_streams(dict(drive, ins=True, position=False), paths,
                           ins)
    for mode in drive["live_modes"]:
        lkey = f"{key}_live_{mode}"
        pipe = SlamPipeline(config, device=device)
        _reset_launches()
        with capturing_kernel_inputs({}, latest=True) as seen:
            live, mid, res = run_live_scripted(pipe, udp, streams,
                                               mode == "fast", origin)
        got = launches[f"live_scripted_{mode}"] = _launches()
        stream_off = check_live_stream(f"models {lkey}", live, gold, lkey)
        summary = check_perframe(pipe, res, mid, seq, gold, lkey,
                                 min_closures=len(gold[f"{lkey}_closures"]))
        check_live_counts(f"models {lkey}", live_counts(pipe, live, res),
                          json.loads(str(gold[f"{lkey}_live"])))
        _live_gate(f"models {lkey}", got, device)
        if device.type == "cuda":
            _worst(worst, check_captured(
                seen, smi, f"models {lkey}", timed=False,
                want=CAPTURED if mode == "per_frame"
                else ("gn_iteration", "gather_i32")))
        del seen
        print(f"[models] {lkey} scripted: run_online's trajectory "
              f"{stream_off:.2e} m from the golden's before finalize; after "
              f"it {summary}; health and counts equal to the golden's; "
              f"launches {got}; {smi}", flush=True)
    for mode in ("fast", "per_frame"):
        lkey = f"{key}_live_{mode}"
        _reset_launches()
        r = replay.measure_live_loopback(
            rate=1.0, fast=mode == "fast", warm=False, origin=origin,
            device=device, pcap=paths["pcap"], ins=paths["ins"],
            config=config)
        got = launches[f"live_loopback_{mode}_1x"] = _launches()
        times, pos = r.pop("times_us"), r.pop("positions")
        rmse = stream_ate(times, pos, seq) if len(times) else float("inf")
        limit = stream_ate(gold[f"{lkey}_stream_times_us"],
                           gold[f"{lkey}_stream_positions"], seq) + 0.02
        if not (len(times) and np.isfinite(pos).all()):
            raise AssertionError(f"models {lkey} loopback 1x: {r}")
        if mode == "fast" and not (
                r["lost"] == 0 and r["receiver_dropped"] == 0
                and r["received_ins"] == r["sent_ins"]
                and r["n_frames"] >= int(gold[f"{lkey}_n_frames"]) - 1
                and rmse <= limit):
            raise AssertionError(f"models {lkey} loopback 1x: {r}; 2-D ATE "
                                 f"{rmse} m (limit {limit} m)")
        _live_gate(f"models {lkey} loopback", got, device)
        keeps = (r["lost"] == 0 and r["receiver_dropped"] == 0
                 and r["batch_feed_ms_mean"] < r["batch_period_ms"])
        print(f"[models] {lkey} loopback, INS interleaved at 100 Hz, 1x "
              f"the sensor: {r}; keeps up: {keeps} (feed mean "
              f"{r['batch_feed_ms_mean']} ms against the "
              f"{r['batch_period_ms']} ms batch period, {r['lost']} lost, "
              f"{r['lag_s']} s behind the last packet); run_online's 2-D "
              f"ATE {rmse:.4f} m (the golden session's + 0.02: "
              f"{limit:.4f}); launches {got}; {smi}", flush=True)
    return launches, worst


def phase_models(device, smi: str, reg: dict, name: str = "full") -> tuple:
    """The HDL-64 (with its per-unit calibration file) and the VLP-16
    through every single-card entry point, against the JAX golden
    (models_golden_seed3.npz; `name="small"`: its CPU drives, for a
    rehearsal): per model the bulk step at bench.py's width, FullSlam +
    finalize_device, run_offline_batched + finalize(), run_offline +
    finalize(), slam_run --fast; the HDL-64 also live.  `reg`: the
    production registration config of the bulk step.  Returns ({part:
    launches}, the largest |Δ| per kernel over every captured input)."""
    import tempfile

    from veloslam_tpu_torch.decode import calibration
    gold, cfg, drives = models_drives(name)
    launches, worst = {}, dict.fromkeys(REG_KERNELS)
    t0 = time.perf_counter()
    for model, drive in drives.items():
        with tempfile.TemporaryDirectory() as tmp:
            paths, seq, slam = write_models_drive(drive, tmp)
            calib = (calibration.from_xml(paths["calibration"])
                     if "calibration" in paths
                     else calibration.default_for(model))
            print(f"[models] {drive['name']}: {len(seq['packets'])} "
                  f"{model} packets ({drive['duration_s']} s), calibration "
                  f"{paths.get('calibration', 'built in')}", flush=True)
            drive, key = dict(drive, slam=slam), drive["name"]

            def part(label, result):
                launches[f"{model}_{label}"], errs = result
                _worst(worst, errs)
                return launches[f"{model}_{label}"]

            if name == "full":
                part("bulk", _models_bulk(device, smi, model, calib, reg))
            fs = part("fullslam", _models_fullslam(
                device, smi, gold, drive, seq, calib, f"{key}_fullslam"))
            part("batched", _models_pipeline(
                device, smi, gold, drive, paths, seq, f"{key}_batched", fs))
            part("per_frame", _models_per_frame(
                device, smi, gold, drive, paths, seq, f"{key}_per_frame"))
            part("fast", _models_fast(device, smi, gold, drive, paths,
                                      f"{key}_fast"))
            if drive["live_modes"]:
                got, errs = _models_live(device, smi, gold, cfg, drive,
                                         paths, seq, slam, key)
                launches.update({f"{model}_{k}": v for k, v in got.items()})
                _worst(worst, errs)
    print(f"[models] phase {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    return launches, worst


def _timed(name: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds printed as phase `name`'s."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    device = torch.device("cuda", 0)
    _timed("build", phase_build)
    record = _timed("kernel", phase_kernel, device)
    gather_records = _timed("gather", phase_gather, device)
    chain_record = _timed("chain", phase_chain, device)
    gold = np.load(GOLDEN)
    cfg = json.loads(str(gold["config"]))
    drive_launches = _timed("drive", phase_drive, device, gold, cfg)
    print(f"[drive] launches over both drives: {drive_launches}", flush=True)
    _timed("bulk", phase_bulk, device, smi, cfg["odometry"])
    fullslam_launches = _timed("fullslam", phase_fullslam, device, smi)
    launches = _timed("pipeline", phase_pipeline, device, smi,
                      fullslam_launches)
    bench_launches = _timed("bench", phase_bench, device, smi,
                            cfg["odometry"])
    perframe_launches, perframe_errs = _timed("per_frame", phase_per_frame,
                                              device, smi)
    paths_launches, paths_errs = _timed("paths", phase_paths, device, smi)
    live_launches, live_errs = _timed("live", phase_live, device, smi)
    _timed("apps", phase_apps, device, smi)
    _timed("pcg", phase_pcg, device, smi)
    long_launches = _timed("long_drive", phase_long_drive, device, smi)
    multichip_launches, multichip_errs = _timed("multichip", phase_multichip,
                                                device, smi)
    models_launches, models_errs = _timed("models", phase_models, device,
                                          smi, cfg["odometry"])
    print(f"[time] all phases: {time.perf_counter() - t0:.1f} s; golden "
          f"drives simulated in {SIM_SECONDS['simulated']:.1f} s, reuses "
          f"saved {SIM_SECONDS['saved']:.1f} s", flush=True)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "veloslam_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded the JAX package: {loaded}")
    src = "veloslam_tpu_torch/csrc/"

    def paths(name):
        return {"bench_launches": {part: got[name] for part, got in
                                   bench_launches.items()},
                "paths_launches": {part: got[name] for part, got in
                                   paths_launches.items()},
                "paths_max_abs_err": paths_errs[name],
                "live_launches": {part: got[name] for part, got in
                                  live_launches.items()},
                "live_max_abs_err": live_errs[name],
                "multichip_launches": {part: got[name] for part, got in
                                       multichip_launches.items()},
                "multichip_max_abs_err": multichip_errs[name],
                "models_launches": {part: got[name] for part, got in
                                    models_launches.items()},
                "models_max_abs_err": models_errs[name]}

    kernels = [
        {"name": "fused_normal_equations", "route": "cuda",
         "source": src + "normal_equations.cu",
         "replaces": "veloslam_tpu/registration/pallas_kernels.py:84",
         "launches": launches["fused_normal_equations"],
         "per_frame_launches": perframe_launches["fused_normal_equations"],
         "per_frame_max_abs_err": perframe_errs["fused_normal_equations"],
         **paths("fused_normal_equations"), **record},
        {"name": "gather_i32", "route": "cuda", "source": src + "gather.cu",
         "replaces": "scripts/bench_pallas_gather.py:54",
         "launches": launches["gather_i32"],
         "per_frame_launches": perframe_launches["gather_i32"],
         "per_frame_max_abs_err": perframe_errs["gather_i32"],
         **paths("gather_i32"), **gather_records["gather_i32"]},
        {"name": "gather_rows8", "route": "cuda", "source": src + "gather.cu",
         "replaces": "scripts/bench_pallas_gather.py:88",
         "launches": launches["gather_rows8"],
         "per_frame_launches": perframe_launches["gather_rows8"],
         "per_frame_max_abs_err": perframe_errs["gather_rows8"],
         **paths("gather_rows8"), **gather_records["gather_rows8"]},
        {"name": "chain", "route": "cuda", "source": src + "chain.cu",
         "replaces": "veloslam_tpu/graph/pcg.py:105-152 (lax.scan; no "
                     "Pallas original)",
         "launches": long_launches["chain_factor"]
         + long_launches["chain_solve"],
         "per_frame_launches": perframe_launches["chain_factor"]
         + perframe_launches["chain_solve"],
         "bench_launches": {part: got["chain_factor"] + got["chain_solve"]
                            for part, got in bench_launches.items()},
         "paths_launches": {part: got["chain_factor"] + got["chain_solve"]
                            for part, got in paths_launches.items()},
         "live_launches": {part: got["chain_factor"] + got["chain_solve"]
                           for part, got in live_launches.items()},
         "live_max_abs_err": None,       # not launched on the live path
         "multichip_launches": {part: got["chain_factor"]
                                + got["chain_solve"]
                                for part, got in multichip_launches.items()},
         "multichip_max_abs_err": None,  # not launched: dense solves
         "models_launches": {part: got["chain_factor"] + got["chain_solve"]
                             for part, got in models_launches.items()},
         "models_max_abs_err": None,     # not launched: dense solves
         **chain_record},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
