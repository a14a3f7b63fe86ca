"""Parity of the port's live mode with the JAX package, on the CPU.

* The INS port's wire structs (InsPVA, RawINS, BestGPSPos, the message
  id peek), `ins_timestamp_us`, `HdlClock` (per stamp, in batches, the
  GPS grounding) and `InsConverter` on the same seeded inputs: equal
  bytes and values (float64 to 1e-9).
* `handle_ins_datagram` and `handle_position_packet` on one datagram
  list: the health counters, the IMU log and the pose track equal to the
  JAX pipeline's, with the case of the fault where `ins_health` never
  moved (tests/test_udp_live.py::test_pipeline_ins_dispatch).
* `run_online` with the scripted receiver (chip_smoke.ScriptedUdp) on the
  "small" drive per frame and fast and the "gps" drive of
  tests/fixtures/live_golden_seed3.npz, + finalize(), against the JAX
  package's sessions with phase per_frame's gates (frames, frame times
  and keyframe times exact, closures as sets, landmark count, positions
  within 5 cm in x, y and 0.15 m in z, ATE at most the golden's + 2 cm),
  the health dicts, the IMU log's length and live_stats' counts equal.
* The UDP receiver's exact and variable-size loopback round trips,
  native and pure Python; the packet pump's source byte-equal to the
  JAX copy; a failed pump build raises.
* One real-loopback run_online session with
  tests/test_udp_live.py::test_online_pipeline_loopback's assertions.

UDP ports come from binding port 0, never a fixed number: the JAX
package's live tests use fixed ports in a parallel worker.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_helpers import small_threads  # noqa: F401
from veloslam_tpu.core import geodesy as jgeo
from veloslam_tpu.core import timesync as jts
from veloslam_tpu.io import ins as jins
from veloslam_tpu.io import packets as jpk
from veloslam_tpu.runtime.pipeline import SlamPipeline as JSlamPipeline
from veloslam_tpu_torch import _build
from veloslam_tpu_torch import constants as C
from veloslam_tpu_torch.apps import replay
from veloslam_tpu_torch.config import SlamConfig
from veloslam_tpu_torch.core import geodesy, timesync
from veloslam_tpu_torch.io import ins, native, udp
from veloslam_tpu_torch.io import packets as pk
from veloslam_tpu_torch.io import simulate as sim
from veloslam_tpu_torch.runtime.pipeline import SlamPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inspva_messages(n, seed):
    """Seeded InsPVA field tuples around (31°, 121.5°)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append((int(rng.integers(2000, 2500)), int(rng.integers(0, 6e8)),
                    int(rng.integers(2000, 2500)), float(rng.uniform(0, 6e5)),
                    (31.0 + rng.normal(0, 1e-3), 121.5 + rng.normal(0, 1e-3),
                     rng.normal(10, 3)),
                    tuple(rng.normal(0, 5, 3)),
                    tuple(rng.uniform(-180, 180, 3)),
                    int(rng.integers(0, 4))))
    return out


def test_ins_codecs_and_message_id_match_jax():
    for args in inspva_messages(8, 0):
        raw = pk.pack_inspva(*args)
        assert raw == jpk.pack_inspva(*args)
        assert len(raw) == pk.INSPVA_BYTES == jpk.INSPVA_BYTES == 104
        assert pk.unpack_inspva(raw) == jpk.unpack_inspva(raw)
        assert pk.peek_message_id(raw) == C.INS_MSG_INSPVA
    rng = np.random.default_rng(1)
    for _ in range(8):
        wk, ms, st = (int(x) for x in rng.integers(0, 2**15, 3))
        acc = tuple(int(x) for x in rng.integers(-2**30, 2**30, 3))
        raw = pk.pack_rawins(wk, ms, st, acc)
        assert raw == jpk.pack_rawins(wk, ms, st, acc)
        assert pk.unpack_rawins(raw) == jpk.unpack_rawins(raw)
        gp = pk.pack_bestgpspos(wk, ms, st, st + 1, float(rng.uniform(0, 9)))
        assert gp == jpk.pack_bestgpspos(wk, ms, st, st + 1,
                                         pk.unpack_bestgpspos(gp)["diff_age"])
        assert pk.unpack_bestgpspos(gp) == jpk.unpack_bestgpspos(gp)
        for d in (raw, gp, raw[:1], b"", b"\x63\x00junk"):
            assert pk.peek_message_id(d) == jpk.peek_message_id(d)
    assert (pk.RAWINS_BYTES, pk.BESTGPSPOS_BYTES) == (24, 20)


def test_ins_timestamp_and_hdl_clock_match_jax():
    rng = np.random.default_rng(2)
    for wk, ms, wp, sp in [(2380, 1000, None, None), (2380, 1000, 2380, -1.0),
                           *[(int(rng.integers(2000, 2500)),
                              int(rng.integers(0, 6e8)),
                              int(rng.integers(2000, 2500)),
                              float(rng.uniform(0, 6e5))) for _ in range(6)]]:
        assert (timesync.ins_timestamp_us(wk, ms, wp, sp)
                == jts.ins_timestamp_us(wk, ms, wp, sp))
    assert (timesync.GPS_EPOCH_UNIX_US, timesync.WEEK_US) == (
        jts.GPS_EPOCH_UNIX_US, jts.WEEK_US)
    # Stamps across two counter wraps, in batches and one at a time.
    us = np.concatenate([np.arange(3_599_000_000, 3_600_000_000, 71_000),
                         np.arange(0, 3_600_000_000, 450_000_000),
                         np.arange(0, 900_000, 71_000)])
    ref = 1_700_000_000_000_000
    ours, theirs = timesync.HdlClock(), jts.HdlClock()
    assert not ours.grounded
    with pytest.raises(ValueError):
        ours.resolve_batch(us[:3])
    for a, b in ((0, 5), (5, 6), (6, 20), (20, len(us))):
        np.testing.assert_array_equal(
            ours.resolve_batch(us[a:b], ref_time_us=ref),
            theirs.resolve_batch(us[a:b], ref_time_us=ref))
    one, jone = timesync.HdlClock(), jts.HdlClock()
    assert [one.resolve(u, ref) for u in us] == [jone.resolve(u, ref)
                                                 for u in us]
    # Grounding: the first time, within tolerance (no re-ground), beyond.
    for clock in (one, jone):
        clock.ground(1_000_000, ref + 5_000_000)
    for u, utc in ((2_000_000, ref + 6_000_000 + 30_000),
                   (3_000_000, ref + 7_000_000 + 80_000)):
        assert one.maybe_ground(u, utc) == jone.maybe_ground(u, utc)
        assert one.resolve(u + 10) == jone.resolve(u + 10)
    fresh, jfresh = timesync.HdlClock(), jts.HdlClock()
    assert fresh.maybe_ground(5, ref) and jfresh.maybe_ground(5, ref)
    assert fresh.grounded and fresh.resolve(7) == jfresh.resolve(7)


@pytest.mark.parametrize("origin", [(31.0, 121.5, 0.0), None])
def test_ins_converter_matches_jax(origin):
    ours, theirs = ins.InsConverter(origin), jins.InsConverter(origin)
    for args in inspva_messages(10, 3):
        msg = pk.unpack_inspva(pk.pack_inspva(*args))
        a, b = ours.convert(msg), theirs.convert(msg)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-9)
    rng = np.random.default_rng(4)
    org = geodesy.llh2xyz_np(np.asarray([0.54, 2.11, 10.0]))
    xyz = org + rng.normal(0, 500, (20, 3))
    llh = np.stack([0.54 + rng.normal(0, 1e-4, 20),
                    2.11 + rng.normal(0, 1e-4, 20), rng.normal(0, 9, 20)], -1)
    np.testing.assert_array_equal(geodesy.xyz2enu_np(xyz, org),
                                  jgeo.xyz2enu_np(xyz, org))
    np.testing.assert_array_equal(geodesy.llh2enu_np(llh, org),
                                  jgeo.llh2enu_np(llh, org))


def test_datagram_handlers_match_jax_and_move_ins_health():
    """One InsPVA, one RawINS, one BestGPSPos and one unknown datagram
    read 1/1/1/1 in results()["ins_health"] with the last IMU status and
    GPS solution, as in the JAX package (the fault: the port's counters
    never moved); position packets ground the clock and fill
    gps_health equally."""
    datagrams = [
        pk.pack_inspva(2380, 1000, 2380, 1.0, (31.0001, 121.5001, 5.0),
                       (1, 0, 0), (0, 0, 30.0)),
        pk.pack_rawins(2380, 1001, 2, (10, 20, 30)),
        pk.pack_bestgpspos(2380, 1002, 4, 0, 0.8),
        b"\x63\x00junk"]
    t0 = 1_700_000_000_000_000
    # Three fixes, a jump of the hour base beyond the tolerance, and a
    # packet with no sentence.
    positions = [pk.pack_position_packet(t % 3_600_000_000, t, 31.0, 121.0)
                 for t in (t0, t0 + 200_000, t0 + 400_000)]
    positions += [pk.pack_position_packet(5, t0, 31.0, 121.0),
                  bytes(C.POSITION_PACKET_BYTES)]
    ours, theirs = SlamPipeline(device="cpu"), JSlamPipeline()
    conv, jconv = ins.InsConverter((31.0, 121.5, 0.0)), jins.InsConverter(
        (31.0, 121.5, 0.0))
    for d in datagrams:
        assert (ours.handle_ins_datagram(d, conv)
                == theirs.handle_ins_datagram(d, jconv))
    clock, jclock = timesync.HdlClock(), jts.HdlClock()
    for raw in positions:
        ours.handle_position_packet(raw, clock)
        theirs.handle_position_packet(raw, jclock)
    res = ours.results()
    h = res["ins_health"]
    assert (h["inspva_count"], h["rawins_count"], h["bestgps_count"],
            h["unknown_count"]) == (1, 1, 1, 1)
    assert h["last_imu_status"] == 2 and h["last_gps_solution"] == 4
    assert h == theirs.results()["ins_health"]
    assert res["gps_health"] == theirs.results()["gps_health"]
    assert res["gps_health"]["grounded"] and clock.grounded
    assert ours.imu_log == theirs.imu_log == [
        (ours.imu_log[0][0], 2, (10, 20, 30))]
    assert len(ours.track) == len(theirs.track) == 1
    (qa, ta), (qb, tb) = (ours.track.timeline.arrays(),
                          theirs.track.timeline.arrays())
    np.testing.assert_array_equal(qa, qb)
    for k in tb:
        np.testing.assert_allclose(ta[k], tb[k], rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def live_golden():
    gold = np.load(cs.LIVE_GOLDEN)
    return gold, json.loads(str(gold["config"]))


@pytest.mark.parametrize("name,mode", [("small", "per_frame"),
                                       ("small", "fast"),
                                       ("gps", "per_frame")])
def test_scripted_run_online_matches_jax_golden(name, mode, live_golden,
                                                tmp_path):
    gold, cfg = live_golden
    drive = {d["name"]: d for d in cfg["drives"]}[name]
    origin = tuple(cfg["origin"])
    paths, seq = cs.write_pipeline_drive(drive, cfg["model"], str(tmp_path))
    payloads = (cs.ins_payloads(replay.replay_ins_txt, udp, paths["ins"],
                                origin) if drive["ins"] else [])
    assert payloads == [r.tobytes() for r in gold[f"{name}_ins_payloads"]]
    pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]), device="cpu")
    live, mid, res = cs.run_live_scripted(
        pipe, udp, cs.live_streams(drive, paths, payloads), mode == "fast",
        origin)
    key = f"{name}_{mode}"
    assert cs.check_live_stream(key, live, gold, key) <= 1e-3
    cs.check_perframe(pipe, res, mid, seq, gold, key,
                      min_closures=cs.LIVE_MIN_CLOSURES[name])
    cs.check_live_counts(key, cs.live_counts(pipe, live, res),
                         json.loads(str(gold[f"{key}_live"])))
    assert res["n_frames"] >= 3
    np.testing.assert_allclose(res["positions"], gold[f"{key}_positions"],
                               atol=1e-3)
    st = live["live_stats"]
    assert st["lidar_packets"] == len(cs.live_streams(
        drive, paths, payloads)[cs.LIVE_PORTS["lidar"]])
    assert st["batches"] == -(-st["lidar_packets"]
                              // pipe.cfg.pipeline.packets_per_batch)
    if name == "gps":
        assert res["gps_health"]["grounded"] and len(pipe.track) == 0
        assert np.all(np.abs(res["times_us"] - seq["pkt_times_us"][0])
                      < 5_000_000)


def test_scripted_session_does_not_depend_on_chunking(live_golden,
                                                      tmp_path):
    """The same datagrams in LiDAR polls of 300 and of 37 packets give
    the same trajectory to the bit: the result depends on the packet
    sequence only."""
    gold, cfg = live_golden
    drive = {d["name"]: d for d in cfg["drives"]}["gps"]
    paths, _ = cs.write_pipeline_drive(drive, cfg["model"], str(tmp_path))
    streams = cs.live_streams(drive, paths, [])
    out = []
    for chunk in (cs.LIVE_CHUNK, 37):
        pipe = SlamPipeline(SlamConfig.from_dict(drive["slam"]),
                            device="cpu")
        script = cs.ScriptedUdp(streams, cs.LIVE_PORTS["lidar"], chunk)
        with cs.scripted_udp(udp, script):
            out.append(pipe.run_online(
                lidar_port=cs.LIVE_PORTS["lidar"],
                ins_port=cs.LIVE_PORTS["ins"],
                position_port=cs.LIVE_PORTS["position"],
                idle_timeout_s=cs.LIVE_IDLE_S))
    for k in ("times_us", "positions", "quaternions"):
        np.testing.assert_array_equal(out[0][k], out[1][k])


def _receive(rx, n, var=False, timeout=3.0):
    got, deadline = [], time.time() + timeout
    while len(got) < n and time.time() < deadline:
        if var:
            p, lens, _ = rx.poll_var()
            got += [row[:ln].tobytes() for row, ln in zip(p, lens)]
        else:
            p, _ = rx.poll()
            got += [row.tobytes() for row in p]
        if len(p) == 0:
            time.sleep(0.01)
    return got


@pytest.mark.parametrize("force_python", [False, True])
def test_udp_loopback_roundtrip(force_python):
    rng = np.random.default_rng(1)
    pkts = rng.integers(0, 256, (50, C.HDL_PACKET_BYTES)).astype(np.uint8)
    port = replay.free_udp_port()
    with udp.UdpReceiver(port, C.HDL_PACKET_BYTES,
                         force_python=force_python) as rx:
        assert udp.replay_packets(pkts, "127.0.0.1", port, pace_us=50,
                                  force_python=force_python) == 50
        got = _receive(rx, 50)
        assert rx.dropped == 0
    assert got == [p.tobytes() for p in pkts]


@pytest.mark.parametrize("force_python", [False, True])
def test_udp_variable_size_loopback(force_python):
    """Mixed-size datagrams on one port (the INS port's message types),
    in order and intact; an oversized one is refused."""
    msgs = [pk.pack_inspva(2380, 1000, 2380, 1.0, (31.0, 121.5, 10.0),
                           (1, 0, 0), (0, 0, 45.0)),
            pk.pack_rawins(2380, 1001, 0, (1, 2, 3)),
            pk.pack_bestgpspos(2380, 1002, 4, 0, 0.5)] * 5
    port = replay.free_udp_port()
    with udp.UdpReceiver(port, pk.INSPVA_BYTES, force_python=force_python,
                         variable=True) as rx:
        udp.send_struct(b"\x01" * (pk.INSPVA_BYTES + 1), "127.0.0.1", port)
        for m in msgs:
            udp.send_struct(m, "127.0.0.1", port)
            time.sleep(0.001)
        got = _receive(rx, len(msgs), var=True)
    assert got == msgs
    assert [pk.peek_message_id(g) for g in got[:3]] == [508, 325, 423]
    with pytest.raises(ValueError):
        udp.send_struct(b"\x00" * 1201)


def test_packet_pump_source_is_the_jax_copy_and_builds_apart():
    a = open(os.path.join(REPO, "veloslam_tpu", "io", "native",
                          "packet_pump.cpp"), "rb").read()
    assert open(native.SRC, "rb").read() == a
    lib = native.load()
    path = native.library_path()
    assert path.is_file() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("packet_pump-") and lib is native.load()


def test_failed_pump_build_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses, or no g++, raises, and so does
    the native receiver that needs it."""
    bad = tmp_path / "packet_pump.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="packet_pump.cpp"):
        native.load()
    with pytest.raises(_build.KernelBuildError):
        udp.UdpReceiver(replay.free_udp_port(), C.HDL_PACKET_BYTES)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        native.load()


def test_live_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay.measure_live_loopback(duration_s=0.1, warm=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamPipeline().run_online()


def test_online_pipeline_loopback():
    """The live path over real localhost UDP (the native receiver and
    sender): a simulated drive's InsPVA stream and LiDAR packets through
    run_online on the CPU, as tests/test_udp_live.py::
    test_online_pipeline_loopback runs the JAX package's."""
    from veloslam_tpu_torch.config import (PipelineConfig,
                                           RegistrationConfig, SensorConfig)
    seq = sim.generate_sequence(duration_s=0.8, model="hdl32", seed=17,
                                world=sim.World.demo(3))
    lidar_port, ins_port, pos_port = (replay.free_udp_port()
                                      for _ in range(3))
    org_xyz = geodesy.llh2xyz_np(np.array([np.deg2rad(31.0),
                                           np.deg2rad(121.5), 0.0]))
    ready = threading.Event()

    def send_ins():
        ready.wait(timeout=10)
        for t_us, p, yaw, v in zip(seq["ins_t_us"], seq["ins_pos"],
                                   seq["ins_yaw"], seq["ins_vel"]):
            gps_us = int(t_us) - timesync.GPS_EPOCH_UNIX_US
            week = gps_us // timesync.WEEK_US
            llh = geodesy.enu2llh_np(np.asarray(p, float), org_xyz)
            udp.send_struct(pk.pack_inspva(
                int(week), int((gps_us % timesync.WEEK_US) // 1000),
                int(week), (gps_us % timesync.WEEK_US) / 1e6,
                (np.rad2deg(llh[0]), np.rad2deg(llh[1]), llh[2]),
                tuple(np.asarray(v, float)),
                (0.0, 0.0, float(np.rad2deg(yaw)))), "127.0.0.1", ins_port)
            time.sleep(0.002)

    def send_lidar():
        ready.wait(timeout=10)
        time.sleep(0.3)                     # let INS lead (prior track)
        udp.replay_packets(seq["packets"], "127.0.0.1", lidar_port,
                           pace_us=100)

    cfg = SlamConfig(sensor=SensorConfig(model="hdl32"),
                     pipeline=PipelineConfig(packets_per_batch=128),
                     registration=RegistrationConfig(max_points=16384,
                                                     max_iterations=8))
    pipe = SlamPipeline(cfg, device="cpu")
    threads = [threading.Thread(target=f, daemon=True)
               for f in (send_ins, send_lidar)]
    for t in threads:
        t.start()
    res = pipe.run_online(lidar_port=lidar_port, ins_port=ins_port,
                          position_port=pos_port,
                          origin_llh_deg=(31.0, 121.5, 0.0),
                          duration_s=30.0, idle_timeout_s=2.5,
                          on_ready=ready.set)
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert res["n_frames"] >= 3, res["n_frames"]
    assert len(pipe.track) >= 40, len(pipe.track)
    assert np.all(np.isfinite(res["positions"]))
    st = res["live_stats"]
    assert st["lidar_packets"] == len(seq["packets"])
    assert st["lidar_dropped"] == st["ins_dropped"] == 0
    assert res["ins_health"]["inspva_count"] == st["ins_datagrams"] >= 40


def test_idle_timeout_opens_when_the_receivers_are_ready():
    """run_online's idle window counts from when its ports are bound and
    on_ready has returned, not from its call: a setup longer than the
    timeout (the fast engine's build on the card took ~1 s for the HDL-64
    live session) must not end the session before the first packet.
    Here on_ready itself takes 0.6 s against a 0.4 s timeout, and the
    sender starts 0.05 s after it."""
    seq = sim.generate_sequence(duration_s=0.05, model="hdl32", seed=3,
                                world=sim.World.demo(3))
    lidar_port, ins_port, pos_port = (replay.free_udp_port()
                                      for _ in range(3))
    ready = threading.Event()

    def send():
        ready.wait(timeout=10)
        time.sleep(0.05)
        udp.replay_packets(seq["packets"], "127.0.0.1", lidar_port,
                           pace_us=100)

    def on_ready():
        time.sleep(0.6)
        ready.set()

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    res = SlamPipeline(device="cpu").run_online(
        lidar_port=lidar_port, ins_port=ins_port, position_port=pos_port,
        origin_llh_deg=(31.0, 121.5, 0.0), duration_s=30.0,
        idle_timeout_s=0.4, on_ready=on_ready)
    sender.join(timeout=5)
    assert not sender.is_alive()
    st = res["live_stats"]
    assert st["lidar_packets"] == len(seq["packets"]) > 0
    assert st["lidar_dropped"] == 0 and st["batches"] == 1


@pytest.mark.parametrize("force_python", [False, True])
def test_paced_replay_keeps_its_rate(force_python):
    """replay_packets sends every packet, in order, at its average pace
    on an absolute clock (no slower: each wake-up sends what is due)."""
    rng = np.random.default_rng(6)
    pkts = rng.integers(0, 256, (600, C.HDL_PACKET_BYTES)).astype(np.uint8)
    port = replay.free_udp_port()
    stats = {}
    with udp.UdpReceiver(port, C.HDL_PACKET_BYTES) as rx:
        t0 = time.monotonic()
        assert udp.replay_packets(pkts, "127.0.0.1", port, 1e6 / 6000.0,
                                  force_python=force_python,
                                  stats=stats) == 600
        took = time.monotonic() - t0
        got = _receive(rx, 600)
    assert got == [p.tobytes() for p in pkts]
    assert 0.09 <= stats["send_s"] <= took < 1.0, (stats, took)


def test_paced_keeps_the_average_rate_when_sleeps_overshoot():
    """On a clock whose every sleep overshoots by 1 ms, 1000 items 100 µs
    apart still finish when the last is due (+ one overshoot), sent in
    order in bursts; a sleep after each item would take 1.1 s.  Items due
    before the clock origin are not sent early."""
    now = [10.0]

    def sleep(d):
        now[0] += d + 1e-3
    calls = []
    stats = {}
    udp.paced(1000, 1e-4, lambda i, j: calls.append((i, j, now[0])),
              t0=10.05, stats=stats, clock=lambda: now[0], sleep=sleep)
    assert [c[0] for c in calls] == [0] + [c[1] for c in calls[:-1]]
    assert calls[-1][1] == 1000
    assert calls[0][2] >= 10.05
    for i, _, t in calls:
        assert t >= 10.05 + i * 1e-4 - 1e-12        # none before its time
    assert stats["send_s"] <= 999e-4 + 1.1e-3, stats
    assert stats["max_late_ms"] <= 1.1, stats
    assert len(calls) < 200                          # bursts, not 1000 calls
    sent = []
    udp.paced(5, 0.0, lambda i, j: sent.append((i, j)))   # unpaced: one call
    assert sent == [(0, 5)]
