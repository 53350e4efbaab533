"""Port parity: the C++ runtime's bindings in cslam_tpu_torch.runtime.native
— NativeBus over real TCP between bus instances of one process (distinct
robot ids on one base port), NativeLogger's CSVs, NativeRendezvous —
the counterparts of tests/test_native_runtime.py,
tests/test_native_integration.py and
tests/test_eval_artifacts.py::test_spectral_matches_csv_written; and the
port's bus talking to the reference's bus, one robot on each package:
every message type arrives byte-identical both ways.

Each library is built by the port from its own native/*.cpp into
cslam_tpu_torch/_build/. Ports 20100-20199 are this file's (the
reference's tests use 18100-18700 and 19310). Every bus is closed in a
`finally`.
"""

import os
import time

import numpy as np
import pytest
import torch

from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.runtime import native as jnative
from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.bus import WallClock
from cslam_tpu_torch.comm.neighbor_monitor import NeighborMonitor
from cslam_tpu_torch.runtime import native

from test_torch_comm import _messages

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _wait_for(predicate, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


class _Raw:
    def __init__(self, data):
        self._data = data

    def to_bytes(self):
        return self._data


def test_libraries_build_from_their_own_sources():
    """One library per source, its flags in its name's hash: the bus and
    the logger with -pthread, nothing written into native/."""
    for src in (native.BUS_SOURCE, native.LOGGER_SOURCE,
                native.RENDEZVOUS_SOURCE):
        path = native.build(src)
        assert path.exists() and path.parent == native.BUILD_DIR
        assert path == native.library_path(src)
        prefix = native.LIBRARIES[src][0] + "_"
        assert not any(f.startswith(prefix)
                       for f in os.listdir(src.parent))
    assert "-pthread" in native._flags(native.BUS_SOURCE)
    assert "-pthread" not in native._flags(native.RENDEZVOUS_SOURCE)


def test_bus_roundtrip():
    base = 20100
    bus0 = native.NativeBus(0, 2, base_port=base)
    bus1 = native.NativeBus(1, 2, base_port=base)
    try:
        got = []
        bus1.subscribe("/cslam/global_descriptors", got.append,
                       msgs.GlobalDescriptors)
        descs = msgs.GlobalDescriptors([
            msgs.GlobalDescriptor(3, 0, np.arange(8, dtype=np.float32))
        ])
        bus0.publish("/cslam/global_descriptors", descs)

        def received():
            bus1.spin_once(timeout_ms=50)
            return len(got) > 0

        assert _wait_for(received), "message not delivered over TCP"
        assert got[0].descriptors[0].keyframe_id == 3
        np.testing.assert_allclose(got[0].descriptors[0].descriptor,
                                   np.arange(8))
        assert bus0.sent_bytes > 0
        assert bus1.received_bytes > 0
    finally:
        bus0.close()
        bus1.close()


def test_bus_namespacing_and_loopback():
    base = 20110
    bus0 = native.NativeBus(0, 2, base_port=base)
    bus1 = native.NativeBus(1, 2, base_port=base)
    try:
        got0, got1 = [], []
        # relative topic -> own namespace; loopback delivers locally
        bus0.subscribe("cslam/heartbeat", got0.append, msgs.Heartbeat)
        bus1.subscribe("/r0/cslam/heartbeat", got1.append, msgs.Heartbeat)
        bus0.publish("cslam/heartbeat", msgs.Heartbeat(7))
        assert _wait_for(lambda: (bus0.spin_once(50), bus1.spin_once(50),
                                  got0 and got1)[-1])
        assert got0[0].origin_robot_id == 7
        assert got1[0].origin_robot_id == 7
    finally:
        bus0.close()
        bus1.close()


def test_bus_three_robots_broadcast():
    base = 20120
    buses = [native.NativeBus(i, 3, base_port=base) for i in range(3)]
    try:
        received = {i: [] for i in range(3)}
        for i, b in enumerate(buses):
            b.subscribe("/cslam/inter_robot_matches", received[i].append,
                        msgs.InterRobotMatches)
        matches = msgs.InterRobotMatches(
            robot_id=1, matches=[msgs.InterRobotMatch(0, 1, 2, 3, 0.9)])
        buses[1].publish("/cslam/inter_robot_matches", matches)
        assert _wait_for(lambda: all(
            (b.spin_once(20), len(received[i]) > 0)[-1]
            for i, b in enumerate(buses)))
        for i in range(3):
            assert received[i][0].matches[0].weight == pytest.approx(0.9)
    finally:
        for b in buses:
            b.close()


def test_bus_oversized_frame_grows_buffer():
    """One frame larger than the poll buffer must not wedge the queue
    (bus.cpp returns -2 and keeps FIFO order; spin_once grows the buffer
    via cslam_bus_front_sizes and retries)."""
    bus = native.NativeBus(0, 1, base_port=20130)
    try:
        import ctypes
        bus._data_buf = ctypes.create_string_buffer(64)
        got = []
        bus.subscribe("/cslam/raw", got.append, None)
        big = bytes(range(256)) * 16  # 4096 B > 64 B buffer
        small = b"after"
        bus._publish_resolved("/cslam/raw", _Raw(big))
        bus._publish_resolved("/cslam/raw", _Raw(small))
        assert _wait_for(lambda: (bus.spin_once(50), len(got) >= 2)[-1])
        assert got[0] == big          # FIFO preserved, payload intact
        assert got[1] == small        # queue not wedged
        assert len(bus._data_buf) >= len(big)
    finally:
        bus.close()


def test_native_logger_writes_the_reference_csvs(tmp_path):
    """The same calls through both packages' loggers give the same
    files: metrics.csv (key,value), pose_timestamps.csv and a named
    match stream with the reference's columns."""
    edges = [msgs.InterRobotMatch(0, 3, 1, 7, 0.875),
             msgs.InterRobotMatch(0, 4, 2, 9, 0.5)]
    files = {}
    for name, mod in (("port", native), ("jax", jnative)):
        folder = str(tmp_path / name)
        logger = mod.NativeLogger(folder)
        try:
            logger.log_info("nb_matches", 17)
            logger.start_timer()
            time.sleep(0.02)
            assert logger.stop_timer() >= 15.0  # ms
            logger.log_pose_timestamp(0, 5, 100, 200)
            logger.log_matches("spectral_matches", edges)
            logger.write_logs()
        finally:
            logger.close()
        files[name] = {f: open(os.path.join(folder, f)).read()
                       for f in sorted(os.listdir(folder))}
    port, ref = files["port"], files["jax"]
    assert sorted(port) == sorted(ref)
    assert "nb_matches,17" in port["metrics.csv"]
    assert "latest_pgo_time_ms" in port["metrics.csv"]
    assert "0,5,100,200" in port["pose_timestamps.csv"]
    lines = port["spectral_matches.csv"].strip().splitlines()
    assert lines[0].replace(" ", "") == \
        "robot0_id,robot0_keyframe_id,robot1_id,robot1_keyframe_id,weight"
    assert lines[1:] == ["0,3,1,7,0.875", "0,4,2,9,0.5"]
    for f in ("pose_timestamps.csv", "spectral_matches.csv"):
        assert port[f] == ref[f], f
    # metrics hold a measured time, so compare their keys only
    keys = [sorted(line.split(",")[0] for line in d["metrics.csv"].split())
            for d in (port, ref)]
    assert keys[0] == keys[1]


def test_native_rendezvous_matches_reference(tmp_path):
    sched = tmp_path / "sched.csv"
    sched.write_text("0,0.0,10.0,20.0,30.0\n1,5.0,15.0\n")
    rv0 = native.NativeRendezvous(str(sched), 0)
    rv1 = native.NativeRendezvous(str(sched), 1)
    rv_bad = native.NativeRendezvous(str(tmp_path / "missing.csv"), 0)
    refs = [jnative.NativeRendezvous(str(sched), r) for r in (0, 1)]
    try:
        assert rv0.is_alive(1.0) and not rv1.is_alive(1.0)
        assert rv0.is_alive(25.0) and not rv1.is_alive(25.0)
        assert not rv0.is_alive(16.0)
        assert rv1.is_alive(9.0)
        # missing schedule leaves the robot alive
        assert rv_bad.is_alive(100.0)
        for now in np.arange(0.0, 35.0, 0.5):
            assert [rv0.is_alive(now), rv1.is_alive(now)] == \
                [r.is_alive(now) for r in refs]
    finally:
        for rv in (rv0, rv1, rv_bad, *refs):
            rv.close()


def test_rendezvous_gated_heartbeats_drive_liveness(tmp_path):
    """Heartbeats gated by the rendezvous schedule over the TCP bus drive
    the neighbor monitor's liveness (the reference's SimulatedRendezVous
    + NeighborMonitor interplay)."""
    base = 20140
    sched = tmp_path / "sched.csv"
    sched.write_text("1,0.0,1.5\n")  # robot 1 alive in [0, 1.5] s
    rdv = native.NativeRendezvous(str(sched), 1)
    bus0 = native.NativeBus(0, 2, base_port=base)
    bus1 = native.NativeBus(1, 2, base_port=base)
    try:
        monitor = NeighborMonitor(bus0, WallClock(), 1, True,
                                  init_delay_sec=0.1, max_delay_sec=0.6)
        # re-register with typed deserialization (NativeBus needs types)
        bus0._subs.clear()
        bus0.subscribe("/r1/cslam/heartbeat", monitor.heartbeat_callback,
                       msgs.Heartbeat)
        t0 = time.time()
        saw_alive = False
        saw_dead_after_window = False
        while time.time() - t0 < 3.0:
            now = time.time() - t0
            if rdv.is_alive(now):
                bus1.publish("cslam/heartbeat", msgs.Heartbeat(1))
            bus0.spin_once(timeout_ms=20)
            time.sleep(0.05)
            if monitor.is_alive():
                saw_alive = True
            elif saw_alive and now > 2.2:
                saw_dead_after_window = True
        assert saw_alive, "robot 1 never became alive in its window"
        assert saw_dead_after_window, \
            "robot 1 still alive after its rendezvous window closed"
    finally:
        bus0.close()
        bus1.close()
        rdv.close()


def test_spectral_matches_csv_written(tmp_path):
    """enable_sparsification_comparison on the port's detector ->
    spectral_matches.csv + greedy_matches.csv under the port logger's
    folder with the reference's columns, the same edges as the
    reference's run of the same mission and weights within 1e-5."""
    from test_torch_mission import JAX, PORT, build_swarm, close, \
        drive_pipeline

    rows = {}
    for name, P, mod in (("port", PORT, native), ("jax", JAX, jnative)):
        s = build_swarm(P, 2, 16)
        folder = str(tmp_path / name)
        logger = mod.NativeLogger(folder)
        try:
            det = s.nodes[0].detection
            det.logger = logger
            det.params["evaluation.enable_sparsification_comparison"] = True
            det.lcm.candidate_selector.params[
                "evaluation.enable_sparsification_comparison"] = True
            drive_pipeline(s)
            logger.write_logs()
        finally:
            logger.close()
            close(s)
        spectral = os.path.join(folder, "spectral_matches.csv")
        assert os.path.exists(os.path.join(folder, "greedy_matches.csv"))
        lines = open(spectral).read().strip().splitlines()
        assert lines[0].replace(" ", "") == \
            "robot0_id,robot0_keyframe_id,robot1_id,robot1_keyframe_id," \
            "weight"
        rows[name] = sorted(
            (tuple(int(v) for v in ln.split(",")[:4]),
             float(ln.split(",")[4])) for ln in lines[1:])
    port, ref = rows["port"], rows["jax"]
    assert port, "no spectral matches recorded"
    assert all(k[0] == 0 and k[2] == 1 for k, _ in port)
    assert [k for k, _ in port] == [k for k, _ in ref]
    np.testing.assert_allclose([w for _, w in port], [w for _, w in ref],
                               atol=1e-5)


def test_port_bus_and_reference_bus_exchange_identical_bytes():
    """Robot 0 on the port's bus, robot 1 on the reference's, one base
    port: every message type published by one arrives at the other as
    the bytes the other package encodes for the same message, and
    decodes there into the same bytes again."""
    base = 20150
    port_bus = native.NativeBus(0, 2, base_port=base)
    ref_bus = jnative.NativeBus(1, 2, base_port=base)
    try:
        port_msgs, ref_msgs = _messages(msgs), _messages(jmsgs)
        for sender, receiver, sent, expect, decoder in (
                (port_bus, ref_bus, port_msgs, ref_msgs, jmsgs),
                (ref_bus, port_bus, ref_msgs, port_msgs, msgs)):
            while receiver.spin_once(0):
                pass  # its own loopback frames of the other direction
            got = {}
            receiver.subscribe("/cslam/wire/*",
                               lambda raw, got=got: got.setdefault(
                                   len(got), raw), None)
            names = sorted(sent)
            for name in names:
                sender.publish(f"/cslam/wire/{name}", sent[name])
            assert _wait_for(lambda: (receiver.spin_once(50),
                                      len(got) >= len(names))[-1])
            for i, name in enumerate(names):
                wire = expect[name].to_bytes()
                assert got[i] == wire, name
                cls = getattr(decoder, name.split("/")[0])
                assert cls.from_bytes(got[i]).to_bytes() == wire, name
            receiver._subs.clear()
    finally:
        port_bus.close()
        ref_bus.close()
