"""Port parity, the protocol's host layer: wire messages, bus, neighbor
liveness, broker election, gossip watermarks, simulated rendezvous,
vertex-cover brokerage, tracing, config and misc helpers — each on the
same inputs through cslam_tpu and cslam_tpu_torch.

Messages must be byte-identical in both directions (the port decodes
what the reference encodes and the reverse, the int8 gossip encoding
included); decoded floats must be bit-equal. Everything else here is
exact: the same liveness answers, the same covers, the same config.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cslam_tpu import config as jconfig
from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.comm import neighbor_monitor as jmon
from cslam_tpu.comm import neighbors_manager as jnm
from cslam_tpu.comm import rendezvous as jrdv
from cslam_tpu.matching.sparse_matching import \
    LoopClosureSparseMatching as JaxLCSM
from cslam_tpu.sparsification import broker as jbroker
from cslam_tpu.utils import misc as jmisc
from cslam_tpu_torch import config as tconfig
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.comm import neighbor_monitor as tmon
from cslam_tpu_torch.comm import neighbors_manager as tnm
from cslam_tpu_torch.comm import rendezvous as trdv
from cslam_tpu_torch.runtime import tracing as ttracing
from cslam_tpu_torch.sparsification import broker as tbroker
from cslam_tpu_torch.utils import misc as tmisc
from cslam_tpu_torch.utils.edges import EdgeInterRobot as TEdge

from test_algebraic_connectivity import build_multi_robot_graph

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unit(rng, d):
    v = rng.standard_normal(d).astype(np.float32)
    return v / np.linalg.norm(v)


def _pose(rng):
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    return R, rng.standard_normal(3).astype(np.float32)


def _messages(m, seed=0):
    """One instance of every message type of module `m`, from `seed`."""
    rng = np.random.default_rng(seed)
    pose, pose2 = _pose(rng), _pose(rng)
    cov = rng.random(6).astype(np.float32)
    d512 = [m.GlobalDescriptor(i, 1, _unit(rng, 512)) for i in range(8)]
    return {
        "GlobalDescriptor": m.GlobalDescriptor(3, 1, rng.random(16).astype(
            np.float32)),
        "GlobalDescriptors/float": m.GlobalDescriptors(d512),
        "GlobalDescriptors/int8": m.GlobalDescriptors(d512,
                                                      quantization="int8"),
        "GlobalDescriptors/int8-constant": m.GlobalDescriptors(
            [m.GlobalDescriptor(0, 1, np.full(16, 0.25, np.float32))],
            quantization="int8"),
        "GlobalDescriptors/int8-mixed-dims": m.GlobalDescriptors(
            [m.GlobalDescriptor(0, 1, _unit(rng, 8)),
             m.GlobalDescriptor(1, 1, _unit(rng, 16))], quantization="int8"),
        "GlobalDescriptors/int8-empty": m.GlobalDescriptors(
            [], quantization="int8"),
        "InterRobotMatch": m.InterRobotMatch(0, 1, 2, 3, 0.5),
        "InterRobotMatches": m.InterRobotMatches(
            2, [m.InterRobotMatch(2, k, 0, k + 1, 0.25 * k)
                for k in range(3)]),
        "LocalDescriptorsRequest": m.LocalDescriptorsRequest(7, [1, 2],
                                                             [3, 4]),
        "LocalKeyframeMatch": m.LocalKeyframeMatch(1, 2),
        "InterRobotLoopClosure": m.InterRobotLoopClosure(
            0, 5, 1, 9, True, pose, cov),
        "IntraRobotLoopClosure": m.IntraRobotLoopClosure(4, 17, False, pose),
        "KeyframeOdom": m.KeyframeOdom(
            11, pose, rng.random(3).astype(np.float32), cov),
        "LocalPointCloudDescriptors": m.LocalPointCloudDescriptors(
            1, 4, [0, 2], [5, 6],
            rng.standard_normal((10, 3)).astype(np.float32)),
        "LocalImageDescriptors": m.LocalImageDescriptors(
            1, 4, [0], [5], rng.random((6, 2)).astype(np.float32),
            rng.random((6, 32)).astype(np.float16),
            rng.random((6, 3)).astype(np.float32),
            np.array([1, 0, 1, 1, 0, 1], np.float32),
            np.array([1, 1, 1, 1, 0, 1], np.float32),
            (400.0, 401.5, 320.0, 240.25)),
        "KeyframeRGB": m.KeyframeRGB.from_image(
            3, (rng.random((4, 5, 3)) * 255).astype(np.uint8)),
        "Heartbeat": m.Heartbeat(2),
        "ReferenceFrames": m.ReferenceFrames(1, 0, pose, pose2, pose,
                                             pose2),
        "RobotIds": m.RobotIds([1, 2, 3]),
        "RobotIdsAndOrigin": m.RobotIdsAndOrigin([1, 2], [0, 0]),
        "PoseGraphValue": m.PoseGraphValue(1, 7, pose),
        "PoseGraphEdge": m.PoseGraphEdge((1, 0), (1, 1), pose,
                                         np.ones(6, np.float32) * 0.1),
        "PoseGraph": m.PoseGraph(
            robot_id=1, origin_robot_id=0,
            values=[m.PoseGraphValue(1, k, pose) for k in range(3)],
            edges=[m.PoseGraphEdge((1, 0), (1, 1), pose2, cov),
                   m.PoseGraphEdge((0, 2), (1, 1), pose, cov)],
            connected_robots=[0, 1]),
        "OptimizationResult": m.OptimizationResult(
            True, 0, [m.PoseGraphValue(0, k, pose2) for k in range(2)]),
        "KeyValue": m.KeyValue(b"nb_matches", b"17"),
    }


MESSAGE_CASES = sorted(_messages(jmsgs))


def _base_type(name):
    return name.split("/")[0]


@pytest.mark.parametrize("name", MESSAGE_CASES)
def test_message_bytes_match_reference(name):
    """Same message, same bytes; each package decodes the other's bytes
    and re-encodes them to the same bytes."""
    jm, tm = _messages(jmsgs)[name], _messages(tmsgs)[name]
    wire = jm.to_bytes()
    assert tm.to_bytes() == wire
    jcls = getattr(jmsgs, _base_type(name))
    tcls = getattr(tmsgs, _base_type(name))
    from_ref = tcls.from_bytes(wire)
    from_port = jcls.from_bytes(tm.to_bytes())
    assert type(from_ref).__module__ == tmsgs.__name__
    assert from_ref.to_bytes() == wire
    assert from_port.to_bytes() == wire
    if isinstance(from_ref, tmsgs.GlobalDescriptors):
        assert from_ref.quantization == from_port.quantization
        assert from_ref.uses_int8_encoding() == tm.uses_int8_encoding()
        for a, b in zip(from_ref.descriptors, from_port.descriptors):
            assert (a.keyframe_id, a.robot_id) == (b.keyframe_id,
                                                   b.robot_id)
            np.testing.assert_array_equal(a.descriptor, b.descriptor)


def test_legacy_image_descriptor_payload_decodes_alike():
    """A sender without the appended PnP fields: both packages decode
    the truncated payload to the same message."""
    full = _messages(jmsgs)["LocalImageDescriptors"].to_bytes()
    legacy = full[:-(4 + 6 + 4 + 6 + 16)]
    a = jmsgs.LocalImageDescriptors.from_bytes(legacy)
    b = tmsgs.LocalImageDescriptors.from_bytes(legacy)
    assert a.to_bytes() == b.to_bytes()
    assert b.valid3d.shape == (0,) and b.intrinsics == (0.0, 0.0, 0.0, 0.0)


def test_message_roundtrips():
    """The reference's round-trip cases on the port (test_comm.py)."""
    rng = np.random.default_rng(0)
    cases = [
        tmsgs.GlobalDescriptor(3, 1, rng.random(16).astype(np.float32)),
        tmsgs.InterRobotMatch(0, 1, 2, 3, 0.5),
        tmsgs.LocalDescriptorsRequest(7, [1, 2], [3, 4]),
        tmsgs.LocalKeyframeMatch(1, 2),
        tmsgs.Heartbeat(2),
        tmsgs.RobotIds([1, 2, 3]),
        tmsgs.RobotIdsAndOrigin([1, 2], [0, 0]),
        tmsgs.KeyValue(b"nb_matches", b"17"),
    ]
    for m in cases:
        m2 = type(m).from_bytes(m.to_bytes())
        for (name, kind) in m._FIELDS:
            a, b = getattr(m, name), getattr(m2, name)
            if kind == "floats":
                np.testing.assert_allclose(a, b)
            else:
                assert a == b, f"{type(m).__name__}.{name}"
    R, t = _pose(np.random.default_rng(1))
    lc2 = tmsgs.InterRobotLoopClosure.from_bytes(
        tmsgs.InterRobotLoopClosure(0, 5, 1, 9, True, (R, t)).to_bytes())
    assert lc2.success and lc2.robot1_keyframe_id == 9
    np.testing.assert_allclose(lc2.pose[0], R, atol=1e-6)
    np.testing.assert_allclose(lc2.pose[1], t, atol=1e-6)


def test_quantized_gossip_error_and_size():
    """The int8 encoding's error bound and size (test_quantized_gossip.py)
    on the port, and the same decoded values as the reference's."""
    rng = np.random.default_rng(0)
    descs = [tmsgs.GlobalDescriptor(i, 1, _unit(rng, 512)) for i in range(8)]
    float_wire = tmsgs.GlobalDescriptors(descriptors=descs).to_bytes()
    q_wire = tmsgs.GlobalDescriptors(descriptors=descs,
                                     quantization="int8").to_bytes()
    assert len(q_wire) < 0.30 * len(float_wire)
    out = tmsgs.GlobalDescriptors.from_bytes(q_wire)
    ref = jmsgs.GlobalDescriptors.from_bytes(q_wire)
    assert out.quantization == "int8" and len(out.descriptors) == 8
    for orig, dec, jdec in zip(descs, out.descriptors, ref.descriptors):
        x = orig.descriptor
        step = float(x.max() - x.min()) / 255.0
        np.testing.assert_allclose(dec.descriptor, x, atol=step / 2 + 1e-7)
        np.testing.assert_array_equal(dec.descriptor, jdec.descriptor)
        cos = float(x @ dec.descriptor /
                    (np.linalg.norm(x) * np.linalg.norm(dec.descriptor)))
        assert cos > 0.9999
    out_f = tmsgs.GlobalDescriptors.from_bytes(float_wire)
    assert out_f.quantization == "none"
    np.testing.assert_array_equal(out_f.descriptors[3].descriptor,
                                  descs[3].descriptor)


def _bus_scenario(b):
    router = b.InProcessRouter()
    bus0 = b.InProcessBus(router, 0)
    bus1 = b.InProcessBus(router, 1)
    got = []
    bus1.subscribe("cslam/keyframe_data", got.append)
    bus0.subscribe("/r1/cslam/keyframe_data", lambda m: got.append(("x", m)))
    bus0.subscribe("/cslam/*", lambda m: got.append(("any", m)))
    bus1.publish("cslam/keyframe_data", "hello")
    bus0.publish("cslam/keyframe_data", "not-for-r1")
    bus1.create_publisher("/cslam/global_descriptors").publish("swarm")
    router.spin_until_idle()
    return got, router.delivered_count, bus1.resolve("a/b")


def test_bus_namespacing_and_delivery():
    got, delivered, resolved = _bus_scenario(tbus)
    assert (got, delivered, resolved) == _bus_scenario(jbus)
    assert "hello" in got and ("x", "hello") in got
    assert "not-for-r1" not in got and ("any", "swarm") in got
    assert resolved == "/r1/a/b"


def test_clocks():
    clock = tbus.ManualClock(3.0)
    clock.advance(1.5)
    assert clock.now() == 4.5
    assert abs(tbus.WallClock().now() - time.time()) < 5.0


def _monitor_scenario(b, mon_mod, m):
    router = b.InProcessRouter()
    clock = b.ManualClock()
    bus = b.InProcessBus(router, 0)
    mon = mon_mod.NeighborMonitor(bus, clock, 1, True, init_delay_sec=1.0,
                                  max_delay_sec=2.0)
    seen = [mon.is_alive()]
    bus.publish("/r1/cslam/heartbeat", m.Heartbeat(1))
    router.spin_until_idle()
    seen.append(mon.is_alive())
    clock.advance(1.5)
    bus.publish("/r1/cslam/heartbeat", m.Heartbeat(1))
    router.spin_until_idle()
    seen.append(mon.is_alive())
    clock.advance(5.0)
    seen.append(mon.is_alive())
    off = mon_mod.NeighborMonitor(b.InProcessBus(router, 0), clock, 1,
                                  False, 1.0, 2.0)
    seen.append(off.is_alive())
    return seen


def test_neighbor_monitor_liveness_window():
    seen = _monitor_scenario(tbus, tmon, tmsgs)
    assert seen == _monitor_scenario(jbus, jmon, jmsgs)
    # no heartbeat, init delay, alive, timed out; disabled is alive
    assert seen == [False, False, True, False, True]


def _manager_params(robot_id=0, max_nb_robots=3, monitoring=True):
    return {
        "robot_id": robot_id,
        "max_nb_robots": max_nb_robots,
        "neighbor_management.enable_neighbor_monitoring": monitoring,
        "neighbor_management.init_delay_sec": 1.0,
        "neighbor_management.max_heartbeat_delay_sec": 2.0,
    }


def _election_scenario(b, nm, m):
    router = b.InProcessRouter()
    clock = b.ManualClock()
    managers = {rid: nm.NeighborManager(b.InProcessBus(router, rid), clock,
                                        _manager_params(rid, 3))
                for rid in range(3)}
    answers = []
    router.subscribe("/r0/cslam/current_neighbors",
                     lambda msg: answers.append((msg.ids, msg.origins)))

    def beat(rids):
        for rid in rids:
            b.InProcessBus(router, rid).publish("cslam/heartbeat",
                                                m.Heartbeat(rid))
        router.spin_until_idle()

    def brokers():
        return [managers[r].local_robot_is_broker() for r in range(3)]

    seen = []
    beat(range(3))
    clock.advance(1.5)
    beat(range(3))
    seen.append(brokers())
    b.InProcessBus(router, 0).publish("cslam/get_current_neighbors", b"")
    router.spin_until_idle()
    clock.advance(3.0)        # robot 0 dies
    beat((1, 2))
    seen.append(brokers())
    seen.append(managers[1].check_neighbors_in_range())
    return seen, answers


def test_broker_election_lowest_alive():
    seen, answers = _election_scenario(tbus, tnm, tmsgs)
    assert (seen, answers) == _election_scenario(jbus, jnm, jmsgs)
    assert seen[0] == [True, False, False]
    assert seen[1][1:] == [True, False]
    assert answers == [([1, 2], [1, 2])]


def _watermark_scenario(b, nm, m):
    router = b.InProcessRouter()
    mgr = nm.NeighborManager(b.InProcessBus(router, 0), b.ManualClock(),
                             _manager_params(0, 3, monitoring=False))
    out = [mgr.select_from_which_kf_to_send(4),
           mgr.select_from_which_kf_to_send(9),
           mgr.useless_descriptors(9),
           mgr.select_from_which_match_to_send(3),
           mgr.select_from_which_match_to_send(7),
           mgr.useless_matches(7)]
    descs = [m.GlobalDescriptor(i, 1, np.zeros(2, np.float32))
             for i in range(6)]
    mgr.update_received_kf_id(1, 2)
    out.append(mgr.get_unknown_range(descs))
    out.append(mgr.neighbors_monitors[1].last_keyframe_received)
    out.append(mgr.get_unknown_range(descs[:4]))
    return out


def test_gossip_watermarks():
    out = _watermark_scenario(tbus, tnm, tmsgs)
    assert out == _watermark_scenario(jbus, jnm, jmsgs)
    assert out[:3] == [0, 5, 9] and out[6:] == [[3, 4, 5], 5, []]


def _rendezvous_scenario(b, rdv, tmp_path):
    sched = tmp_path / "sched.csv"
    sched.write_text("0,0.0,10.0,20.0,30.0\n1,5.0,15.0\n")
    clock = b.ManualClock()
    rv0 = rdv.SimulatedRendezVous(clock, str(sched), 0)
    rv1 = rdv.SimulatedRendezVous(clock, str(sched), 1)
    off = rdv.SimulatedRendezVous(clock, str(sched), 1, enabled=False)
    bad = rdv.SimulatedRendezVous(clock, str(tmp_path / "none.csv"), 0)
    seen = []
    for dt in (0.0, 7.0, 5.0, 13.0):
        clock.advance(dt)
        seen.append((rv0.is_alive(), rv1.is_alive(), off.is_alive(),
                     bad.is_alive()))
    return seen


def test_simulated_rendezvous(tmp_path):
    seen = _rendezvous_scenario(tbus, trdv, tmp_path)
    assert seen == _rendezvous_scenario(jbus, jrdv, tmp_path)
    assert seen == [(True, False, True, True), (True, True, True, True),
                    (False, True, True, True), (True, False, True, True)]


def _broker_params(robot_id, max_nb_robots):
    return {
        "robot_id": robot_id,
        "max_nb_robots": max_nb_robots,
        "frontend.similarity_threshold": 0.0,
        "frontend.sensor_type": "stereo",
        "frontend.enable_sparsification": True,
        "frontend.nb_best_matches": 10,
        "frontend.intra_loop_min_inbetween_keyframes": 10,
        "evaluation.enable_sparsification_comparison": False,
    }


@pytest.mark.parametrize("use_vertex_cover", [True, False])
@pytest.mark.parametrize("max_nb_robots,robot_id", [(2, 0), (3, 1), (5, 2)])
def test_broker_same_covers_as_reference(max_nb_robots, robot_id,
                                         use_vertex_cover):
    """test_broker.py's random graphs: the reference's MAC selection of
    10, 20 and 40 of 20 candidates, brokered by both packages. The covers
    are the same sets in the same component order (the random "simple
    dialog" draws from np.random, seeded alike before each call)."""
    rng = np.random.default_rng(17)
    for budget in (10, 20, 40):
        fixed, cand = build_multi_robot_graph(30, 20, max_nb_robots, rng)
        lcsm = JaxLCSM(_broker_params(robot_id, max_nb_robots))
        lcsm.candidate_selector.set_graph(fixed, cand)
        selection = lcsm.select_candidates(
            budget, {i: True for i in range(max_nb_robots)},
            greedy_initialization=False)
        assert len(selection) == min(20, budget)
        robots = list(range(max_nb_robots))
        np.random.seed(budget)
        ref = jbroker.Broker(selection, robots).brokerage(use_vertex_cover)
        np.random.seed(budget)
        port = tbroker.Broker([TEdge(*tuple(e)) for e in selection],
                              robots).brokerage(use_vertex_cover)
        assert port == ref
        vertices = [v for c in port for v in c]
        assert 1 <= len(vertices) == len(set(vertices)) <= len(selection)
        for e in selection:
            assert (e.robot0_id, e.robot0_keyframe_id) in vertices or \
                (e.robot1_id, e.robot1_keyframe_id) in vertices


def test_manual_vertex_cover():
    """Star around (0, 1) plus one extra edge: two components, one
    vertex each (reference test_manual_vertex_cover); one robot: none."""
    edges = [TEdge(0, 1, 1, k, 1.0) for k in range(1, 5)] + \
        [TEdge(0, 2, 1, 5, 1.0)]
    covers = tbroker.Broker(edges, range(2)).brokerage(True)
    assert covers == jbroker.Broker(edges, range(2)).brokerage(True)
    assert len(covers) == 2 and sum(len(c) for c in covers) == 2
    assert tbroker.Broker([TEdge(0, 1, 0, 5, 1.0)], [0]).brokerage(
        True) == []


def _trace_events(tracing, path):
    tr = tracing.Tracer(capacity=8)
    tr.enable(path, pid_label="r0")
    with tr.span("outer", robot=0):
        with tr.span("inner"):
            time.sleep(0.002)
    tr.instant("marker", kind="msg")
    tr.counter("queue_depth", depth=3)
    for _ in range(6):
        with tr.span("s"):
            pass
    doc = json.loads(open(tr.dump()).read())
    return tr, doc


def test_tracer_matches_reference(tmp_path):
    """Same calls, same Chrome-trace document up to times and ids; the
    ring drops the oldest events and counts each dropped event once (the
    reference counts a dropped span twice and a dropped instant or
    counter not at all); a disabled tracer records nothing."""
    from cslam_tpu.runtime import tracing as jtracing
    tr, doc = _trace_events(ttracing, str(tmp_path / "t.json"))
    _, ref = _trace_events(jtracing, str(tmp_path / "j.json"))

    def shape(d):
        return [(e["name"], e["ph"], e.get("args")) for e in d["traceEvents"]]

    assert shape(doc) == shape(ref)
    # 10 events into a ring of 8
    assert doc["otherData"]["n_dropped"] == 2
    assert ref["otherData"]["n_dropped"] > 0
    assert len(tr._events) == 8
    off = ttracing.Tracer()
    with off.span("x"):
        pass
    off.instant("i")
    off.counter("c", v=1)
    assert len(off._events) == 0


def test_tracer_nesting_and_threads(tmp_path):
    tr = ttracing.Tracer()
    tr.enable(str(tmp_path / "t.json"))
    with tr.span("outer"):
        with tr.span("inner"):
            time.sleep(0.002)
    spans = {e["name"]: e for e in tr._events}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1.0
    assert i["dur"] >= 2000
    barrier = threading.Barrier(3)

    def work():
        with tr.span("w"):
            barrier.wait(timeout=10)

    ts = [threading.Thread(target=work) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({e["tid"] for e in tr._events if e["name"] == "w"}) == 3


def test_tracer_enabled_by_environment(tmp_path):
    """CSLAM_TRACE=path enables the process-wide tracer at import and the
    trace is written at exit."""
    path = tmp_path / "env.json"
    code = ("from cslam_tpu_torch.runtime.tracing import tracer, span\n"
            "assert tracer.enabled\n"
            "with span('stage', robot=1):\n"
            "    pass\n")
    env = dict(os.environ, CSLAM_TRACE=str(path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names == ["stage"]


def test_config_keys_and_defaults_match_reference():
    assert tconfig.default_params() == jconfig.default_params()
    over = tconfig.default_params(robot_id=3, **{"frontend.nns_method":
                                                 "exact"})
    assert over == jconfig.default_params(robot_id=3, **{
        "frontend.nns_method": "exact"})
    flat = dict(over, **{"frontend.netvlad.pca_checkpoint": "p.pkl",
                         "unknown.key": 1})
    a = tconfig.SwarmConfig.from_flat_dict(flat)
    b = jconfig.SwarmConfig.from_flat_dict(flat)
    assert a.to_flat_dict() == b.to_flat_dict()
    assert a.frontend.netvlad_pca_checkpoint == "p.pkl"


def test_config_yaml_loads_like_reference(tmp_path):
    pytest.importorskip("yaml")
    example = os.path.join(REPO, "config", "example.yaml")
    cfg = tconfig.SwarmConfig.from_yaml(example, robot_id=2)
    assert cfg.to_flat_dict() == jconfig.SwarmConfig.from_yaml(
        example, robot_id=2).to_flat_dict()
    assert cfg.robot_id == 2 and cfg.frontend.nns_method == "auto"
    p = tmp_path / "ref.yaml"
    p.write_text("""
/**:
  ros__parameters:
    frontend:
      left_image_topic: "stereo_camera/left/image_rect_color"
      sensor_type: "rgbd"
      similarity_threshold: 0.1
      netvlad:
        pca_checkpoint: "models/pca.pkl"
    backend:
      max_waiting_time_sec: 60
""")
    cfg = tconfig.SwarmConfig.from_yaml(str(p))
    assert cfg.to_flat_dict() == jconfig.SwarmConfig.from_yaml(
        str(p)).to_flat_dict()
    assert cfg.frontend.netvlad_pca_checkpoint == "models/pca.pkl"


def test_misc_helpers_match_reference():
    d = {i: i * 10 for i in range(7)}
    for args in ((d, 2, 2), (d, -5, 3), (d, 9, 2), ({}, 0, 4)):
        assert tmisc.dict_to_list_chunks(*args) == \
            jmisc.dict_to_list_chunks(*args)
    assert tmisc.dict_to_list_chunks(d, 2, 2) == [[20, 30], [40, 50], [60]]
    for v in (-1, 0, 2, 5):
        assert tmisc.clamp(v, 0, 3) == jmisc.clamp(v, 0, 3)
