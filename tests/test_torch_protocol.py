"""Port parity, the protocol's stateful parts: the C++ optimizer state
machine behind both packages' bindings, DecentralizedPGO's election /
collection / aggregation / solve / estimate sharing, and loop-closure
detection through serialized (optionally int8) gossip — the same
seeded inputs through cslam_tpu and cslam_tpu_torch (device="cpu").

Tolerances: states, counts, keys and matches exact; optimized poses
POSE_TOL = 1e-3 (the port's PGO parity bound, tests/test_torch_pgo.py);
descriptor similarities SIM_TOL = 1e-5; logged graph errors 1e-4 relative
(sums of squared residuals of poses that agree within POSE_TOL).
"""

import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cslam_tpu.backend import decentralized_pgo as jdpgo
from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.comm import neighbors_manager as jnm
from cslam_tpu.frontend import loop_closure_detection as jlcd
from cslam_tpu.runtime.native import NativeStateMachine as JaxSM
from cslam_tpu_torch.backend import decentralized_pgo as tdpgo
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.comm import neighbors_manager as tnm
from cslam_tpu_torch.frontend import loop_closure_detection as tlcd
from cslam_tpu_torch.runtime import native as tnative

import test_decentralized_pgo as ref_dpgo

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = 1e-3
SIM_TOL = 1e-5

JAX = SimpleNamespace(bus=jbus, msgs=jmsgs, nm=jnm, dpgo=jdpgo, pgo=jpgo,
                      lcd=jlcd, kw={})
PORT = SimpleNamespace(bus=tbus, msgs=tmsgs, nm=tnm, dpgo=tdpgo, pgo=tpgo,
                       lcd=tlcd, kw={"device": "cpu"})


# ----------------------------------------------------------------------
# the C++ state machine through both bindings
# ----------------------------------------------------------------------

SM_SEQUENCES = {
    "optimizer_round": [
        ("set_has_odometry", True), ("start_waiting", 0.0),
        ("on_neighbors", [1, 2], [1, 2]), ("on_collection_tick", 0.5),
        ("on_pose_graph", 1), ("on_pose_graph", 1), ("on_pose_graph", 2),
        ("on_optimization_started",), ("on_optimization_done",)],
    "not_optimizer_and_broker": [
        ("set_has_odometry", True), ("set_origin", 1),
        ("on_neighbors", [0], [0]), ("is_broker", [0, 3]),
        ("is_broker", [4]), ("set_neighbors", [3], [1])],
    "no_odometry_never_optimizes": [
        ("on_neighbors", [], []), ("set_has_odometry", True),
        ("on_neighbors", [], []), ("on_collection_tick", 1.0)],
    "waiting_timeout": [
        ("set_has_odometry", True), ("set_max_waiting", 2.0),
        ("on_neighbors", [3], [3]), ("on_collection_tick", 1.0),
        ("check_timeout", 2.5), ("check_timeout", 3.5),
        ("start_waiting", 4.0), ("end_waiting",), ("check_timeout", 9.0)],
    "forced_states": [
        ("force", 2), ("on_pose_graph", 1), ("force", 3),
        ("on_neighbors", [1], [1]), ("force", 3), ("on_pose_graph", 1)],
}


def _run_sm(cls, events):
    sm = cls(1, 60.0)
    trace = []
    for name, *args in events:
        out = getattr(sm, name)(*args)
        trace.append((name, out, sm.state, sm.is_waiting(),
                      sm.is_optimizer()))
    sm.close()
    return trace


@pytest.mark.parametrize("sequence", sorted(SM_SEQUENCES))
def test_state_machine_matches_reference_binding(sequence):
    events = SM_SEQUENCES[sequence]
    trace = _run_sm(tnative.NativeStateMachine, events)
    assert trace == _run_sm(JaxSM, events)


def test_importing_the_binding_builds_nothing():
    """Import compiles nothing and runs no process: the subprocess test
    over every module imports it too."""
    code = ("import subprocess\n"
            "def boom(*a, **k):\n"
            "    raise AssertionError('a process was started')\n"
            "subprocess.run = subprocess.Popen = boom\n"
            "import cslam_tpu_torch.runtime.native as n\n"
            "import cslam_tpu_torch.node\n"
            "assert not n._libs\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_concurrent_builds_land_one_library(tmp_path, monkeypatch):
    """Threads building at once into an empty build directory each write
    their own temporary file and rename it into place; no temporary is
    left."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def work():
        try:
            paths.append(tnative.build())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        [paths[0].name]
    assert paths[0].name.startswith("libcslam_state_")


# ----------------------------------------------------------------------
# DecentralizedPGO: the reference's seven scenarios on both packages
# ----------------------------------------------------------------------


class Swarm:
    """test_decentralized_pgo.Swarm for package `P`, on given ground
    truth."""

    def __init__(self, P, gt):
        self.P = P
        self.router = P.bus.InProcessRouter()
        self.clock = P.bus.ManualClock()
        self.n_robots = len(gt)
        self.gt = dict(gt)
        self.backends, self.buses, self.managers = {}, {}, {}
        cfg = P.pgo.PGOConfig(lm_max_iters=15, cg_max_iters=60,
                              gnc_max_outer_iters=5)
        for rid in range(self.n_robots):
            bus = P.bus.InProcessBus(self.router, rid)
            params = ref_dpgo.make_params(rid, self.n_robots)
            self.buses[rid] = bus
            self.managers[rid] = P.nm.NeighborManager(bus, self.clock,
                                                      params)
            self.backends[rid] = P.dpgo.DecentralizedPGO(
                params, bus, self.clock, pgo_config=cfg, **P.kw)

    def feed_odometry(self, noise=None):
        for rid in range(self.n_robots):
            Rs, ts = self.gt[rid]
            for k in range(len(ts)):
                t = ts[k] if noise is None or k == 0 else \
                    ts[k] + noise[rid][k]
                self.buses[rid].publish(
                    "cslam/keyframe_odom",
                    self.P.msgs.KeyframeOdom(id=k, pose=(Rs[k], t)))
        self.router.spin_until_idle()

    def add_inter_loop_closure(self, r0, k0, r1, k1):
        Rs0, ts0 = self.gt[r0]
        Rs1, ts1 = self.gt[r1]
        self.router.publish(
            "/cslam/inter_robot_loop_closure",
            self.P.msgs.InterRobotLoopClosure(
                robot0_id=r0, robot0_keyframe_id=k0, robot1_id=r1,
                robot1_keyframe_id=k1, success=True,
                pose=(Rs0[k0].T @ Rs1[k1], Rs0[k0].T @ (ts1[k1] - ts0[k0]))))
        self.router.spin_until_idle()

    def tick(self, rounds=30, min_total=1):
        OPT = self.P.dpgo.OptimizerState.OPTIMIZATION
        for _ in range(rounds):
            for be in self.backends.values():
                be.optimization_callback()
            self.router.spin_until_idle()
            for be in self.backends.values():
                be.optimization_loop_callback()
            self.router.spin_until_idle()
            for be in self.backends.values():
                if be.optimizer_state == OPT:
                    if be._optimization_future is not None:
                        be._optimization_future.result(timeout=120)
                    be.check_result_and_finish_optimization()
            self.router.spin_until_idle()
            if any(be.optimization_count >= min_total
                   for be in self.backends.values()):
                for be in self.backends.values():
                    be.optimization_loop_callback()
                self.router.spin_until_idle()
                return
        raise AssertionError("no optimization completed")

    def observe(self):
        """Counts, states and every robot's adopted estimates."""
        out = {}
        for rid, be in self.backends.items():
            est = be.current_pose_estimates
            keys = sorted(est)
            out[rid] = {
                "count": be.optimization_count,
                "state": int(be.optimizer_state),
                "origin": be.origin_robot_id,
                "keys": keys,
                "R": np.stack([est[k][0] for k in keys]) if keys else None,
                "t": np.stack([est[k][1] for k in keys]) if keys else None,
            }
        return out

    def close(self):
        for be in self.backends.values():
            if hasattr(be, "close"):
                be.close()


def _gt(seed, n_robots, n_poses=8):
    rng = np.random.default_rng(seed)
    return {rid: ref_dpgo.trajectory(rng, n_poses, [5.0 * rid, 0, 0])
            for rid in range(n_robots)}


def _noise(seed, gt):
    rng = np.random.default_rng(seed)
    out = {}
    for rid, (_, ts) in gt.items():
        out[rid] = {k: rng.standard_normal(3).astype(np.float32) * 0.05
                    for k in range(1, len(ts))}
    return out


def _extend(gt, seed, n_new=3):
    """Three more keyframes per robot (the warm-start scenario's
    extension) and their noisy odometry."""
    rng = np.random.default_rng(seed)
    new_gt, odo = {}, {}
    for rid in sorted(gt):
        Rs, ts = gt[rid]
        R, t = Rs[-1].copy(), ts[-1].copy()
        odo[rid] = []
        for k in range(len(ts), len(ts) + n_new):
            xi = rng.standard_normal(6).astype(np.float32)
            xi[:3] *= 0.05
            xi[3:] *= 0.4
            dR, dt = ref_dpgo._exp(xi)
            t = R @ dt + t
            R = R @ dR
            Rs = np.concatenate([Rs, R[None]])
            ts = np.concatenate([ts, t[None]])
            odo[rid].append((k, R, t + rng.standard_normal(3).astype(
                np.float32) * 0.05))
        new_gt[rid] = (Rs, ts)
    return new_gt, odo


def _scenario(P, name):
    """One scenario of tests/test_decentralized_pgo.py on package P."""
    if name == "single_robot":
        s = Swarm(P, _gt(0, 1))
        s.feed_odometry()
        s.tick()
    elif name == "two_robot_election":
        s = Swarm(P, _gt(1, 2))
        s.feed_odometry()
        s.add_inter_loop_closure(0, 3, 1, 3)
        s.tick()
    elif name == "three_robot_chain":
        s = Swarm(P, _gt(2, 3))
        s.feed_odometry()
        s.add_inter_loop_closure(0, 2, 1, 2)
        s.add_inter_loop_closure(1, 5, 2, 5)
        s.tick()
    elif name == "noisy_odometry":
        gt = _gt(3, 2)
        s = Swarm(P, gt)
        s.feed_odometry(_noise(4, gt))
        for k in (1, 3, 5, 7):
            s.add_inter_loop_closure(0, k, 1, k)
        s.tick()
    elif name == "waiting_timeout":
        s = Swarm(P, _gt(5, 2))
        s.feed_odometry()
        be = s.backends[0]
        be.max_waiting_time_sec = 1.0
        be.optimizer_state = P.dpgo.OptimizerState.POSEGRAPH_COLLECTION
        be.current_neighbors = P.msgs.RobotIdsAndOrigin(ids=[1],
                                                        origins=[1])
        be.start_waiting()
        waiting = int(be.optimizer_state)
        s.clock.advance(2.0)
        be.optimization_loop_callback()
        obs = s.observe()
        obs["waiting"] = waiting
        s.close()
        return obs
    elif name == "warm_start_mechanics":
        s = Swarm(P, _gt(7, 1, n_poses=6))
        s.feed_odometry()
        be = s.backends[0]
        fg = be.aggregate_pose_graphs()
        be.last_optimized_values = {
            (0, k): (fg.R[fg.key_to_index[(0, k)]].copy(),
                     fg.t[fg.key_to_index[(0, k)]] +
                     np.float32([0.5, -0.2, 0.1])) for k in range(4)}
        be._apply_warm_start(fg)
        obs = {"keys": list(fg.keys), "R": np.stack(fg.R),
               "t": np.stack(fg.t)}
        s.close()
        return obs
    elif name.startswith("warm_start_second_round"):
        gt = _gt(11, 2)
        s = Swarm(P, gt)
        for be in s.backends.values():
            be.params["backend.warm_start_optimization"] = \
                name.endswith("warm")
        s.feed_odometry(_noise(12, gt))
        for k in (1, 4, 7):
            s.add_inter_loop_closure(0, k, 1, k)
        s.tick()
        first = s.observe()
        s.gt, odo = _extend(gt, 13)
        for rid, rows in odo.items():
            for k, R, t in rows:
                s.buses[rid].publish("cslam/keyframe_odom",
                                     P.msgs.KeyframeOdom(id=k, pose=(R, t)))
        s.router.spin_until_idle()
        s.add_inter_loop_closure(0, 9, 1, 9)
        s.tick(min_total=2)
        obs = s.observe()
        obs["first"] = first
        obs["gt"] = s.gt
        s.close()
        return obs
    else:
        raise ValueError(name)
    obs = s.observe()
    obs["gt"] = s.gt
    s.close()
    return obs


def _same_estimates(port, ref):
    for rid in sorted(k for k in ref if isinstance(k, int)):
        a, b = port[rid], ref[rid]
        for key in ("count", "state", "origin", "keys"):
            assert a[key] == b[key], (rid, key, a[key], b[key])
        if b["t"] is not None:
            np.testing.assert_allclose(a["R"], b["R"], atol=POSE_TOL)
            np.testing.assert_allclose(a["t"], b["t"], atol=POSE_TOL)


def _mean_error(obs, rid, n):
    est = dict(zip(obs[rid]["keys"], obs[rid]["t"]))
    ts = obs["gt"][rid][1]
    return float(np.mean([np.linalg.norm(est[(rid, k)] - ts[k])
                          for k in range(n)]))


SCENARIOS = ["single_robot", "two_robot_election", "three_robot_chain",
             "noisy_odometry", "waiting_timeout", "warm_start_mechanics",
             "warm_start_second_round"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_decentralized_pgo_matches_reference(name):
    """Each scenario on both packages: the same optimizer, counts,
    states, estimate keys, and estimates within POSE_TOL; then the
    reference test's own assertions on the port."""
    if name == "warm_start_second_round":
        port = {w: _scenario(PORT, f"{name}_{w}") for w in ("warm", "cold")}
        ref = {w: _scenario(JAX, f"{name}_{w}") for w in ("warm", "cold")}
        for w in ("warm", "cold"):
            _same_estimates(port[w]["first"], ref[w]["first"])
            _same_estimates(port[w], ref[w])
            assert port[w][0]["count"] == 2
        err = {w: _mean_error(port[w], 1, 11) for w in port}
        assert err["warm"] < 0.2, err
        assert err["warm"] <= err["cold"] + 0.05, err
        return
    port, ref = _scenario(PORT, name), _scenario(JAX, name)
    if name == "warm_start_mechanics":
        assert port["keys"] == ref["keys"]
        np.testing.assert_allclose(port["R"], ref["R"], atol=1e-6)
        np.testing.assert_allclose(port["t"], ref["t"], atol=1e-6)
        return
    _same_estimates(port, ref)
    if name == "single_robot":
        assert port[0]["count"] == 1 and len(port[0]["keys"]) == 8
    elif name == "two_robot_election":
        assert [port[r]["count"] for r in (0, 1)] == [1, 0]
        est = dict(zip(port[1]["keys"], port[1]["t"]))
        for k in range(8):
            np.testing.assert_allclose(est[(1, k)], port["gt"][1][1][k],
                                       atol=0.15)
    elif name == "three_robot_chain":
        assert port[0]["count"] == 1
        for rid in range(3):
            assert len([k for k in port[rid]["keys"] if k[0] == rid]) == 8
    elif name == "noisy_odometry":
        assert _mean_error(port, 1, 8) < 0.2
    elif name == "waiting_timeout":
        assert port["waiting"] == \
            tdpgo.OptimizerState.WAITING_FOR_NEIGHBORS_POSEGRAPHS
        assert port[0]["state"] == tdpgo.OptimizerState.IDLE


class _Logger:
    """Records every log_info call; accepts the other logger hooks."""

    def __init__(self):
        self.info = {}

    def log_info(self, key, value):
        self.info[key] = value

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _logged_solve(P):
    gt = _gt(3, 2)
    s = Swarm(P, gt)
    loggers = {}
    for rid, be in s.backends.items():
        be.logger = loggers[rid] = _Logger()
    s.feed_odometry(_noise(4, gt))
    for k in (1, 3, 5, 7):
        s.add_inter_loop_closure(0, k, 1, k)
    s.tick()
    s.close()
    return loggers[0].info


def test_decentralized_pgo_logs_graph_errors_like_reference():
    """With a logger, the optimizer logs the solved graph's total and
    loop-closure errors (the reference Logger's CSV fields)."""
    port, ref = _logged_solve(PORT), _logged_solve(JAX)
    assert set(port) == set(ref)
    assert port["nb_loop_closures"] == ref["nb_loop_closures"] == 4
    for key in ("total_graph_error", "max_loop_closure_error",
                "mean_loop_closure_error"):
        assert port[key] == pytest.approx(ref[key], rel=1e-4, abs=1e-6), key


def test_decentralized_pgo_defaults_to_the_card_and_closes(monkeypatch):
    """Without device= the back-end wants the card; close() stops its
    worker thread."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    router = tbus.InProcessRouter()
    params = ref_dpgo.make_params(0, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdpgo.DecentralizedPGO(params, tbus.InProcessBus(router, 0),
                               tbus.ManualClock())
    be = tdpgo.DecentralizedPGO(params, tbus.InProcessBus(router, 0),
                                tbus.ManualClock(), device="cpu")
    be._executor.submit(lambda: None).result(timeout=10)
    workers = list(be._executor._threads)
    assert workers
    be.close()
    assert not any(t.is_alive() for t in workers)
    with pytest.raises(NotImplementedError, match="g2o"):
        be.write_current_estimates_callback("out.g2o")


# ----------------------------------------------------------------------
# detection through serialized gossip (test_quantized_gossip.py)
# ----------------------------------------------------------------------


def _unit(rng, d=512):
    v = rng.standard_normal(d).astype(np.float32)
    return v / np.linalg.norm(v)


def _gossip_params(robot_id, quant):
    return {
        "robot_id": robot_id,
        "max_nb_robots": 2,
        "frontend.similarity_threshold": 0.8,
        "frontend.global_descriptor_technique": "cosplace",
        "frontend.nn_checkpoint": "disable",
        "frontend.nb_best_matches": 5,
        "frontend.intra_loop_min_inbetween_keyframes": 2,
        "frontend.enable_intra_robot_loop_closures": False,
        "frontend.detection_publication_max_elems_per_msg": 10,
        "frontend.gossip_descriptor_quantization": quant,
        "frontend.enable_sparsification": True,
        "frontend.inter_robot_loop_closure_budget": 5,
        "frontend.use_vertex_cover_selection": True,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
    }


class _NoModel:
    """The test adds descriptors directly: no model is needed."""


def _detectors(P, quant):
    rng = np.random.default_rng(7)
    place = _unit(rng)
    views = {
        0: {0: _unit(rng), 1: _unit(rng), 2: place},
        1: {0: _unit(rng), 1: _unit(rng),
            2: (place + 0.05 * _unit(rng)) /
               np.linalg.norm(place + 0.05 * _unit(rng))},
    }
    router = P.bus.InProcessRouter()
    clock = P.bus.ManualClock()
    model = {} if P is JAX else {"descriptor_model": _NoModel(), **P.kw}
    dets = [P.lcd.GlobalDescriptorLoopClosureDetection(
        _gossip_params(r, quant), P.bus.InProcessBus(router, r), clock,
        **model) for r in (0, 1)]
    for r in (0, 1):
        for kf, d in views[r].items():
            dets[r].add_global_descriptor_to_map(d, kf)
    sent = []
    dets[1].global_descriptor_publisher.publish = sent.append
    dets[1].global_descriptors_timer_callback()
    assert len(sent) == 1
    return dets, sent[0].to_bytes(), views


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_detection_parity_through_serialized_gossip(quant):
    """Robot 1 gossips (optionally int8); each package's robot 0 decodes
    the OTHER package's wire bytes and finds the same match with the
    same weight; the wire bytes and comm accounting are identical."""
    tdets, twire, views = _detectors(PORT, quant)
    jdets, jwire, _ = _detectors(JAX, quant)
    assert twire == jwire
    assert tdets[1].log_detection_cumulative_communication == \
        jdets[1].log_detection_cumulative_communication == \
        (3 * (512 + 16) if quant == "int8" else 3 * 512 * 4)
    tdets[0].global_descriptor_callback(
        tmsgs.GlobalDescriptors.from_bytes(jwire))
    jdets[0].global_descriptor_callback(
        jmsgs.GlobalDescriptors.from_bytes(twire))
    tm = list(tdets[0].inter_robot_matches_buffer.values())
    jm = list(jdets[0].inter_robot_matches_buffer.values())
    assert [tuple(m)[:4] for m in tm] == [tuple(m)[:4] for m in jm]
    assert len(tm) == 1
    assert {(tm[0].robot0_id, tm[0].robot0_keyframe_id),
            (tm[0].robot1_id, tm[0].robot1_keyframe_id)} == {(0, 2), (1, 2)}
    assert tm[0].weight == pytest.approx(jm[0].weight, abs=SIM_TOL)
    assert tm[0].weight == pytest.approx(float(views[0][2] @ views[1][2]),
                                         abs=2e-3)


def test_detection_without_a_model_is_not_ported():
    """Without a descriptor_model the detector builds its model from
    params on its own device: the Scan Context model for the lidar
    technique (ported with the lidar slice; it raised before), CosPlace
    otherwise (here disabled: random descriptors)."""
    from cslam_tpu_torch.frontend.lidar_handler import ScanContextModel
    from cslam_tpu_torch.models.cosplace import CosPlace
    router = tbus.InProcessRouter()
    params = dict(_gossip_params(0, "none"),
                  **{"frontend.global_descriptor_technique": "scancontext"})
    det = tlcd.GlobalDescriptorLoopClosureDetection(
        params, tbus.InProcessBus(router, 0), tbus.ManualClock(),
        device="cpu")
    assert isinstance(det.global_descriptor, ScanContextModel)
    assert det.global_descriptor.device == torch.device("cpu")
    det = tlcd.GlobalDescriptorLoopClosureDetection(
        _gossip_params(0, "none"), tbus.InProcessBus(router, 0),
        tbus.ManualClock(), device="cpu")
    assert isinstance(det.global_descriptor, CosPlace)
    assert not det.global_descriptor.enabled
    assert det.global_descriptor.device == torch.device("cpu")
