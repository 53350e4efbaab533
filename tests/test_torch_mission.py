"""Port parity, the whole swarm: the sim missions of test_e2e_swarm.py
and test_elastic_swarm.py through SwarmNode on both packages — synthetic
world -> descriptors -> gossip -> kNN matching -> MAC budgeted selection
-> brokerage -> verification -> decentralized GNC-LM PGO — in-process
over the bus, the port on the CPU.

Both runs must give the same candidates (weights within SIM_TOL), the
same selected candidates per detection round, the same fixed edges,
messages and optimization counts; each robot's ATE and every adopted
pose estimate agree within ATE_TOL = 1e-3, the slice test's bound
(tests/test_torch_slice.py). These missions' MAC runs take the
warm-LOBPCG path (P <= 2048); its selections are held to the
reference's sets here, and they agree at these sizes. Where that path's
selection can differ (a one-ulp weight change moves the reference's own
selection, PERF.md), the port is held to the reference's quality
contracts instead (tests/test_torch_mac.py); the map-scale comparison
below is marked slow and reports its spread.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cslam_tpu.backend import decentralized_pgo as jdpgo
from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.comm import rendezvous as jrdv
from cslam_tpu.frontend import sim as jsim
from cslam_tpu import node as jnode
from cslam_tpu.utils.evaluation import ate_rmse
from cslam_tpu_torch.backend import decentralized_pgo as tdpgo
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.comm import rendezvous as trdv
from cslam_tpu_torch.frontend import sim as tsim
from cslam_tpu_torch import node as tnode
from cslam_tpu_torch import sim_mission
from cslam_tpu_torch.runtime import tracing as ttracing

from test_e2e_swarm import make_params

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

ATE_TOL = 1e-3
SIM_TOL = 1e-5

JAX = SimpleNamespace(bus=jbus, msgs=jmsgs, rdv=jrdv, dpgo=jdpgo, pgo=jpgo,
                      sim=jsim, node=jnode, kw={})
PORT = SimpleNamespace(bus=tbus, msgs=tmsgs, rdv=trdv, dpgo=tdpgo, pgo=tpgo,
                       sim=tsim, node=tnode, kw={"device": "cpu"})


class _SimDescriptorModel:
    def __init__(self, world, rid):
        self.world = world
        self.rid = rid

    def compute_embedding(self, kf_id):
        return self.world.descriptor(self.rid, kf_id)


def build_swarm(P, n_robots, n_poses, seed=0, drift=0.02, budget=5,
                cfg=None, param_fn=None):
    """test_e2e_swarm.build_swarm for package P."""
    router = P.bus.InProcessRouter()
    clock = P.bus.ManualClock()
    world = P.sim.SyntheticWorld(n_robots, n_poses, seed=seed)
    cfg = cfg or P.pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)
    nodes, odom = {}, {}
    for rid in range(n_robots):
        bus = P.bus.InProcessBus(router, rid)
        params = make_params(rid, n_robots, budget)
        if param_fn is not None:
            param_fn(params)
        nodes[rid] = P.node.SwarmNode(
            params, bus, clock,
            descriptor_model=_SimDescriptorModel(world, rid),
            pgo_config=cfg, **P.kw)
        nodes[rid].handler = P.sim.SimSensorHandler(params, bus, world,
                                                    verification_gate=4.0)
        odom[rid] = world.noisy_odometry(rid, drift=drift)
    return SimpleNamespace(P=P, router=router, clock=clock, world=world,
                           nodes=nodes, odom=odom, selected=[])


def drive_pipeline(s, detection_rounds=4):
    """test_e2e_swarm.drive_pipeline, recording every selection."""
    for kf in range(s.world.n_poses):
        for rid, node in s.nodes.items():
            node.detection.add_global_descriptor_to_map(
                s.world.descriptor(rid, kf), kf)
            node.bus.publish("cslam/keyframe_odom", s.P.msgs.KeyframeOdom(
                id=kf, pose=(s.odom[rid][0][kf], s.odom[rid][1][kf])))
        s.router.spin_until_idle()
    for _ in range(detection_rounds):
        for node in s.nodes.values():
            node.tick_detection_publication()
        s.router.spin_until_idle()
        for rid, node in s.nodes.items():
            sel = node.tick_inter_robot_detection()
            s.selected.append((rid, sorted(tuple(e)[:4] for e in sel)))
        s.router.spin_until_idle(max_rounds=500)


def run_optimization(s, rounds=20):
    """test_e2e_swarm.run_optimization for package P."""
    OPT = s.P.dpgo.OptimizerState.OPTIMIZATION
    for _ in range(rounds):
        for node in s.nodes.values():
            node.tick_optimization_start()
        s.router.spin_until_idle()
        for node in s.nodes.values():
            node.tick_optimization_loop()
        s.router.spin_until_idle()
        for node in s.nodes.values():
            be = node.backend
            if be.optimizer_state == OPT and \
                    be._optimization_future is not None:
                be._optimization_future.result(timeout=300)
                be.check_result_and_finish_optimization()
        s.router.spin_until_idle()
        if any(n.backend.optimization_count > 0 for n in s.nodes.values()):
            for node in s.nodes.values():
                node.tick_optimization_loop()
            s.router.spin_until_idle()
            return
    raise AssertionError("optimization never completed")


def observe(s):
    """What the two packages' runs are compared on."""
    n0 = s.nodes[0].detection
    cs = n0.lcm.candidate_selector
    gt = s.world.trajectories
    out = {
        "candidates": sorted((tuple(e)[:4], float(e.weight))
                             for e in cs.candidate_edges.values()),
        "fixed": sorted(tuple(e)[:4] for e in cs.fixed_edges),
        "selected": s.selected,
        "delivered": s.router.delivered_count,
        "counts": {rid: n.backend.optimization_count
                   for rid, n in s.nodes.items()},
        "logs": {rid: (n.detection.log_total_matches_selected,
                       n.detection.log_total_vertices_transmitted,
                       n.detection.log_total_successful_matches,
                       n.detection.log_total_failed_matches,
                       n.detection.log_detection_cumulative_communication)
                 for rid, n in s.nodes.items()},
        "ate_odom": {}, "ate_opt": {}, "estimates": {},
    }
    for rid, n in s.nodes.items():
        est = n.backend.current_pose_estimates
        keys = [(rid, k) for k in range(s.world.n_poses)]
        out["ate_odom"][rid] = ate_rmse(s.odom[rid][1], gt[rid][1])
        if all(k in est for k in keys):
            est_t = np.stack([est[k][1] for k in keys])
            out["estimates"][rid] = est_t
            out["ate_opt"][rid] = ate_rmse(est_t, gt[rid][1])
    return out


def close(s):
    for n in s.nodes.values():
        if hasattr(n, "close"):
            n.close()


def assert_same_mission(port, ref):
    assert [c[0] for c in port["candidates"]] == \
        [c[0] for c in ref["candidates"]]
    np.testing.assert_allclose([c[1] for c in port["candidates"]],
                               [c[1] for c in ref["candidates"]],
                               atol=SIM_TOL)
    for key in ("selected", "fixed", "delivered", "counts", "logs"):
        assert port[key] == ref[key], key
    assert set(port["estimates"]) == set(ref["estimates"])
    for rid in ref["ate_odom"]:
        assert port["ate_odom"][rid] == pytest.approx(ref["ate_odom"][rid],
                                                      abs=ATE_TOL)
    for rid in ref["estimates"]:
        assert port["ate_opt"][rid] == pytest.approx(ref["ate_opt"][rid],
                                                     abs=ATE_TOL)
        np.testing.assert_allclose(port["estimates"][rid],
                                   ref["estimates"][rid], atol=ATE_TOL)


def mission(P, n_robots, n_poses, drift, rounds, seed=0):
    s = build_swarm(P, n_robots, n_poses, seed=seed, drift=drift)
    try:
        drive_pipeline(s, detection_rounds=rounds)
        run_optimization(s)
        return observe(s)
    finally:
        close(s)


def test_two_robot_mission_matches_reference():
    port = mission(PORT, 2, 24, 0.02, 4)
    ref = mission(JAX, 2, 24, 0.02, 4)
    assert_same_mission(port, ref)
    # sim_mission.run_mission (chip_smoke.py, the card test), on the CPU
    run = sim_mission.run_mission(2, 24, device="cpu")
    assert run["fixed_edges"] == ref["fixed"]
    assert run["optimization_count"] == ref["counts"]
    assert run["messages_delivered"] == ref["delivered"]
    assert run["selected"] == ref["logs"][0][0]
    assert run["verification_failures"] == ref["logs"][0][3]
    for rid, (odo, opt) in run["ate"].items():
        assert odo == pytest.approx(ref["ate_odom"][rid], abs=ATE_TOL)
        assert opt == pytest.approx(ref["ate_opt"][rid], abs=ATE_TOL)
    assert run["graph"]["nodes"] == 48 and run["graph"]["to_arrays_s"] > 0
    # the reference test's own checks, on the port
    assert len(port["fixed"]) > 0
    selected, transmitted = port["logs"][0][:2]
    assert 0 < selected <= 4 * 5 and transmitted > 0
    assert port["counts"][0] >= 1
    assert port["ate_opt"][1] < port["ate_odom"][1]


def test_three_robot_mission_matches_reference():
    port = mission(PORT, 3, 16, 0.01, 3)
    assert_same_mission(port, mission(JAX, 3, 16, 0.01, 3))
    assert port["logs"][0][4] > 0
    assert port["counts"][0] >= 1


def _heartbeat_scenario(P):
    s = build_swarm(P, 2, 8, drift=0.0)
    try:
        for node in s.nodes.values():
            for mon in node.detection.neighbor_manager \
                    .neighbors_monitors.values():
                mon.is_enabled = True
                mon.init_delay_sec = 0.5
                mon.max_delay_sec = 2.0
        for _ in range(3):
            for node in s.nodes.values():
                node.tick_heartbeat()
            s.router.spin_until_idle()
            s.clock.advance(1.0)
        seen = [[n.detection.neighbor_manager.local_robot_is_broker()
                 for n in s.nodes.values()]]
        s.clock.advance(5.0)
        s.nodes[1].tick_heartbeat()
        s.router.spin_until_idle()
        seen.append([n.detection.neighbor_manager.local_robot_is_broker()
                     for n in s.nodes.values()])
        return seen
    finally:
        close(s)


def test_broker_switches_on_heartbeat_loss():
    seen = _heartbeat_scenario(PORT)
    assert seen == _heartbeat_scenario(JAX)
    assert seen[0] == [True, False] and seen[1][1] is True


# ----------------------------------------------------------------------
# elastic membership (test_elastic_swarm.py)
# ----------------------------------------------------------------------


def _elastic_swarm(P, n_robots, n_poses, schedule_file):
    def monitored(params):
        params["neighbor_management.enable_neighbor_monitoring"] = True
        params["neighbor_management.init_delay_sec"] = 0.5
        params["neighbor_management.max_heartbeat_delay_sec"] = 2.0
        params["backend.max_waiting_time_sec"] = 5.0

    s = build_swarm(P, n_robots, n_poses, seed=3, budget=4,
                    cfg=P.pgo.PGOConfig(lm_max_iters=10, cg_max_iters=40,
                                        gnc_max_outer_iters=3),
                    param_fn=monitored)
    s.rendezvous = {rid: P.rdv.SimulatedRendezVous(s.clock, schedule_file,
                                                   rid, enabled=True)
                    for rid in range(n_robots)}
    return s


def _heartbeat_round(s, dt=1.0):
    for rid, node in s.nodes.items():
        if s.rendezvous[rid].is_alive():
            node.tick_heartbeat()
    s.router.spin_until_idle()
    s.clock.advance(dt)


def _in_range(s):
    return s.nodes[0].detection.neighbor_manager.check_neighbors_in_range()[1]


def _elastic_scenario(P, sched):
    s = _elastic_swarm(P, 3, 12, sched)
    out = {}
    try:
        for _ in range(3):
            _heartbeat_round(s)
        for kf in range(s.world.n_poses):
            for rid, node in s.nodes.items():
                node.detection.add_global_descriptor_to_map(
                    s.world.descriptor(rid, kf), kf)
                node.bus.publish("cslam/keyframe_odom", P.msgs.KeyframeOdom(
                    id=kf, pose=(s.world.trajectories[rid][0][kf],
                                 s.world.trajectories[rid][1][kf])))
        s.router.spin_until_idle()
        for node in s.nodes.values():
            node.tick_detection_publication()
        s.router.spin_until_idle()
        out["in_range_1"] = _in_range(s)
        for _ in range(7):
            _heartbeat_round(s)
        out["alive_2"] = s.rendezvous[2].is_alive()
        out["in_range_2"] = _in_range(s)
        selection = s.nodes[0].tick_inter_robot_detection()
        out["selection"] = sorted(tuple(e)[:4] for e in selection)
        s.router.spin_until_idle(max_rounds=500)
        for node in s.nodes.values():
            node.tick_optimization_start()
        s.router.spin_until_idle()
        for _ in range(3):
            for node in s.nodes.values():
                node.tick_optimization_loop()
            s.router.spin_until_idle()
        be0 = s.nodes[0].backend
        out["neighbors"] = sorted(be0.current_neighbors.ids)
        if be0.optimizer_state == P.dpgo.OptimizerState.OPTIMIZATION and \
                be0._optimization_future is not None:
            be0._optimization_future.result(timeout=120)
            be0.check_result_and_finish_optimization()
        s.router.spin_until_idle()
        out["count"] = be0.optimization_count
        est = be0.current_pose_estimates
        out["keys"] = sorted(est)
        out["t"] = np.stack([est[k][1] for k in out["keys"]])
        while s.clock.now() < 20.0:
            s.clock.advance(1.0)
        for _ in range(3):
            _heartbeat_round(s)
        out["in_range_3"] = _in_range(s)
        return out
    finally:
        close(s)


def test_elastic_swarm_proceeds_without_dead_robot_and_rejoins(tmp_path):
    sched = tmp_path / "sched.csv"
    sched.write_text("0,0.0,1000.0\n1,0.0,1000.0\n2,0.0,6.0,20.0,100.0\n")
    port = _elastic_scenario(PORT, str(sched))
    ref = _elastic_scenario(JAX, str(sched))
    for key in ("in_range_1", "alive_2", "in_range_2", "selection",
                "neighbors", "count", "keys", "in_range_3"):
        assert port[key] == ref[key], key
    np.testing.assert_allclose(port["t"], ref["t"], atol=ATE_TOL)
    assert port["in_range_1"] == [0, 1, 2]
    assert port["in_range_2"] == [0, 1] and not port["alive_2"]
    assert all(2 not in (e[0], e[2]) for e in port["selection"])
    assert port["neighbors"] == [1] and port["count"] == 1
    assert port["in_range_3"] == [0, 1, 2]


def _timeout_scenario(P, sched):
    s = _elastic_swarm(P, 2, 6, sched)
    try:
        for _ in range(3):
            _heartbeat_round(s)
        for kf in range(6):
            s.nodes[0].bus.publish("cslam/keyframe_odom", P.msgs.KeyframeOdom(
                id=kf, pose=(s.world.trajectories[0][0][kf],
                             s.world.trajectories[0][1][kf])))
        s.router.spin_until_idle()
        be = s.nodes[0].backend
        be.current_neighbors = P.msgs.RobotIdsAndOrigin(ids=[1], origins=[1])
        be._sync_sm()
        be.optimizer_state = P.dpgo.OptimizerState.POSEGRAPH_COLLECTION
        s.router.subscribers = [(t, cb) for (t, cb) in s.router.subscribers
                                if "/r1/" not in t]
        be.optimization_loop_callback()
        states = [int(be.optimizer_state)]
        s.router.spin_until_idle()
        s.clock.advance(6.0)
        be.optimization_loop_callback()
        states.append(int(be.optimizer_state))
        return states
    finally:
        close(s)


def test_elastic_waiting_timeout_when_neighbor_dies(tmp_path):
    sched = tmp_path / "s.csv"
    sched.write_text("0,0.0,1000.0\n1,0.0,1000.0\n")
    states = _timeout_scenario(PORT, str(sched))
    assert states == _timeout_scenario(JAX, str(sched))
    assert states == [tdpgo.OptimizerState.WAITING_FOR_NEIGHBORS_POSEGRAPHS,
                      tdpgo.OptimizerState.IDLE]


def test_node_ticks_emit_spans(tmp_path):
    """SwarmNode's ticks record spans when the process tracer is on."""
    ttracing.tracer.clear()
    ttracing.tracer.enable(str(tmp_path / "n.json"))
    try:
        s = build_swarm(PORT, 2, 3, drift=0.01, budget=4)
        for n in s.nodes.values():
            n.tick_heartbeat()
            n.tick_detection_publication()
        close(s)
    finally:
        ttracing.tracer.disable()
    names = {e["name"] for e in ttracing.tracer._events}
    assert {"heartbeat", "detection_publication"} <= names
    ttracing.tracer.clear()


# ----------------------------------------------------------------------
# map scale (not tier-1: minutes of CPU per package and seed)
# ----------------------------------------------------------------------

MAP_SCALE_SEEDS = (0, 1, 2)


def _map_scale(P, seed):
    return mission(P, 4, 200, 0.02, 4, seed=seed)


def _record_mac_calls(monkeypatch, acm_module):
    """Record every MAC solve of the package's broker: its inputs and
    its selection."""
    calls = []
    cls = acm_module.AlgebraicConnectivityMaximization
    orig = cls.run_mac_solver

    def run(self, fixed, cand, w_init, k, **kw):
        out = orig(self, fixed, cand, w_init, k, **kw)
        calls.append({"fixed": list(fixed), "cand": list(cand),
                      "w_init": np.array(w_init, np.float32), "k": k,
                      "n": self.total_nb_poses,
                      "w": np.array(out, np.float32)})
        return out

    monkeypatch.setattr(cls, "run_mac_solver", run)
    return calls


def _same_edges(a, b):
    return [tuple(e)[:2] for e in a] == [tuple(e)[:2] for e in b] and \
        np.allclose([e.weight for e in a], [e.weight for e in b],
                    atol=SIM_TOL, rtol=0)


def _mac_quality(mac_cls, call, w, **kw):
    """The reference's MAC quality contracts (tests/test_torch_mac.py)
    for selection `w` on `call`'s inputs: exactly k, at least 0.9x the
    exact-eigh path's lambda_2, and not below the initial selection's —
    unless the reference's own safeguard would have taken `w` over it:
    the safeguard keeps a rounding whose squaring estimate of lambda_2
    beats the initial one's by 0.3% (cslam_tpu/sparsification/mac.py),
    and at this scale that estimate errs by far more than its margin
    (both are recorded)."""
    from cslam_tpu.ops.laplacian import laplacian_dense
    from cslam_tpu.sparsification import mac as jmac
    import jax.numpy as jnp
    mac = mac_cls(call["fixed"], call["cand"], call["n"], **kw)
    obj = mac.evaluate_objective(w)
    obj_init = mac.evaluate_objective(call["w_init"])
    mac.fiedler_method = "eigh"
    obj_eigh = mac.evaluate_objective(
        mac.fw_subset(call["w_init"], call["k"], max_iters=20).w)
    ref = jmac.MAC(call["fixed"], call["cand"], call["n"])

    def ref_estimate(sel):
        L = ref.L_fixed + laplacian_dense(
            jnp.asarray(ref.e_i), jnp.asarray(ref.e_j),
            ref._pad_w(sel) * jnp.asarray(ref.weights), ref._P)
        return float(jmac._fiedler_dense_squaring(L, ref.node_mask)[0])

    est, est_init = ref_estimate(w), ref_estimate(call["w_init"])
    ok = (int(w.sum()) == min(call["k"], len(call["cand"]))
          and obj >= 0.9 * obj_eigh
          and (obj >= obj_init * (1 - 1e-3) or est > est_init * 1.003))
    return ok, {"lam2": obj, "lam2_eigh": obj_eigh, "lam2_init": obj_init,
                "ref_estimate": est, "ref_estimate_init": est_init}


def _seen_candidates(obs):
    """Every candidate that reached robot 0's selector: those left plus
    those selected (selection removes them)."""
    seen = {c[0] for c in obs["candidates"]}
    for rid, sel in obs["selected"]:
        seen |= set(sel)
    return seen


@pytest.mark.slow
def test_map_scale_mission_matches_reference(tmp_path, monkeypatch):
    """4 robots x 200 keyframes, the sim mission's 32-d descriptors and
    settings, over three seeds on both packages. The matching layer must
    agree exactly (the same candidates reach the broker); both runs must
    optimize, verify loop closures and improve robot 1 on its odometry
    (the e2e test's contract). MAC runs on its warm-LOBPCG path here
    (P = 800 <= 2048), whose selection moves with rounding (PERF.md): the
    broker's MAC solves must agree until the first that differs, that
    solve must have had the same inputs in both runs, and both packages'
    selections there must meet the reference's quality contracts
    (tests/test_torch_mac.py; see _mac_quality). From there the missions verify other loop
    closures; their ATE is reported, as the spread, to
    $CSLAM_MAP_SCALE_OUT (or the test's tmp dir) as JSON."""
    from cslam_tpu.sparsification import acm as jacm
    from cslam_tpu.sparsification import mac as jmac
    from cslam_tpu_torch.sparsification import acm as tacm
    from cslam_tpu_torch.sparsification import mac as tmac
    rows, failures = [], []
    for seed in MAP_SCALE_SEEDS:
        port_calls = _record_mac_calls(monkeypatch, tacm)
        ref_calls = _record_mac_calls(monkeypatch, jacm)
        port, ref = _map_scale(PORT, seed), _map_scale(JAX, seed)
        monkeypatch.undo()
        broker = [[sel for rid, sel in run["selected"] if rid == 0]
                  for run in (port, ref)]
        first = next((i for i, (a, b) in enumerate(zip(port_calls,
                                                       ref_calls))
                      if not np.array_equal(a["w"], b["w"])), None)
        row = {
            "seed": seed,
            "seen_candidates": [len(_seen_candidates(port)),
                                len(_seen_candidates(ref))],
            "broker_rounds_same": sum(a == b for a, b in zip(*broker)),
            "mac_solves": [len(port_calls), len(ref_calls)],
            "first_different_mac_solve": first,
            "fixed": [len(port["fixed"]), len(ref["fixed"])],
            "fixed_common": len(set(port["fixed"]) & set(ref["fixed"])),
            "counts": [port["counts"], ref["counts"]],
            "ate_odom": ref["ate_odom"],
            "ate_opt_port": port["ate_opt"], "ate_opt_ref": ref["ate_opt"],
        }
        if _seen_candidates(port) != _seen_candidates(ref):
            failures.append((seed, "candidates"))
        for run in (port, ref):
            if not (run["counts"][0] >= 1 and run["fixed"]
                    and run["ate_opt"][1] < run["ate_odom"][1]):
                failures.append((seed, "mission contract"))
        if first is not None:
            pc, rc = port_calls[first], ref_calls[first]
            if not (_same_edges(pc["fixed"], rc["fixed"])
                    and _same_edges(pc["cand"], rc["cand"])
                    and np.array_equal(pc["w_init"], rc["w_init"])
                    and pc["k"] == rc["k"] and pc["n"] == rc["n"]):
                failures.append((seed, "inputs of the first different "
                                       "MAC solve"))
            ok_p, row["mac_port"] = _mac_quality(tmac.MAC, pc, pc["w"],
                                                 device="cpu")
            ok_r, row["mac_ref"] = _mac_quality(jmac.MAC, rc, rc["w"])
            if not (ok_p and ok_r):
                failures.append((seed, "MAC quality"))
        rows.append(row)
    out = os.environ.get("CSLAM_MAP_SCALE_OUT",
                         str(tmp_path / "map_scale.json"))
    with open(out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(json.dumps(rows, default=str))
    assert not failures, failures
