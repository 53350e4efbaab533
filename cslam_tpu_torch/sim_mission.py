"""The sim mission through SwarmNode: the swarm protocol end to end.

The mission of tests/test_e2e_swarm.py, on the port: per robot a
`SwarmNode` and a `SimSensorHandler` over one `InProcessRouter` and one
`ManualClock`, on a `SyntheticWorld`. Each robot is fed its keyframes
(descriptor + `KeyframeOdom`); detection rounds gossip descriptors and
matches, the broker (robot 0) selects candidates under the budget and
brokers their verification; optimization rounds elect the optimizer,
collect the pose graphs, solve on a worker thread and share the
estimates. Descriptor searches, MAC selection and the solve run on
`device` (None = the CUDA card).

`run_mission` waits on every solve with a timeout, shuts every node's
worker thread down before it returns (also on failure), and reports
per-stage wall seconds, the protocol's counts and each robot's ATE.
"""

import time
from typing import Dict

import numpy as np

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.bus import InProcessBus
from cslam_tpu_torch.device import DeviceLike, resolve_device, sync
from cslam_tpu_torch.frontend.sim import SimSensorHandler, SyntheticWorld
from cslam_tpu_torch.mission import MISSION_PGO, MissionSwarm, run_stages
from cslam_tpu_torch.node import SwarmNode
from cslam_tpu_torch.swarm_slice import BUDGET, DRIFT, GATE_M, make_params
from cslam_tpu_torch.utils.evaluation import ate_rmse


def mission_params(robot_id: int, max_nb_robots: int) -> Dict:
    """The sim mission's parameters (tests/test_e2e_swarm.py): the
    slice's front-end parameters plus gossip chunking, back-end,
    neighbor-management and evaluation keys."""
    return dict(make_params(robot_id, max_nb_robots, BUDGET), **{
        "frontend.detection_publication_max_elems_per_msg": 8,
        "backend.max_waiting_time_sec": 60.0,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
        "evaluation.enable_logs": False,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": "",
    })


class SimDescriptorModel:
    """Descriptor model backed by the synthetic world."""

    def __init__(self, world: SyntheticWorld, rid: int):
        self.world = world
        self.rid = rid

    def compute_embedding(self, kf_id):
        return self.world.descriptor(self.rid, kf_id)


class Swarm(MissionSwarm):
    """One simulated swarm: the world, per robot a SwarmNode and a
    SimSensorHandler, and each robot's drifted odometry."""

    # the reference's spin caps (tests/test_e2e_swarm.py)
    PUBLICATION_SPIN_ROUNDS = 100
    DETECTION_SPIN_ROUNDS = 500

    def __init__(self, n_robots: int, n_poses: int, descriptor_dim: int = 32,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(n_robots, n_poses, device)
        self.world = SyntheticWorld(n_robots, n_poses, seed=seed,
                                    descriptor_dim=descriptor_dim)
        self.odom = {}
        for rid in range(n_robots):
            bus = InProcessBus(self.router, rid)
            params = mission_params(rid, n_robots)
            self.nodes[rid] = SwarmNode(
                params, bus, self.clock,
                descriptor_model=SimDescriptorModel(self.world, rid),
                pgo_config=MISSION_PGO, device=self.device)
            self.handlers[rid] = SimSensorHandler(
                params, bus, self.world, verification_gate=GATE_M)
            self.odom[rid] = self.world.noisy_odometry(rid, drift=DRIFT)

    def feed(self):
        """Every robot's keyframes: descriptor, then odometry."""
        for kf in range(self.world.n_poses):
            for rid, node in self.nodes.items():
                node.detection.add_global_descriptor_to_map(
                    self.world.descriptor(rid, kf), kf)
                node.bus.publish("cslam/keyframe_odom", msgs.KeyframeOdom(
                    id=kf, pose=(self.odom[rid][0][kf],
                                 self.odom[rid][1][kf])))
            self.router.spin_until_idle()

    def ate(self):
        """{robot: (odometry ATE, estimate ATE or None)}: a robot that
        never received estimates for all its poses has None."""
        out = {}
        for rid, node in self.nodes.items():
            gt = self.world.trajectories[rid][1]
            est = node.backend.current_pose_estimates
            keys = [(rid, k) for k in range(self.world.n_poses)]
            opt = None
            if all(k in est for k in keys):
                opt = ate_rmse(np.stack([est[k][1] for k in keys]), gt)
            out[rid] = (ate_rmse(self.odom[rid][1], gt), opt)
        return out


def run_mission(n_robots: int, n_poses: int, descriptor_dim: int = 32,
                seed: int = 0, device: DeviceLike = None) -> Dict:
    """Build, feed, detect and optimize one swarm; close its nodes.

    Returns per-stage wall seconds (`timings_s`, host clock around work
    ending in a device synchronize), robot 0's detection counts, the
    delivered message count, each robot's optimization count, robot 0's
    solve walls, the host seconds of one `to_arrays` of robot 0's
    aggregated graph (padded host arrays, and with their copy to the
    device), and each robot's ATE."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    swarm = Swarm(n_robots, n_poses, descriptor_dim, seed, device=dev)
    try:
        timings = {"build": time.perf_counter() - t0}
        timings.update(run_stages(swarm))
        det = swarm.nodes[0].detection
        cs = det.lcm.candidate_selector
        be0 = swarm.nodes[0].backend
        fg = be0.aggregate_pose_graphs()
        t = time.perf_counter()
        fg.to_numpy()
        to_numpy_s = time.perf_counter() - t
        sync(dev)
        t = time.perf_counter()
        fg.to_arrays(device=dev)
        sync(dev)
        to_arrays_s = time.perf_counter() - t
        return {
            "timings_s": timings,
            "candidates_remaining": len(cs.candidate_edges),
            "selected": det.log_total_matches_selected,
            "vertices_transmitted": det.log_total_vertices_transmitted,
            "fixed_edges": sorted(tuple(e)[:4] for e in cs.fixed_edges),
            "verification_failures": det.log_total_failed_matches,
            "detection_phase_ms": dict(det.tick_phase_ms),
            "messages_delivered": swarm.router.delivered_count,
            "optimization_count": {rid: n.backend.optimization_count
                                   for rid, n in swarm.nodes.items()},
            "optimization_walls": list(be0.optimization_walls),
            "graph": {"nodes": fg.num_nodes, "factors": fg.num_factors,
                      "to_numpy_s": to_numpy_s,
                      "to_arrays_s": to_arrays_s},
            "ate": swarm.ate(),
        }
    finally:
        swarm.close()
