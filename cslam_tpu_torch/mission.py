"""What the sensor missions through SwarmNode share.

The visual mission (`visual_mission.py`) and the lidar mission
(`lidar_mission.py`) drive the same swarm: per robot a sensor handler
and a `SwarmNode` on one `InProcessRouter`, a feed of every robot's
frames in turn, 4 detection rounds, and optimization rounds until one
solve has finished. Each solve is waited on with a timeout, and every
node and handler is closed, also on failure. `run_stages` times the
stages on the host clock around work that ends in a device synchronize.
"""

import time
from typing import Dict

import numpy as np
import torch

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.decentralized_pgo import OptimizerState
from cslam_tpu_torch.comm.bus import InProcessRouter, ManualClock
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.utils.evaluation import ate_rmse

DETECTION_ROUNDS = 4
OPTIMIZATION_ROUNDS = 20
# a solve that takes longer is a stall: its future raises TimeoutError
SOLVE_TIMEOUT_S = 300.0
# full GNC anneal depth, as the reference's missions
MISSION_PGO = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MissionSwarm:
    """Router, clock, and per robot a handler and a SwarmNode (the
    subclass builds them, sets the true and odometry trajectories, and
    feeds the frames, filling `kf_to_pose`)."""

    def __init__(self, n_robots: int, n_poses: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_robots, self.n_poses = n_robots, n_poses
        self.router = InProcessRouter()
        self.clock = ManualClock()
        self.nodes, self.handlers = {}, {}
        self.kf_to_pose = {rid: {} for rid in range(n_robots)}
        self.true = self.odom = None

    def feed(self):
        raise NotImplementedError

    def detect(self):
        for _ in range(DETECTION_ROUNDS):
            for node in self.nodes.values():
                node.tick_detection_publication()
            self.router.spin_until_idle(max_rounds=2000)
            for node in self.nodes.values():
                node.tick_inter_robot_detection()
            self.router.spin_until_idle(max_rounds=2000)

    def optimize(self):
        """Optimization rounds until one solve has finished."""
        for _ in range(OPTIMIZATION_ROUNDS):
            for node in self.nodes.values():
                node.tick_optimization_start()
            self.router.spin_until_idle()
            for node in self.nodes.values():
                node.tick_optimization_loop()
            self.router.spin_until_idle()
            for node in self.nodes.values():
                be = node.backend
                if be.optimizer_state == OptimizerState.OPTIMIZATION and \
                        be._optimization_future is not None:
                    be._optimization_future.result(timeout=SOLVE_TIMEOUT_S)
                    be.check_result_and_finish_optimization()
            self.router.spin_until_idle()
            if any(n.backend.optimization_count > 0
                   for n in self.nodes.values()):
                for node in self.nodes.values():
                    node.tick_optimization_loop()
                self.router.spin_until_idle()
                return
        raise AssertionError("optimization never completed")

    def close(self):
        for node in self.nodes.values():
            node.close()
        for handler in self.handlers.values():
            close = getattr(handler, "close", None)
            if close is not None:
                close()

    def loop_closures(self):
        """(intra-robot loop factors, inter-robot closures): every robot
        stores every broadcast inter-robot closure, so those are
        counted once."""
        intra = sorted((rid, f.key_from, f.key_to)
                       for rid, n in self.nodes.items()
                       for f in n.backend.local_factors if f.is_loop)
        inter = sorted({(tuple(lc.key_from), tuple(lc.key_to))
                        for n in self.nodes.values()
                        for lcs in
                        n.backend.inter_robot_loop_closures.values()
                        for lc in lcs})
        return intra, inter

    def ate(self):
        """{robot: (odometry ATE, optimized ATE)} over each robot's own
        keyframes with estimates (ground truth through the keyframe ->
        pose index map); robots with fewer than 3 are left out."""
        out = {}
        for rid in range(self.n_robots):
            gt_t = np.stack([p[1] for p in self.true[rid]])
            est = self.nodes[rid].backend.current_pose_estimates
            own = [k for k in sorted(est) if k[0] == rid
                   and k[1] in self.kf_to_pose[rid]]
            if len(own) < 3:
                continue
            idx = [self.kf_to_pose[rid][k[1]] for k in own]
            est_t = np.stack([est[k][1] for k in own])
            raw = np.stack([self.odom[rid][1][i] for i in idx])
            out[rid] = (ate_rmse(raw, gt_t[idx]), ate_rmse(est_t, gt_t[idx]))
        return out


def run_stages(swarm: MissionSwarm) -> Dict[str, float]:
    """Feed, detect and optimize; wall seconds of each stage."""
    timings = {}
    for stage, fn in (("feed", swarm.feed),
                      ("detection", swarm.detect),
                      ("optimization", swarm.optimize)):
        sync(swarm.device)
        t = time.perf_counter()
        fn()
        sync(swarm.device)
        timings[stage] = time.perf_counter() - t
    return timings


def mission_results(swarm: MissionSwarm) -> Dict:
    """The keyframes, loop closures, solves and ATE of a finished run."""
    intra, inter = swarm.loop_closures()
    return {
        "keyframes": sum(len(m) for m in swarm.kf_to_pose.values()),
        "keyframe_poses": {r: sorted(m.values())
                           for r, m in swarm.kf_to_pose.items()},
        "intra_loop_closures": intra,
        "inter_loop_closures": inter,
        "verifications": sum(h.log_verifications
                             for h in swarm.handlers.values()),
        "optimization_count": {rid: n.backend.optimization_count
                               for rid, n in swarm.nodes.items()},
        "ate": swarm.ate(),
    }
