"""The lidar mission through SwarmNode: loop closures earned from point
clouds.

The counterpart of benchmarks/lidar_mission_bench.py's `main` on the
port (the Swarm-SLAM lidar pipeline end to end). Robots scan a shared
structured world (`LidarWorld`: box-like clusters on a ground disk)
within a sensor range along overlapping out-and-back trajectories with
drifted odometry. Per robot a `LidarHandler` (voxel grid, FPFH, RANSAC,
GNC-ICP from the Scan Context yaw and FPFH seeds) and a `SwarmNode`
(Scan Context place recognition, the broker, decentralized GNC-LM PGO)
share one `InProcessRouter`; then 4 detection rounds and optimization
rounds until one solve has finished (`mission.py`). The world, the
trajectories and the scans draw from the reference's RNG streams in its
order, so one world size gives one world. Everything runs on `device`
(None = the CUDA card). It returns its results and writes no file.
"""

import time
from collections import Counter
from typing import Dict, Tuple

import numpy as np
import torch

from cslam_tpu_torch.comm.bus import InProcessBus
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.lidar_handler import LidarHandler, \
    ScanContextModel
from cslam_tpu_torch.mission import MISSION_PGO, MissionSwarm, \
    mission_results, run_stages
from cslam_tpu_torch.node import SwarmNode
from cslam_tpu_torch.ops import se3

# the reference's world: (n_clusters, extent, sensor_range)
DEFAULT_WORLD = (28, 14.0, 10.0)
WORLD_SEED, TRAJECTORY_SEED, SCAN_SEED = 0, 1, 3
ODOMETRY_DRIFT = 0.02
SCAN_NOISE = 0.02
# inter-robot loop-closure candidates selected per detection round
BUDGET = 6
# Scan Context similarity threshold of the reference's mission
SIM_THRESHOLD = 0.75


class LidarWorld:
    """Structured 3D world: clustered 'buildings' (box-ish point blobs)
    on a ground disk, distinct enough that Scan Context signatures vary
    across positions. A robot sees the points within `sensor_range` of
    its position, in the sensor frame."""

    def __init__(self, n_clusters: int, extent: float, sensor_range: float):
        rng = np.random.default_rng(WORLD_SEED)
        pts = []
        for _ in range(n_clusters):
            c = np.array([rng.uniform(-extent, extent),
                          rng.uniform(-extent / 2, extent / 2), 0.0])
            size = rng.uniform(0.4, 1.6, 3)
            size[2] = rng.uniform(0.8, 3.0)           # height
            n = int(rng.integers(60, 140))
            # points on the box surface-ish: uniform in the box, pushed
            # to a random face for structure
            p = rng.uniform(-1, 1, (n, 3)) * size
            face = rng.integers(0, 3, n)
            sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
            p[np.arange(n), face] = sign * size[face]
            p[:, 2] = np.abs(p[:, 2])                  # above ground
            pts.append(c + p)
        self.points = np.concatenate(pts).astype(np.float32)
        self.sensor_range = sensor_range

    def scan(self, pose, rng):
        """Range-limited observation in the sensor frame at `pose`."""
        R, t = pose
        d = np.linalg.norm(self.points[:, :2] - t[None, :2], axis=1)
        vis = self.points[d < self.sensor_range]
        local = (vis - t) @ R
        return (local + rng.standard_normal(local.shape).astype(np.float32)
                * SCAN_NOISE).astype(np.float32)


def make_pose(x, y=0.0, yaw=0.0):
    R = se3.so3_exp(torch.tensor([0.0, 0.0, yaw], dtype=torch.float32))
    return R.numpy().astype(np.float32), np.array([x, y, 0], np.float32)


def trajectories(n_robots, n_poses):
    """Overlapping out-and-back loops per robot + drifted odometry:
    (true poses, odometry) per robot, the reference's draws in its
    order."""
    rng = np.random.default_rng(TRAJECTORY_SEED)
    true, odom = [], []
    for rid in range(n_robots):
        x0 = -4.0 + 4.0 * rid
        xs = np.concatenate([
            np.linspace(x0, x0 + 7.0, n_poses // 2),
            np.linspace(x0 + 7.0, x0 + 0.3, n_poses - n_poses // 2)])
        ys = 1.0 * np.sin(np.linspace(0, 2 * np.pi, n_poses) + rid)
        yaws = 0.15 * np.sin(np.linspace(0, 2 * np.pi, n_poses) + 2 * rid)
        poses = [make_pose(x, y, w) for x, y, w in zip(xs, ys, yaws)]
        true.append(poses)
        oR, ot = [poses[0][0]], [poses[0][1]]
        for k in range(1, n_poses):
            Rm = poses[k - 1][0].T @ poses[k][0]
            tm = poses[k - 1][0].T @ (poses[k][1] - poses[k - 1][1])
            xi = rng.standard_normal(6).astype(np.float32) * ODOMETRY_DRIFT
            dR, dt = (a.numpy() for a in se3.se3_exp(torch.from_numpy(xi)))
            Rm, tm = Rm @ dR, tm + Rm @ dt
            oR.append(oR[-1] @ Rm)
            ot.append(ot[-1] + oR[-2] @ tm)
        odom.append((oR, ot))
    return true, odom


def make_params(robot_id, n_robots):
    return {
        "robot_id": robot_id,
        "max_nb_robots": n_robots,
        "frontend.sensor_type": "lidar",
        "frontend.global_descriptor_technique": "scancontext",
        "frontend.kf_distance_threshold": 0.5,
        "frontend.voxel_size": 0.3,
        "frontend.similarity_threshold": SIM_THRESHOLD,
        "frontend.inter_robot_loop_closure_budget": BUDGET,
        "frontend.nb_best_matches": 8,
        "frontend.intra_loop_min_inbetween_keyframes": 5,
        "frontend.detection_publication_max_elems_per_msg": 8,
        "frontend.enable_intra_robot_loop_closures": True,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "backend.max_waiting_time_sec": 60.0,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
        "evaluation.enable_logs": False,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": "",
        "evaluation.enable_sparsification_comparison": False,
    }


class LidarSwarm(MissionSwarm):
    """The mission's swarm: per robot a LidarHandler and a SwarmNode
    with a Scan Context place model."""

    def __init__(self, n_robots: int, n_poses: int,
                 world: Tuple[int, float, float],
                 device: DeviceLike = None):
        super().__init__(n_robots, n_poses, device)
        self.world = LidarWorld(*world)
        try:
            for rid in range(n_robots):
                bus = InProcessBus(self.router, rid)
                params = make_params(rid, n_robots)
                self.handlers[rid] = LidarHandler(params, bus, self.clock,
                                                  device=self.device)
                self.nodes[rid] = SwarmNode(
                    params, bus, self.clock,
                    descriptor_model=ScanContextModel(device=self.device),
                    pgo_config=MISSION_PGO, device=self.device)
        except BaseException:
            self.close()
            raise
        self.true, self.odom = trajectories(n_robots, n_poses)
        self.scan_s = 0.0
        self.scan_sizes = []

    def feed(self):
        """Every robot's scans in turn; keyframes over the bus."""
        rng = np.random.default_rng(SCAN_SEED)
        for kf in range(self.n_poses):
            for rid, handler in self.handlers.items():
                t = time.perf_counter()
                scan = self.world.scan(self.true[rid][kf], rng)
                self.scan_s += time.perf_counter() - t
                self.scan_sizes.append(len(scan))
                handler.add_sensor_data(
                    scan, (self.odom[rid][0][kf], self.odom[rid][1][kf]))
                kf_id = handler.process_new_sensor_data()
                if kf_id is not None:
                    self.kf_to_pose[rid][kf_id] = kf
            self.router.spin_until_idle(max_rounds=2000)


def run_lidar_mission(n_robots: int = 3, n_poses: int = 12,
                      world: Tuple[int, float, float] = DEFAULT_WORLD,
                      device: DeviceLike = None) -> Dict:
    """Build, feed, detect and optimize one lidar swarm; close it.

    Returns per-stage wall seconds (`timings_s`: build, scan inside the
    feed, feed, detection, optimization; host clock around work ending
    in a device synchronize), the keyframe count, the verified intra-
    and inter-robot loop closures, the registrations (their outcomes by
    kind, padded sizes and ICP iterations), the raw scan sizes and the
    keyframe cloud sizes after the voxel grid, and per robot (odometry
    ATE, optimized ATE)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    swarm = LidarSwarm(n_robots, n_poses, world, dev)
    try:
        timings = {"build": time.perf_counter() - t0}
        timings.update(run_stages(swarm))
        timings["scan"] = swarm.scan_s
        handlers = swarm.handlers.values()
        caps = sum((h.log_register_caps for h in handlers), Counter())
        outcomes = sum((h.log_outcomes for h in handlers), Counter())
        return dict(
            mission_results(swarm), timings_s=timings,
            register_caps=dict(caps),
            outcomes={f"{kind}_{'success' if ok else 'failure'}": n
                      for (kind, ok), n in sorted(outcomes.items())},
            icp_iterations=sum(h.log_icp_iterations for h in handlers),
            scan_sizes=swarm.scan_sizes,
            cloud_sizes=[len(c) for h in handlers
                         for c in h.local_keyframes.values()])
    finally:
        swarm.close()
