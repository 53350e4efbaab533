"""The learned visual mission through SwarmNode: loop closures earned
from pixels.

The counterpart of benchmarks/visual_mission_bench.py's `main` on the
port. Robots render 120x160 views of a shared corner-rich world
(`SquareWorld`, the shipped models' training distribution) along
overlapping out-and-back trajectories with drifted odometry. Per robot
an `RGBDHandler` (`frontend.features: learned`: the shipped SuperPoint
and LightGlue, LightGlue at its shipped 3 layers), a
`GlobalDescriptorComponent` with the shipped CosPlace, and a
`SwarmNode` (the detector's searches through the cosine top-k kernel,
the broker, decentralized GNC-LM PGO) share one `InProcessRouter`.
After the feed come 4 detection rounds and up to 20 optimization
rounds; each solve is waited on with a timeout and every node is closed
before `run_visual_mission` returns, also on failure. Everything runs
on `device` (None = the CUDA card). It returns its results and writes
no file.
"""

import time
from typing import Dict

import numpy as np
import torch

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.decentralized_pgo import OptimizerState
from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.global_descriptor_component import \
    GlobalDescriptorComponent
from cslam_tpu_torch.frontend.rgbd_handler import CameraIntrinsics, \
    RGBDHandler
from cslam_tpu_torch.frontend.sim import render_corner_scene
from cslam_tpu_torch.node import SwarmNode
from cslam_tpu_torch.ops import se3
from cslam_tpu_torch.utils.evaluation import ate_rmse

H, W = 120, 160
INTR = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, baseline=0.1)
DETECTION_ROUNDS = 4
OPTIMIZATION_ROUNDS = 20
# a solve that takes longer is a stall: its future raises TimeoutError
SOLVE_TIMEOUT_S = 300.0
# full GNC anneal depth, as the reference's visual mission
MISSION_PGO = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)
# CosPlace's operating point on this mission (the reference's sweep)
COSPLACE_THRESHOLD = 0.75
# inter-robot loop-closure candidates selected per detection round
BUDGET = 6


class SquareWorld:
    """Corner-rich squares on the z=5 plane over a wide shared area;
    the same RNG draws as the reference's, so one seed gives one
    world."""

    def __init__(self, n=220, seed=0):
        rng = np.random.default_rng(seed)
        self.pts_w = np.stack([
            rng.uniform(-11, 11, n), rng.uniform(-6.5, 6.5, n),
            np.full(n, 5.0)], axis=1).astype(np.float32)
        self.shades = np.where(rng.random(n) < 0.5,
                               rng.uniform(0.0, 0.18, n),
                               rng.uniform(0.82, 1.0, n))

    def render(self, pose, rng):
        return render_corner_scene(pose, INTR, rng, squares_w=self.pts_w,
                                   shades=self.shades, H=H, W=W)


def make_pose(x, y=0.0, yaw=0.0):
    R = se3.so3_exp(torch.tensor([0.0, 0.0, yaw], dtype=torch.float32))
    return R.numpy().astype(np.float32), np.array([x, y, 0], np.float32)


def trajectories(n_robots, n_poses, seed=1, drift=0.03):
    """Overlapping out-and-back loops per robot + drifted odometry:
    (true poses, odometry) per robot, the reference's draws in its
    order."""
    rng = np.random.default_rng(seed)
    true, odom = [], []
    for rid in range(n_robots):
        x0 = -1.5 + 1.5 * rid
        xs = np.concatenate([
            np.linspace(x0, x0 + 2.5, n_poses // 2),
            np.linspace(x0 + 2.5, x0 + 0.1, n_poses - n_poses // 2)])
        ys = 0.35 * np.sin(np.linspace(0, 2 * np.pi, n_poses) + rid)
        yaws = 0.1 * np.sin(np.linspace(0, 2 * np.pi, n_poses) + 2 * rid)
        poses = [make_pose(x, y, w) for x, y, w in zip(xs, ys, yaws)]
        true.append(poses)
        oR, ot = [poses[0][0]], [poses[0][1]]
        for k in range(1, n_poses):
            Rm = poses[k - 1][0].T @ poses[k][0]
            tm = poses[k - 1][0].T @ (poses[k][1] - poses[k - 1][1])
            xi = rng.standard_normal(6).astype(np.float32) * drift
            dR, dt = (a.numpy() for a in se3.se3_exp(torch.from_numpy(xi)))
            Rm, tm = Rm @ dR, tm + Rm @ dt
            oR.append(oR[-1] @ Rm)
            ot.append(ot[-1] + oR[-2] @ tm)
        odom.append((oR, ot))
    return true, odom


def make_params(robot_id, n_robots, features="learned"):
    return {
        "robot_id": robot_id,
        "max_nb_robots": n_robots,
        "frontend.features": features,      # shipped weights auto-load
        "frontend.lightglue_score_threshold": 0.1,
        "frontend.pnp_min_inliers": 6,
        "frontend.max_queue_size": 5,
        "frontend.keyframe_generation_ratio_threshold": 1.0,
        "frontend.similarity_threshold": COSPLACE_THRESHOLD,
        "frontend.global_descriptor_technique": "custom",
        "frontend.inter_robot_loop_closure_budget": BUDGET,
        "frontend.nb_best_matches": 8,
        "frontend.intra_loop_min_inbetween_keyframes": 5,
        "frontend.detection_publication_max_elems_per_msg": 8,
        "frontend.enable_intra_robot_loop_closures": True,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "frontend.sensor_type": "rgbd",
        "backend.max_waiting_time_sec": 60.0,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
        "evaluation.enable_logs": False,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": "",
        "evaluation.enable_sparsification_comparison": False,
    }


def make_place_model(device: DeviceLike = None):
    """The shipped CosPlace on `device`."""
    from cslam_tpu_torch.models.cosplace import CosPlace
    model = CosPlace({"frontend.nn_checkpoint": "shipped"}, device=device)
    if not model.enabled:
        raise FileNotFoundError("no shipped cosplace weights")
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class VisualSwarm:
    """Router, clock, world, and per robot a handler, a descriptor
    component and a SwarmNode."""

    def __init__(self, n_robots: int, n_poses: int,
                 features: str = "learned", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_robots, self.n_poses = n_robots, n_poses
        self.world = SquareWorld()
        self.router = InProcessRouter()
        self.clock = ManualClock()
        self.model = make_place_model(self.device)
        self.nodes, self.handlers = {}, {}
        try:
            for rid in range(n_robots):
                bus = InProcessBus(self.router, rid)
                params = make_params(rid, n_robots, features)
                self.handlers[rid] = RGBDHandler(params, bus, self.clock,
                                                 max_keypoints=128,
                                                 device=self.device)
                GlobalDescriptorComponent(params, bus, model=self.model,
                                          batch_size=1, device=self.device)
                self.nodes[rid] = SwarmNode(
                    params, bus, self.clock, descriptor_model=self.model,
                    pgo_config=MISSION_PGO, device=self.device)
        except BaseException:
            self.close()
            raise
        self.true, self.odom = trajectories(n_robots, n_poses)
        self.kf_to_pose = {rid: {} for rid in range(n_robots)}
        self.render_s = 0.0

    def feed(self):
        """Every robot's frames in turn; descriptors over the bus."""
        rng = np.random.default_rng(3)
        for kf in range(self.n_poses):
            for rid, handler in self.handlers.items():
                t = time.perf_counter()
                img, depth = self.world.render(self.true[rid][kf], rng)
                self.render_s += time.perf_counter() - t
                handler.add_sensor_data(
                    img, depth, INTR,
                    (self.odom[rid][0][kf], self.odom[rid][1][kf]))
                kf_id = handler.process_new_sensor_data()
                if kf_id is not None:
                    self.kf_to_pose[rid][kf_id] = kf
            self.router.spin_until_idle(max_rounds=2000)

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
            handler.close()

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


def run_visual_mission(n_robots: int = 3, n_poses: int = 12,
                       features: str = "learned",
                       device: DeviceLike = None) -> Dict:
    """Build, feed, detect and optimize one visual swarm; close it.

    Returns per-stage wall seconds (`timings_s`: build, render inside
    the feed, feed, detection, optimization; host clock around work
    ending in a device synchronize), the keyframe count, the verified
    intra- and inter-robot loop closures, the verification and
    device-to-host copy counts, and per robot (odometry ATE, optimized
    ATE)."""
    dev = resolve_device(device)
    timings = {}
    t0 = time.perf_counter()
    swarm = VisualSwarm(n_robots, n_poses, features, dev)
    try:
        timings["build"] = time.perf_counter() - t0
        for stage, fn in (("feed", swarm.feed),
                          ("detection", swarm.detect),
                          ("optimization", swarm.optimize)):
            _sync(dev)
            t = time.perf_counter()
            fn()
            _sync(dev)
            timings[stage] = time.perf_counter() - t
        timings["render"] = swarm.render_s
        intra, inter = swarm.loop_closures()
        return {
            "timings_s": timings,
            "keyframes": sum(len(m) for m in swarm.kf_to_pose.values()),
            "keyframe_poses": {r: sorted(m.values())
                               for r, m in swarm.kf_to_pose.items()},
            "intra_loop_closures": intra,
            "inter_loop_closures": inter,
            "verifications": sum(h.log_verifications
                                 for h in swarm.handlers.values()),
            "host_copies": sum(h.log_host_copies
                               for h in swarm.handlers.values()),
            "optimization_count": {rid: n.backend.optimization_count
                                   for rid, n in swarm.nodes.items()},
            "ate": swarm.ate(),
        }
    finally:
        swarm.close()
