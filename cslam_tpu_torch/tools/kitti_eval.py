"""Real-dataset end-to-end evaluation on the port: dataset -> full swarm
pipeline -> ATE/comm/time JSON in one command.

Port of benchmarks/kitti_eval.py:

    python -m cslam_tpu_torch.tools.kitti_eval --data <poses file or
        sequence dir> --robots 5 [--format kitti|tum] [--kf-distance 2.0]
        [--drift 0.01] [--budget 8] [--images DIR --model shipped]
        [--out cslam_tpu_torch/_build/KITTI_EVAL.json] [--cpu]

A sequence is split into contiguous per-robot segments (the standard
multi-robot KITTI protocol); each robot runs the swarm stack through
`SwarmNode`: distance-gated keyframes, global-descriptor gossip, kNN
matching (on the card the cosine top-k kernel), MAC budgeted selection,
broker vertex cover, verification with covariance, decentralized GNC-LM
PGO. ATE is computed per robot and merged, before and after
optimization. Everything runs on the CUDA card unless `--cpu` is given.

Descriptors: with --images + --model a CNN (the port's CosPlace, the
frames read by the port's image_sequence) is built; without image data,
descriptors are place-dependent features of the ground-truth position
with observation noise. Verification: ground-truth relative pose gated
by distance, with measurement noise and its covariance on each loop
closure (the sim handler path).

The JSON holds the reference's fields plus `platform` (the device the
swarm ran on) and `knn_launches` (the kernel's launches during the
run, per kernel).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.decentralized_pgo import OptimizerState
from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
    ManualClock
from cslam_tpu_torch.device import resolve_device
from cslam_tpu_torch.frontend.sim import SimSensorHandler
from cslam_tpu_torch.node import SwarmNode
from cslam_tpu_torch.ops import knn_pallas
from cslam_tpu_torch.utils import datasets
from cslam_tpu_torch.utils.evaluation import ate_rmse

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_PKG, "_build", "KITTI_EVAL.json")
# a solve that takes longer is a stall: its future raises TimeoutError
SOLVE_TIMEOUT_S = 600.0


class DatasetWorld:
    """SyntheticWorld-compatible view of a real sequence: per-robot
    global-frame keyframed ground truth (the global frame keeps place
    descriptors and verification geometry consistent across robots)."""

    def __init__(self, R, t, n_robots, kf_distance=2.0, seed=0,
                 descriptor_dim=64, place_scale=15.0,
                 descriptor_noise=0.05):
        self.n_robots = n_robots
        self.descriptor_dim = descriptor_dim
        self.place_scale = place_scale
        self.descriptor_noise = descriptor_noise
        rng = np.random.default_rng(seed)
        self._rng = rng
        self._proj = rng.standard_normal((3, descriptor_dim)).astype(
            np.float32)
        self._phase = rng.uniform(0, 2 * np.pi, descriptor_dim).astype(
            np.float32)
        bounds = np.linspace(0, len(t), n_robots + 1).astype(int)
        self.trajectories = {}
        self.frame_index = {}  # keyframe -> original sequence frame
        for rid in range(n_robots):
            Rs = R[bounds[rid]:bounds[rid + 1]]
            ts = t[bounds[rid]:bounds[rid + 1]]
            keep = [0]
            for k in range(1, len(ts)):
                if np.linalg.norm(ts[k] - ts[keep[-1]]) >= kf_distance:
                    keep.append(k)
            self.trajectories[rid] = (Rs[keep].astype(np.float32),
                                      ts[keep].astype(np.float32))
            self.frame_index[rid] = bounds[rid] + np.asarray(keep)

    def n_poses_of(self, rid):
        return len(self.trajectories[rid][1])

    def pose(self, rid, kf_id):
        Rs, ts = self.trajectories[rid]
        return Rs[kf_id], ts[kf_id]

    def descriptor(self, rid, kf_id):
        _, ts = self.trajectories[rid]
        feat = np.sin(ts[kf_id] @ self._proj / self.place_scale +
                      self._phase)
        feat = feat + self._rng.standard_normal(
            self.descriptor_dim).astype(np.float32) * self.descriptor_noise
        return (feat / np.linalg.norm(feat)).astype(np.float32)

    def noisy_odometry(self, rid, drift=0.0, seed=None):
        rng = np.random.default_rng(seed if seed is not None else rid + 100)
        Rs, ts = self.trajectories[rid]
        out_R, out_t = [Rs[0]], [ts[0]]
        for k in range(1, len(ts)):
            dR = Rs[k - 1].T @ Rs[k]
            dt = Rs[k - 1].T @ (ts[k] - ts[k - 1])
            if drift > 0:
                dt = dt + rng.standard_normal(3).astype(np.float32) * \
                    drift * max(np.linalg.norm(dt), 0.1)
            out_R.append((out_R[-1] @ dR).astype(np.float32))
            out_t.append((out_R[-2] @ dt + out_t[-1]).astype(np.float32))
        return np.stack(out_R), np.stack(out_t)


class CnnDescriptorModel:
    """Real-image descriptor path: per-keyframe CNN embeddings through
    the image-sequence readers (utils/image_sequence.py). --images may
    be a KITTI odometry sequence directory (image_2/ + times + calib),
    a plain directory of images, or a glob. --model picks the weights:
    a CosPlace checkpoint path (.npz), or 'shipped' for the self-trained
    weights. The network runs on `device`."""

    def __init__(self, images, checkpoint, device=None):
        from cslam_tpu_torch.models.cosplace import CosPlace
        from cslam_tpu_torch.utils.image_sequence import open_sequence
        self.model = CosPlace(
            {"frontend.nn_checkpoint": checkpoint or "shipped"},
            device=device)
        self.seq = open_sequence(images)

    def embedding_for_frame(self, frame_index):
        return self.model.compute_embedding(self.seq.frame(frame_index))


def make_params(robot_id, n_robots, budget):
    return {
        "robot_id": robot_id,
        "max_nb_robots": n_robots,
        "frontend.similarity_threshold": 0.5,
        "frontend.global_descriptor_technique": "dataset",
        "frontend.inter_robot_loop_closure_budget": budget,
        "frontend.nb_best_matches": 10,
        "frontend.intra_loop_min_inbetween_keyframes": 10,
        "frontend.detection_publication_max_elems_per_msg": 16,
        "frontend.enable_intra_robot_loop_closures": False,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "frontend.sensor_type": "dataset",
        "backend.max_waiting_time_sec": 60.0,
        "neighbor_management.enable_neighbor_monitoring": False,
        "neighbor_management.init_delay_sec": 0.0,
        "neighbor_management.max_heartbeat_delay_sec": 5.0,
        "evaluation.enable_logs": False,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": "",
    }


def run_eval(R, t, n_robots, kf_distance=2.0, drift=0.01, budget=8,
             detection_rounds=5, gate=6.0, measurement_noise=0.01,
             seed=0, cnn_model=None, device=None):
    """The evaluation on `device` (None: the CUDA card). Every node's
    solver thread is shut down before it returns, also on failure."""
    dev = resolve_device(device)
    launches = knn_pallas.cosine_topk_pallas.launches
    launches_before = dict(launches)
    world = DatasetWorld(R, t, n_robots, kf_distance=kf_distance,
                         seed=seed)
    router = InProcessRouter()
    clock = ManualClock()
    # full-depth GNC anneal — see lidar_mission_bench on the outer cap
    cfg = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80,
                        use_chordal_init=True)
    nodes, handlers, odom = {}, {}, {}

    class _Model:
        def __init__(self, rid):
            self.rid = rid

        def compute_embedding(self, kf_id):
            if cnn_model is not None:
                return cnn_model.embedding_for_frame(
                    int(world.frame_index[self.rid][kf_id]))
            return world.descriptor(self.rid, kf_id)

    for rid in range(n_robots):
        bus = InProcessBus(router, rid)
        params = make_params(rid, n_robots, budget)
        nodes[rid] = SwarmNode(params, bus, clock,
                               descriptor_model=_Model(rid),
                               pgo_config=cfg, device=dev)
        handlers[rid] = SimSensorHandler(
            params, bus, world, verification_gate=gate,
            measurement_noise=measurement_noise)
        odom[rid] = world.noisy_odometry(rid, drift=drift)

    try:
        t0 = time.perf_counter()
        # 1. feed keyframes (per-robot lengths differ on real data)
        max_len = max(world.n_poses_of(r) for r in range(n_robots))
        for kf in range(max_len):
            for rid, node in nodes.items():
                if kf >= world.n_poses_of(rid):
                    continue
                node.detection.add_global_descriptor_to_map(
                    world.descriptor(rid, kf), kf)
                node.bus.publish(
                    "cslam/keyframe_odom",
                    msgs.KeyframeOdom(id=kf, pose=(odom[rid][0][kf],
                                                   odom[rid][1][kf])))
            router.spin_until_idle()
        # 2. gossip + budgeted detection
        for _ in range(detection_rounds):
            for node in nodes.values():
                node.tick_detection_publication()
            router.spin_until_idle()
            for node in nodes.values():
                node.tick_inter_robot_detection()
            router.spin_until_idle(max_rounds=2000)
        t_pipeline = time.perf_counter()

        # 3. decentralized optimization rounds
        for _ in range(40):
            for node in nodes.values():
                node.tick_optimization_start()
            router.spin_until_idle()
            for node in nodes.values():
                node.tick_optimization_loop()
            router.spin_until_idle()
            for node in nodes.values():
                be = node.backend
                if be.optimizer_state == OptimizerState.OPTIMIZATION and \
                        be._optimization_future is not None:
                    be._optimization_future.result(
                            timeout=SOLVE_TIMEOUT_S)
                    be.check_result_and_finish_optimization()
            router.spin_until_idle()
            if any(n.backend.optimization_count > 0 for n in nodes.values()):
                for node in nodes.values():
                    node.tick_optimization_loop()
                router.spin_until_idle()
                break
        t_opt = time.perf_counter()

        # 4. metrics
        n_fixed = max(len(n.detection.lcm.candidate_selector.fixed_edges)
                      for n in nodes.values())
        comm = sum(n.detection.log_detection_cumulative_communication
                   for n in nodes.values())
        ates_odom, ates_opt, lengths = [], [], []
        for rid in range(n_robots):
            gt_t = world.trajectories[rid][1]
            lengths.append(len(gt_t))
            ates_odom.append(ate_rmse(odom[rid][1], gt_t))
            est = nodes[rid].backend.current_pose_estimates
            own = sorted(k for k in est if k[0] == rid)
            if len(own) == len(gt_t):
                est_t = np.stack([est[k][1] for k in own])
                ates_opt.append(ate_rmse(est_t, gt_t))
        # merged ATE: ONE global alignment over all robots' trajectories —
        # the multi-robot protocol's actual score (per-robot alignment hides
        # inter-robot misalignment, which is what the swarm corrects)
        gt_all = np.concatenate([world.trajectories[r][1]
                                 for r in range(n_robots)])
        odom_all = np.concatenate([odom[r][1] for r in range(n_robots)])
        ate_merged_odom = ate_rmse(odom_all, gt_all)
        opt_est = max((n.backend.current_pose_estimates
                       for n in nodes.values()), key=len)
        est_rows, gt_rows = [], []
        for rid in range(n_robots):
            for kf in range(world.n_poses_of(rid)):
                if (rid, kf) in opt_est:
                    est_rows.append(opt_est[(rid, kf)][1])
                    gt_rows.append(world.trajectories[rid][1][kf])
        ate_merged_opt = ate_rmse(np.stack(est_rows), np.stack(gt_rows)) \
            if len(est_rows) > 3 else None
        return {
            "ate_rmse_merged_odometry_m": float(ate_merged_odom),
            "ate_rmse_merged_optimized_m": float(ate_merged_opt)
            if ate_merged_opt is not None else None,
            "ate_merged_improvement": float(ate_merged_odom / ate_merged_opt)
            if ate_merged_opt else None,
            "n_robots": n_robots,
            "keyframes_per_robot": lengths,
            "verified_loop_closures": n_fixed,
            "pipeline_wall_s": t_pipeline - t0,
            "optimization_wall_s": t_opt - t_pipeline,
            "gossip_comm_bytes": comm,
            "ate_rmse_odometry_m": float(np.mean(ates_odom)),
            "ate_rmse_optimized_m": float(np.mean(ates_opt))
            if ates_opt else None,
            "ate_improvement": float(np.mean(ates_odom) / np.mean(ates_opt))
            if ates_opt else None,
            "optimizations": max(n.backend.optimization_count
                                 for n in nodes.values()),
            "platform": dev.type,
            "knn_launches": {k: n - launches_before[k]
                             for k, n in launches.items()},
        }
    finally:
        for node in nodes.values():
            node.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="KITTI poses .txt / TUM trajectory / sequence dir")
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--format", choices=["kitti", "tum"], default="kitti")
    ap.add_argument("--kf-distance", type=float, default=2.0)
    ap.add_argument("--drift", type=float, default=0.01)
    ap.add_argument("--budget", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--gate", type=float, default=6.0)
    ap.add_argument("--noise", type=float, default=0.01,
                    help="loop-closure measurement noise (m)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", default="",
                    help="KITTI sequence dir / image dir / glob: real "
                         "CNN descriptors per keyframe")
    ap.add_argument("--model", default="",
                    help="CosPlace checkpoint (.npz; default: shipped "
                         "self-trained weights)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    path = args.data
    if os.path.isdir(path):  # sequence dir: KITTI poses or TUM groundtruth
        for cand in ("poses.txt", "00.txt", "groundtruth.txt"):
            if os.path.exists(os.path.join(path, cand)):
                path = os.path.join(path, cand)
                if cand == "groundtruth.txt":  # TUM layout
                    args.format = "tum"
                break
    if args.format == "tum":
        _, R, t = datasets.load_tum_trajectory(path)
    else:
        R, t = datasets.load_kitti_poses(path)
    print(f"loaded {len(t)} poses from {path}", file=sys.stderr)

    cnn = CnnDescriptorModel(args.images, args.model, device) \
        if args.images else None
    results = run_eval(R, t, args.robots, kf_distance=args.kf_distance,
                       drift=args.drift, budget=args.budget,
                       detection_rounds=args.rounds, gate=args.gate,
                       measurement_noise=args.noise, seed=args.seed,
                       cnn_model=cnn, device=device)
    results["source"] = os.path.abspath(path)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    sys.exit(main())
