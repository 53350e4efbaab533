"""Swarm launcher: spawn per-robot processes over the native TCP bus.

Port of cslam_tpu/launch.py. Each robot process runs a SwarmNode
(loop-closure detection + decentralized PGO) with wall-clock timers at
the configured periods; `--sim` drives the synthetic world so a full
mission runs with zero external input:

    python -m cslam_tpu_torch.launch --robots 3 --duration 30 --sim

Processes communicate only through the C++ TCP bus (no shared memory),
so the same command line distributes across hosts with --hosts. The
frames and messages are the reference's, so robots of this package and
of cslam_tpu can share one swarm.

Where a robot's descriptor databases, MAC selection and pose-graph
solves run is `--device`: the CUDA card by default (a missing card
raises), `--device cpu` on request. Robots are started with the "spawn"
method, never forked: a forked child of a process that has touched CUDA
cannot use the card. The reference's `--platform` and its persistent
XLA compilation cache have no counterpart here (nothing is compiled per
process but the kernel and the C++ runtime libraries, which are built
once per checkout).
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
import time


def robot_main(robot_id: int, args):
    import numpy as np
    import torch
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import WallClock
    from cslam_tpu_torch.config import SwarmConfig, default_params
    from cslam_tpu_torch.device import resolve_device
    from cslam_tpu_torch.frontend.sim import SimSensorHandler, SyntheticWorld
    from cslam_tpu_torch.node import SwarmNode
    from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
    from cslam_tpu_torch.runtime.native import NativeBus, NativeLogger
    from cslam_tpu_torch.utils import checkpoint

    device = resolve_device(args.device)
    if args.config:
        cfg = SwarmConfig.from_yaml(args.config, robot_id=robot_id)
        cfg.max_nb_robots = args.robots
        params = cfg.to_flat_dict()
    else:
        params = default_params(**{
            "robot_id": robot_id,
            "max_nb_robots": args.robots,
            "frontend.similarity_threshold": 0.5,
            # the reference's setting: sim-world candidates below 0.70
            # similarity essentially never pass the 5 m geometric gate,
            # so the verification budget goes to candidates that can
            "frontend.candidate_selection_min_weight": 0.7,
            "frontend.detection_publication_period_sec": 0.5,
            "frontend.inter_robot_detection_period_sec": 2.0,
            "neighbor_management.enable_neighbor_monitoring": True,
            "neighbor_management.init_delay_sec": 0.5,
            "neighbor_management.heartbeat_period_sec": 0.25,
        })

    clock = WallClock()
    bus = NativeBus(robot_id, args.robots, base_port=args.base_port,
                    hosts=args.hosts)
    _wire_native_types(bus)
    logger = None
    node = None
    try:
        if args.log_folder:
            logger = NativeLogger(os.path.join(args.log_folder,
                                               f"robot{robot_id}"))
        if args.trace_dir:
            from cslam_tpu_torch.runtime.tracing import tracer
            tracer.enable(os.path.join(args.trace_dir,
                                       f"trace_robot{robot_id}.json"),
                          pid_label=f"r{robot_id}")

        world = None
        handler = None
        descriptor_model = None
        if args.sim:
            world = SyntheticWorld(args.robots, args.sim_poses,
                                   seed=args.seed)

            class _SimModel:
                def compute_embedding(self, kf_id):
                    return world.descriptor(robot_id, kf_id)

            descriptor_model = _SimModel()

        node = SwarmNode(params, bus, clock,
                         descriptor_model=descriptor_model, logger=logger,
                         device=device)
        if args.sim:
            handler = SimSensorHandler(params, bus, world)
            odom_R, odom_t = world.noisy_odometry(robot_id,
                                                  drift=args.sim_drift)

        # --- crash recovery: restore full SLAM state from a checkpoint
        ckpt_folder = ""
        resumed_from_kf = None
        lcs_at_resume = None
        if args.checkpoint_dir:
            ckpt_folder = os.path.join(args.checkpoint_dir,
                                       f"robot{robot_id}")
        if args.resume and ckpt_folder and \
                os.path.exists(os.path.join(ckpt_folder, "manifest.json")):
            checkpoint.load_node(node, ckpt_folder)
            own_kfs = [k[1] for k in node.backend.odometry_pose_estimates
                       if k[0] == robot_id]
            resumed_from_kf = (max(own_kfs) + 1) if own_kfs else 0
            lcs_at_resume = len(
                node.detection.lcm.candidate_selector.fixed_edges)
            print(f"[r{robot_id}] resumed from checkpoint: "
                  f"{resumed_from_kf} keyframes, {lcs_at_resume} verified "
                  f"loop closures restored", flush=True)

        periods = {
            "publication":
                params["frontend.detection_publication_period_sec"],
            "detection": params["frontend.inter_robot_detection_period_sec"],
            "heartbeat": params["neighbor_management.heartbeat_period_sec"],
            "opt_start":
                params["backend.pose_graph_optimization_start_period_ms"]
                / 1e3,
            "opt_loop":
                params["backend.pose_graph_optimization_loop_period_ms"]
                / 1e3,
        }
        last = {k: 0.0 for k in periods}
        next_kf = resumed_from_kf or 0
        kf_period = args.sim_kf_period
        # anchor the emission clock to now (time.monotonic() is an
        # arbitrary large number, so a 0.0 anchor reads as a maximal
        # backlog and every keyframe would go out at mission start);
        # minus one period so the first keyframe still emits at once
        last_kf = time.monotonic() - kf_period
        last_ckpt = 0.0

        # per-tick latency + convergence instrumentation
        tick_stats = {k: [0, 0.0, 0.0] for k in periods}  # count, sum, max
        slow_ticks = []  # detection ticks > 5 s
        first_opt_time = None
        first_lc_time = None

        start = time.monotonic()
        while time.monotonic() - start < args.duration:
            now = time.monotonic()
            bus.spin_once(timeout_ms=10)
            # catch-up loop: the sensor stream does not pause while this
            # process runs a multi-second broker/optimizer tick — emit
            # every keyframe whose time has passed, capped per iteration
            # so bus servicing still interleaves
            emitted = 0
            while args.sim and next_kf < args.sim_poses and \
                    now - last_kf >= kf_period and emitted < 25:
                node.detection.add_global_descriptor_to_map(
                    world.descriptor(robot_id, next_kf), next_kf)
                bus.publish("cslam/keyframe_odom",
                            msgs.KeyframeOdom(id=next_kf,
                                              pose=(odom_R[next_kf],
                                                    odom_t[next_kf])))
                next_kf += 1
                last_kf += kf_period
                if last_kf < now - 30.0 * kf_period:
                    last_kf = now - 30.0 * kf_period  # bound the backlog
                emitted += 1
            for name, tick in (
                    ("publication", node.tick_detection_publication),
                    ("detection", node.tick_inter_robot_detection),
                    ("heartbeat", node.tick_heartbeat),
                    ("opt_start", node.tick_optimization_start),
                    ("opt_loop", node.tick_optimization_loop)):
                if now - last[name] >= periods[name]:
                    t0 = time.monotonic()
                    tick()
                    dt = time.monotonic() - t0
                    st = tick_stats[name]
                    st[0] += 1
                    st[1] += dt
                    st[2] = max(st[2], dt)
                    last[name] = now
                    if name == "detection" and dt > 5.0:
                        sel = node.detection.lcm.candidate_selector
                        slow_ticks.append({
                            "t_s": round(now - start, 1),
                            "wall_s": round(dt, 2),
                            "candidates": len(sel.candidate_edges),
                            "fixed": len(sel.fixed_edges)})
            if ckpt_folder and now - last_ckpt >= args.checkpoint_period:
                checkpoint.save_node_atomic(node, ckpt_folder)
                last_ckpt = now
            if first_opt_time is None and \
                    node.backend.optimization_count > 0:
                first_opt_time = time.monotonic() - start
            if first_lc_time is None and \
                    node.detection.lcm.candidate_selector.fixed_edges:
                first_lc_time = time.monotonic() - start

        n_est = len(node.backend.current_pose_estimates)
        n_fixed = len(node.detection.lcm.candidate_selector.fixed_edges)
        print(f"[r{robot_id}] done: {next_kf} keyframes, {n_fixed} verified "
              f"loop closures, {node.backend.optimization_count} "
              f"optimizations, {n_est} optimized estimates, "
              f"comm tx={bus.sent_bytes}B rx={bus.received_bytes}B",
              flush=True)
        if logger is not None:
            logger.log_info("nb_keyframes", next_kf)
            logger.log_info("nb_fixed_loop_closures", n_fixed)
            logger.log_info("comm_sent_bytes", bus.sent_bytes)
            logger.write_logs()
        if args.json_out:
            det = node.detection
            metrics = {
                "robot_id": robot_id,
                "keyframes": next_kf,
                "verified_loop_closures": n_fixed,
                "optimizations": node.backend.optimization_count,
                "optimized_estimates": n_est,
                "comm_tx_bytes": bus.sent_bytes,
                "comm_rx_bytes": bus.received_bytes,
                "resumed_from_keyframe": resumed_from_kf,
                "verified_loop_closures_at_resume": lcs_at_resume,
                # broker detection-tick phase breakdown + candidate flow
                "detection_phase_ms": dict(det.tick_phase_ms),
                "detection_ticks": det.n_detection_ticks,
                "candidates_known": len(
                    det.lcm.candidate_selector.candidate_edges),
                "candidates_selected_total": det.log_total_matches_selected,
                "verification_failures": det.log_total_failed_matches,
                "optimization_walls": node.backend.optimization_walls,
                "slow_detection_ticks": slow_ticks,
                "gossip_comm_bytes":
                    det.log_detection_cumulative_communication,
                "first_loop_closure_s": first_lc_time,
                "first_optimization_s": first_opt_time,
                "tick_latency": {
                    k: {"count": c, "mean_ms": (s / c * 1e3) if c else None,
                        "max_ms": m * 1e3}
                    for k, (c, s, m) in tick_stats.items()},
                # where the robot ran ("cuda:0", "cpu"), and its
                # searches on the kernel (launches in this process; 0 on
                # the CPU)
                "device": str(torch.empty(0, device=device).device),
                "knn_launches": dict(cosine_topk_pallas.launches),
            }
            if args.sim:
                # ground-truth verification record + candidate weights
                # at verification time
                metrics["sim_verification_log"] = handler.verification_log
                metrics["sim_verification_gate_m"] = \
                    handler.verification_gate
                metrics["verification_outcome_weights"] = \
                    det.verification_outcomes
                from cslam_tpu_torch.utils.evaluation import ate_rmse
                gt_R, gt_t = world.trajectories[robot_id]
                est = node.backend.current_pose_estimates
                own = sorted(k for k in est if k[0] == robot_id)
                metrics["ate_odometry_m"] = float(
                    ate_rmse(odom_t[:next_kf], gt_t[:next_kf]))
                if len(own) > 3:
                    est_t = np.stack([est[k][1] for k in own])
                    gt_rows = np.stack([gt_t[k[1]] for k in own])
                    metrics["ate_optimized_m"] = float(
                        ate_rmse(est_t, gt_rows))
                else:
                    metrics["ate_optimized_m"] = None
            os.makedirs(args.json_out, exist_ok=True)
            with open(os.path.join(args.json_out,
                                   f"robot{robot_id}.json"), "w") as f:
                json.dump(metrics, f, indent=2)
    finally:
        if node is not None:
            node.close()
        if logger is not None:
            logger.close()
        bus.close()
    return 0


def _wire_native_types(bus):
    """Register message types per topic family for deserialization."""
    from cslam_tpu_torch.comm import messages as msgs
    orig_subscribe = bus.subscribe
    topic_types = {
        "cslam/heartbeat": msgs.Heartbeat,
        "cslam/keyframe_odom": msgs.KeyframeOdom,
        "cslam/get_current_neighbors": None,
        "cslam/current_neighbors": msgs.RobotIdsAndOrigin,
        "cslam/get_pose_graph": msgs.RobotIds,
        "cslam/pose_graph": msgs.PoseGraph,
        "cslam/optimized_estimates": msgs.OptimizationResult,
        "cslam/global_descriptors": msgs.GlobalDescriptors,
        "cslam/inter_robot_matches": msgs.InterRobotMatches,
        "cslam/inter_robot_loop_closure": msgs.InterRobotLoopClosure,
        "cslam/intra_robot_loop_closure": msgs.IntraRobotLoopClosure,
        "cslam/local_keyframe_match": msgs.LocalKeyframeMatch,
        "cslam/local_descriptors_request": msgs.LocalDescriptorsRequest,
        "cslam/sim_local_descriptors": msgs.LocalDescriptorsRequest,
        "cslam/local_descriptors": msgs.LocalImageDescriptors,
        "cslam/processed_global_descriptor": msgs.GlobalDescriptor,
        "cslam/print_current_estimates": None,
    }

    def subscribe(topic, callback, msg_type="auto"):
        if msg_type == "auto":
            suffix = topic.split("cslam/")[-1]
            msg_type = topic_types.get(f"cslam/{suffix}")
        orig_subscribe(topic, callback, msg_type)

    bus.subscribe = subscribe


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--robots", type=int, default=2)
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--duration", type=float, default=20.0)
    parser.add_argument("--base-port", type=int, default=17700)
    parser.add_argument("--hosts", type=str, default="",
                        help="comma-separated IPv4 per robot id")
    parser.add_argument("--log-folder", type=str, default="")
    parser.add_argument("--json-out", type=str, default="",
                        help="write per-robot metrics JSON into this dir")
    parser.add_argument("--trace-dir", type=str, default="",
                        help="write per-robot chrome-trace JSON here "
                             "(open in chrome://tracing or Perfetto)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the robots' searches, "
                             "selection and solves (cuda or cpu)")
    parser.add_argument("--sim", action="store_true",
                        help="drive the synthetic world")
    parser.add_argument("--sim-poses", type=int, default=24)
    parser.add_argument("--sim-drift", type=float, default=0.02)
    parser.add_argument("--sim-kf-period", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--robot-id", type=int, default=-1,
                        help="run a single robot in this process "
                             "(multi-host deployment)")
    parser.add_argument("--checkpoint-dir", type=str, default="",
                        help="periodically checkpoint full SLAM state "
                             "into <dir>/robot<id> (crash recovery)")
    parser.add_argument("--checkpoint-period", type=float, default=2.0)
    parser.add_argument("--resume", action="store_true",
                        help="restore state from --checkpoint-dir at "
                             "startup if a checkpoint exists")
    args = parser.parse_args(argv)

    if args.robot_id >= 0:
        return robot_main(args.robot_id, args)

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=robot_main, args=(rid, args))
        for rid in range(args.robots)
    ]
    for p in procs:
        p.start()
    code = 0
    for p in procs:
        p.join()
        code |= p.exitcode or 0
    return code


if __name__ == "__main__":
    sys.exit(main())
