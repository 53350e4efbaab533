"""Entry points: the flagship forward and the multi-device dry run.

Port of the repository's `__graft_entry__.py`.

entry() returns the flagship model (CosPlace GeoLocalizationNet
descriptor extraction, the per-keyframe hot CNN) and an example input.

dryrun_multichip(n) makes an n-rank mesh (`parallel/mesh.py`) and runs
ONE swarm pipeline step over it at the reference's tiny shapes:
  data-parallel descriptor inference (batch split over the ranks)
  -> row-sharded cosine kNN matching (all-gather merge; on the card
     every rank searches its shard with the hand-written kernel)
  -> factor-parallel distributed GNC-LM PGO (all-reduced normal
     equations)
  -> the elastic swarm protocol, every elected optimizer solving on the
     same mesh.

    python -m cslam_tpu_torch.entry N [--backend gloo] [--cpu]

runs it on N ranks: NCCL with one card per rank by default, `--backend
gloo` for every rank on one card, `--cpu` for gloo ranks on the CPU.
"""

import argparse
import os
import sys
import tempfile
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device

PROTOCOL_SOLVE_TIMEOUT_S = 600.0  # one mesh solve of the protocol run


def entry(device: DeviceLike = None):
    """(model, example_args): GeoLocalizationNet(fc_output_dim=64) with
    Flax-default random weights, and a (4, 224, 224, 3) input, on
    `device` (None = the CUDA card)."""
    from cslam_tpu_torch.models.cosplace import GeoLocalizationNet, \
        flax_init_
    dev = resolve_device(device)
    model = flax_init_(GeoLocalizationNet(fc_output_dim=64), 0).eval()
    images = torch.zeros((4, 224, 224, 3), dtype=torch.float32, device=dev)
    return model.to(dev), (images,)


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: str = None) -> Dict:
    """One full multi-device swarm step on tiny shapes over a real mesh
    of n_devices ranks (see make_swarm_mesh for device and backend).
    Returns the step's outputs; raises on any failure."""
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.backend.factor_graph import (BetweenFactor,
                                                      FactorGraph,
                                                      diag_sqrt_info)
    from cslam_tpu_torch.models.cosplace import GeoLocalizationNet, \
        flax_init_
    from cslam_tpu_torch.ops import se3
    from cslam_tpu_torch.parallel import distributed_pgo, make_swarm_mesh
    from cslam_tpu_torch.parallel.sharded_knn import sharded_cosine_topk

    rng = np.random.default_rng(0)
    with make_swarm_mesh(n_devices, device=device, backend=backend) as mesh:
        axis = mesh.axis_name
        dev = mesh.device

        # --- stage 1: data-parallel descriptor inference -------------
        batch = max(n_devices, 2 * n_devices)
        images = torch.from_numpy(rng.standard_normal(
            (batch, 32, 32, 3)).astype(np.float32)).to(dev)
        model = flax_init_(GeoLocalizationNet(fc_output_dim=64), 0)
        model = model.eval().to(dev)
        handle = mesh.replicate_module(model, GeoLocalizationNet,
                                       fc_output_dim=64)
        descriptors = mesh.data_parallel(handle, images)

        # --- stage 2: sharded kNN matching (db rows over the mesh) ----
        D = descriptors.shape[-1]
        n_rows = 16 * n_devices
        db = torch.from_numpy(rng.standard_normal(
            (n_rows, D)).astype(np.float32)).to(dev)
        idx, sims = sharded_cosine_topk(mesh, db, n_rows - 3, descriptors,
                                        4, axis_name=axis)

        # --- stage 3: factor-parallel distributed PGO ------------------
        fg = FactorGraph()
        sq = diag_sqrt_info([0.01] * 3 + [0.05] * 3)
        n_poses = 12
        fg.add_node((0, 0), np.eye(3, dtype=np.float32),
                    np.zeros(3, dtype=np.float32))
        for k in range(n_poses - 1):
            xi = rng.standard_normal(6).astype(np.float32) * 0.2
            dR, dt = se3.se3_exp(torch.from_numpy(xi))
            fg.add_between(BetweenFactor((0, k), (0, k + 1), dR.numpy(),
                                         dt.numpy(), sq))
        fg.add_between(BetweenFactor((0, 0), (0, n_poses - 1),
                                     np.eye(3, dtype=np.float32),
                                     np.zeros(3, dtype=np.float32), sq,
                                     is_loop=True))
        fg.set_prior((0, 0))
        cfg = pgo.PGOConfig(lm_max_iters=3, cg_max_iters=10,
                            gnc_max_outer_iters=2)
        g = fg.to_arrays(edge_bucket_multiple=n_devices, device=dev)
        result = distributed_pgo.distributed_gnc_optimize(mesh, g, cfg,
                                                          axis_name=axis)
        if not bool(torch.isfinite(result.t).all()):
            raise AssertionError("the distributed solve is not finite")

        # --- stage 4: the protocol layer on the mesh -------------------
        run = _dryrun_protocol_on_mesh(mesh, axis, n_devices)
    print(f"dryrun_multichip({n_devices}): ok — {mesh.backend} on "
          f"{[str(d) for d in mesh.devices]}, descriptors "
          f"{tuple(descriptors.shape)}, knn top{idx.shape[-1]}, pgo cost "
          f"{float(result.cost):.4f}, elastic protocol: 3 optimizations "
          f"(optimizers r{run.optimizers[0]}, r{run.optimizers[1]} after "
          f"r0 died, r{run.optimizers[2]} after it rejoined), "
          f"{run.shared_estimates} consistent shared estimates", flush=True)
    return {"descriptors": descriptors, "knn": (idx, sims),
            "pgo": result, "protocol": run}


class ProtocolRun(NamedTuple):
    survivor_optimizer: int   # elected while robot 0 was dead
    shared_estimates: int     # consistent shared keys over the 3 solves
    optimizers: List[int]     # the elected optimizer of each solve
    estimates: Dict           # robot -> {key: (R, t)} after the run


def _dryrun_protocol_on_mesh(mesh, axis, n_devices, n_robots=None,
                             n_poses=8):
    """Elastic protocol on the mesh: gossip -> detection -> election ->
    mesh-sharded distributed solve -> estimate sharing, then ROBOT 0
    (the elected broker + optimizer) dies mid-run, the survivors elect
    a new optimizer and complete a SECOND solve, and robot 0 rejoins
    with consistent estimates (the reference's schedule and assertions).
    n_robots defaults to max(n_devices, 3). Every robot's node runs on
    the mesh's device; every solve future is waited on with a timeout
    and every node is closed."""
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.backend.decentralized_pgo import OptimizerState
    from cslam_tpu_torch.comm import messages as msgs
    from cslam_tpu_torch.comm.bus import (InProcessBus, InProcessRouter,
                                          ManualClock)
    from cslam_tpu_torch.comm.rendezvous import SimulatedRendezVous
    from cslam_tpu_torch.frontend.sim import SimSensorHandler, \
        SyntheticWorld
    from cslam_tpu_torch.node import SwarmNode
    from cslam_tpu_torch.parallel import distributed_pgo

    n_robots = n_robots or max(n_devices, 3)

    def mesh_solver(fg, cfg):
        g = fg.to_arrays(edge_bucket_multiple=n_devices, device=mesh.device)
        result = distributed_pgo.distributed_gnc_optimize(mesh, g, cfg,
                                                          axis_name=axis)
        fg.update_estimates(result.R, result.t)
        return result

    router = InProcessRouter()
    clock = ManualClock()
    world = SyntheticWorld(n_robots, n_poses, seed=0)

    class _Model:
        def __init__(self, rid):
            self.rid = rid

        def compute_embedding(self, kf_id):
            return world.descriptor(self.rid, kf_id)

    params_base = {
        "frontend.similarity_threshold": 0.5,
        "frontend.global_descriptor_technique": "simulated",
        "frontend.inter_robot_loop_closure_budget": 4,
        "frontend.nb_best_matches": 8,
        "frontend.intra_loop_min_inbetween_keyframes": 6,
        "frontend.detection_publication_max_elems_per_msg": 8,
        "frontend.enable_intra_robot_loop_closures": False,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "frontend.sensor_type": "stereo",
        "backend.max_waiting_time_sec": 5.0,
        # heartbeat-based liveness, so the run changes membership
        "neighbor_management.enable_neighbor_monitoring": True,
        "neighbor_management.init_delay_sec": 0.5,
        "neighbor_management.max_heartbeat_delay_sec": 2.0,
        "evaluation.enable_logs": False,
        "evaluation.enable_simulated_rendezvous": False,
        "evaluation.rendezvous_schedule_file": "",
    }
    cfg = pgo.PGOConfig(lm_max_iters=4, cg_max_iters=15,
                        gnc_max_outer_iters=2)
    # robot 0 dies at t=6 and returns at t=20 (the hardest member to
    # lose: it is both the gossip broker and the elected optimizer)
    fd, sched = tempfile.mkstemp(suffix=".csv")
    with os.fdopen(fd, "w") as f:
        f.write("0,0.0,6.0,20.0,1000.0\n")
        f.write("".join(f"{r},0.0,1000.0\n" for r in range(1, n_robots)))
    nodes, handlers, odom, rendezvous = {}, {}, {}, {}
    try:
        for rid in range(n_robots):
            params = dict(params_base, robot_id=rid, max_nb_robots=n_robots)
            bus = InProcessBus(router, rid)
            nodes[rid] = SwarmNode(params, bus, clock,
                                   descriptor_model=_Model(rid),
                                   pgo_config=cfg, solver=mesh_solver,
                                   device=mesh.device)
            handlers[rid] = SimSensorHandler(params, bus, world,
                                             verification_gate=4.0)
            odom[rid] = world.noisy_odometry(rid, drift=0.02)
            rendezvous[rid] = SimulatedRendezVous(clock, sched, rid,
                                                  enabled=True)
        return _run_protocol(nodes, odom, rendezvous, router, clock, world,
                             n_robots, n_poses, msgs, OptimizerState)
    finally:
        os.unlink(sched)
        for node in nodes.values():
            node.close()


def _run_protocol(nodes, odom, rendezvous, router, clock, world, n_robots,
                  n_poses, msgs, OptimizerState) -> ProtocolRun:
    def alive():
        return [r for r in range(n_robots) if rendezvous[r].is_alive()]

    def heartbeat_round(dt=1.0):
        for rid in alive():
            nodes[rid].tick_heartbeat()
        router.spin_until_idle()
        clock.advance(dt)

    def run_optimization_round(max_rounds=25):
        """Tick live nodes through election -> collection -> solve ->
        sharing; returns the robot that completed an optimization."""
        live = alive()
        counts0 = {r: nodes[r].backend.optimization_count for r in live}
        for _ in range(max_rounds):
            for r in live:
                nodes[r].tick_optimization_start()
            router.spin_until_idle()
            for r in live:
                nodes[r].tick_optimization_loop()
            router.spin_until_idle()
            for r in live:
                be = nodes[r].backend
                if be.optimizer_state == OptimizerState.OPTIMIZATION and \
                        be._optimization_future is not None:
                    be._optimization_future.result(
                        timeout=PROTOCOL_SOLVE_TIMEOUT_S)
                    be.check_result_and_finish_optimization()
            router.spin_until_idle()
            done = [r for r in live
                    if nodes[r].backend.optimization_count > counts0[r]]
            if done:
                for r in live:
                    nodes[r].tick_optimization_loop()
                router.spin_until_idle()
                if len(done) != 1:
                    raise AssertionError(f"expected one elected optimizer, "
                                         f"got {done}")
                return done[0]
        raise AssertionError("no optimization completed")

    def check_consistency(elected, live):
        """Every live robot agrees with the optimizer on shared keys."""
        opt_est = nodes[elected].backend.current_pose_estimates
        if not opt_est:
            raise AssertionError("optimizer produced no estimates")
        shared = 0
        for rid in live:
            est = nodes[rid].backend.current_pose_estimates
            own = [k for k in est if k[0] == rid]
            if not own:
                raise AssertionError(f"robot {rid} received no estimates "
                                     f"for itself")
            for k in own:
                if k in opt_est:
                    np.testing.assert_allclose(est[k][1], opt_est[k][1],
                                               atol=1e-5)
                    shared += 1
            for (R, t) in est.values():
                if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
                    raise AssertionError(f"robot {rid}: non-finite "
                                         f"estimate")
        return shared

    # ---- phase 1: everyone alive — ingest, detect, first solve -------
    for _ in range(3):
        heartbeat_round()
    for kf in range(n_poses):
        for rid, node in nodes.items():
            node.detection.add_global_descriptor_to_map(
                world.descriptor(rid, kf), kf)
            node.bus.publish(
                "cslam/keyframe_odom",
                msgs.KeyframeOdom(id=kf, pose=(odom[rid][0][kf],
                                               odom[rid][1][kf])))
        router.spin_until_idle()
    for _ in range(3):
        for rid in alive():
            nodes[rid].tick_detection_publication()
        router.spin_until_idle()
        for rid in alive():
            nodes[rid].tick_inter_robot_detection()
        router.spin_until_idle(max_rounds=4000)
        heartbeat_round(dt=0.5)
    if not any(len(n.detection.lcm.candidate_selector.fixed_edges) > 0
               for n in nodes.values()):
        raise AssertionError("no verified loop closures")
    elected1 = run_optimization_round()
    if elected1 != 0:
        raise AssertionError(f"full-swarm optimizer should be r0, got "
                             f"r{elected1}")
    shared1 = check_consistency(elected1, alive())

    # ---- phase 2: robot 0 dies; survivors re-elect and solve again ---
    while clock.now() < 7.0:
        heartbeat_round()
    for _ in range(4):  # decay past max_heartbeat_delay_sec
        heartbeat_round()
    if rendezvous[0].is_alive():
        raise AssertionError("robot 0 should be dead at t=7")
    _, in_range = nodes[1].detection.neighbor_manager \
        .check_neighbors_in_range()
    if 0 in in_range or set(in_range) != set(range(1, n_robots)):
        raise AssertionError(f"survivors in range: {in_range}")
    # survivors keep detecting (new broker = lowest alive id = r1)
    for rid in alive():
        nodes[rid].tick_detection_publication()
    router.spin_until_idle()
    for rid in alive():
        nodes[rid].tick_inter_robot_detection()
    router.spin_until_idle(max_rounds=4000)
    elected2 = run_optimization_round()
    if elected2 == 0:
        raise AssertionError("dead robot elected optimizer")
    shared2 = check_consistency(elected2, alive())

    # ---- phase 3: robot 0 rejoins and regains liveness + estimates ---
    while clock.now() < 20.0:
        clock.advance(1.0)
    for _ in range(3):
        heartbeat_round()
    if not rendezvous[0].is_alive():
        raise AssertionError("robot 0 should be back at t=20")
    _, in_range = nodes[1].detection.neighbor_manager \
        .check_neighbors_in_range()
    if set(in_range) != set(range(n_robots)):
        raise AssertionError(f"returning robot not re-detected: "
                             f"{in_range}")
    elected3 = run_optimization_round()
    shared3 = check_consistency(elected3, alive())
    if not any(k[0] == 0 for k in nodes[0].backend.current_pose_estimates):
        raise AssertionError("rejoined robot has no estimates for itself")
    return ProtocolRun(
        elected2, shared1 + shared2 + shared3, [elected1, elected2, elected3],
        {r: dict(nodes[r].backend.current_pose_estimates)
         for r in range(n_robots)})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=8,
                        help="ranks of the mesh")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="default: nccl on the card, gloo on the CPU")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device="cpu" if args.cpu else None,
                     backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
