"""The swarm's device path in one call: descriptor kNN -> MAC selection ->
GNC-LM PGO over a synthetic multi-robot world.

This drives the same library entry points the swarm protocol drives
(`LoopClosureSparseMatching`, its MAC-backed `select_candidates`,
`FactorGraph` and `pgo.optimize`), without the bus, election and
message layers, which do no device work:

1. every robot's keyframe descriptors go into ONE broker's matcher
   (robot 0): its own through `add_local_global_descriptor`, the
   others' through `add_other_robot_global_descriptor`, keyframe-major
   as the sim mission feeds them; each add runs a best-match search;
2. `rounds` rounds of budgeted selection over all robots; each selected
   candidate is verified by the simulator's ground-truth measurement
   (success iff the true distance is under `gate`), and successes become
   fixed edges and loop-closure factors;
3. one factor graph of every robot's drifted odometry plus the verified
   loop closures, with a prior on robot 0's first pose, is optimized by
   GNC-LM; ATE (aligned RMSE) of odometry and of the estimate against
   ground truth measures the result.
"""

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.factor_graph import (BetweenFactor, FactorGraph,
                                                  diag_sqrt_info)
from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.sim import SyntheticWorld, measure
from cslam_tpu_torch.matching.sparse_matching import LoopClosureSparseMatching
from cslam_tpu_torch.utils.evaluation import ate_rmse

# the reference back-end's default odometry noise ([omega, v] sigmas)
ODOM_NOISE_STD = np.array([0.01, 0.01, 0.01, 0.1, 0.1, 0.1], np.float32)
# the sim handler stamps max(measurement_noise, 1e-3)^2 as covariance
LOOP_NOISE_STD = np.full(6, 1e-3, np.float32)
# the sim mission's solver settings (full GNC anneal depth)
SLICE_PGO = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)
# the sim mission's selection budget per round, verification gate (m)
# and odometry drift (per-step tangent sigma)
BUDGET = 5
GATE_M = 4.0
DRIFT = 0.02


class DescriptorMsg(NamedTuple):
    robot_id: int
    keyframe_id: int
    descriptor: np.ndarray


def make_params(robot_id: int, max_nb_robots: int, budget: int = 5,
                nns_method: str = "auto") -> Dict:
    """The sim mission's front-end parameters."""
    return {
        "robot_id": robot_id,
        "max_nb_robots": max_nb_robots,
        "frontend.similarity_threshold": 0.5,
        "frontend.global_descriptor_technique": "simulated",
        "frontend.inter_robot_loop_closure_budget": budget,
        "frontend.nb_best_matches": 10,
        "frontend.intra_loop_min_inbetween_keyframes": 6,
        "frontend.enable_intra_robot_loop_closures": False,
        "frontend.enable_sparsification": True,
        "frontend.use_vertex_cover_selection": True,
        "frontend.sensor_type": "stereo",
        "frontend.nns_method": nns_method,
        "evaluation.enable_sparsification_comparison": False,
    }


def world_descriptors(world: SyntheticWorld) -> np.ndarray:
    """(n_poses, n_robots, dim) descriptors drawn keyframe-major (the
    order in which the sim mission observes them)."""
    return np.stack([np.stack([world.descriptor(rid, kf)
                               for rid in range(world.n_robots)])
                     for kf in range(world.n_poses)])


def ingest(lcm: LoopClosureSparseMatching, descriptors: np.ndarray):
    """Feed all descriptors to the broker's matcher (robot 0's view)."""
    me = lcm.params["robot_id"]
    for kf in range(descriptors.shape[0]):
        for rid in range(descriptors.shape[1]):
            if rid == me:
                lcm.add_local_global_descriptor(descriptors[kf, rid], kf)
            else:
                lcm.add_other_robot_global_descriptor(
                    DescriptorMsg(rid, kf, descriptors[kf, rid]))


def candidate_table(lcm: LoopClosureSparseMatching):
    """Sorted [(r0, k0, r1, k1, weight)] of the current candidates."""
    return sorted((e.robot0_id, e.robot0_keyframe_id, e.robot1_id,
                   e.robot1_keyframe_id, float(e.weight))
                  for e in lcm.candidate_selector.candidate_edges.values())


def detect_and_verify(world: SyntheticWorld,
                      lcm: LoopClosureSparseMatching, rounds: int,
                      budget: int, gate: float):
    """`rounds` budgeted selections, each candidate verified against
    ground truth. Returns (selected per round, verified closures as
    (edge, R_rel, t_rel), failure count)."""
    robots = {r: True for r in range(lcm.params["max_nb_robots"])}
    sel = lcm.candidate_selector
    selected, verified, failures = [], [], 0
    for _ in range(rounds):
        chosen = lcm.select_candidates(budget, robots)
        selected.append(chosen)
        for e in chosen:
            R, t, dist = measure(world, e.robot0_id, e.robot0_keyframe_id,
                                 e.robot1_id, e.robot1_keyframe_id)
            if dist < gate:
                sel.candidate_edges_to_fixed([e])
                verified.append((e, R, t))
            else:
                sel.remove_candidate_edges([e], failed=True)
                failures += 1
    return selected, verified, failures


def build_graph(odom: Dict[int, tuple], verified) -> FactorGraph:
    """Odometry chains of every robot + verified loop closures, prior on
    robot 0's first pose."""
    fg = FactorGraph()
    sq_odom = diag_sqrt_info(ODOM_NOISE_STD)
    sq_loop = diag_sqrt_info(LOOP_NOISE_STD)
    for rid, (Rs, ts) in odom.items():
        for k in range(len(ts)):
            fg.add_node((rid, k), Rs[k], ts[k])
        for k in range(len(ts) - 1):
            Rr = (Rs[k].T @ Rs[k + 1]).astype(np.float32)
            tr = (Rs[k].T @ (ts[k + 1] - ts[k])).astype(np.float32)
            fg.add_between(BetweenFactor((rid, k), (rid, k + 1), Rr, tr,
                                         sq_odom))
    for e, R, t in verified:
        fg.add_between(BetweenFactor(
            (e.robot0_id, e.robot0_keyframe_id),
            (e.robot1_id, e.robot1_keyframe_id), R, t, sq_loop,
            is_loop=True))
    R0, t0 = odom[0][0][0], odom[0][1][0]
    fg.set_prior((0, 0), R0, t0)
    return fg


def trajectory_ate(world: SyntheticWorld, est: Dict[int, np.ndarray]):
    """Aligned ATE RMSE of stacked per-robot translations."""
    gt = np.concatenate([world.trajectories[r][1]
                         for r in range(world.n_robots)])
    return ate_rmse(np.concatenate([est[r] for r in range(world.n_robots)]),
                    gt)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_slice(n_robots: int, n_poses: int, descriptor_dim: int = 32,
              seed: int = 0, device: DeviceLike = None,
              nns_method: str = "auto", rounds: int = 8) -> Dict:
    """Run the whole slice; returns a dict of its outputs and timings."""
    dev = resolve_device(device)
    timings = {}
    t0 = time.perf_counter()
    world = SyntheticWorld(n_robots, n_poses, seed=seed,
                           descriptor_dim=descriptor_dim)
    descriptors = world_descriptors(world)
    odom = {rid: world.noisy_odometry(rid, drift=DRIFT)
            for rid in range(n_robots)}
    timings["world_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lcm = LoopClosureSparseMatching(
        make_params(0, n_robots, BUDGET, nns_method), device=dev)
    ingest(lcm, descriptors)
    _sync(dev)
    timings["knn_ingest_s"] = time.perf_counter() - t0
    candidates = candidate_table(lcm)

    t0 = time.perf_counter()
    selected, verified, failures = detect_and_verify(world, lcm, rounds,
                                                     BUDGET, GATE_M)
    _sync(dev)
    timings["mac_select_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fg = build_graph(odom, verified)
    result = pgo.optimize(fg, SLICE_PGO, device=dev)
    _sync(dev)
    timings["pgo_s"] = time.perf_counter() - t0

    est = {r: np.stack([fg.t[fg.key_to_index[(r, k)]]
                        for k in range(n_poses)]) for r in range(n_robots)}
    return {
        "world": world,
        "descriptors": descriptors,
        "candidates": candidates,
        "selected": [[tuple(e[:4]) for e in s] for s in selected],
        "loop_closures": [tuple(e[:4]) for e, _, _ in verified],
        "verification_failures": failures,
        "ate_odom": trajectory_ate(world, {r: odom[r][1]
                                           for r in range(n_robots)}),
        "ate_opt": trajectory_ate(world, est),
        "estimate": est,
        "gnc_iters": result.gnc_iters,
        "weights": result.weights[:fg.num_factors].cpu().numpy(),
        "timings": timings,
    }
