"""Port parity, the whole slice: descriptor kNN -> MAC selection -> GNC-LM
PGO through cslam_tpu_torch.swarm_slice against the same pipeline built
from cslam_tpu's entry points, on the same synthetic world (2 robots x
24 keyframes, 32-d descriptors), on the CPU. Same candidates (weights
within 1e-5), same selection and verified closures, ATE within 1e-3.

Also: the port imports neither JAX nor cslam_tpu, and its entry points
refuse to run without a card unless given device="cpu".
"""

import multiprocessing
import os
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest
import torch

from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.backend.factor_graph import BetweenFactor, FactorGraph, \
    diag_sqrt_info
from cslam_tpu.frontend.sim import SyntheticWorld as JaxWorld
from cslam_tpu.matching.sparse_matching import \
    LoopClosureSparseMatching as JaxLCSM
from cslam_tpu.utils.evaluation import ate_rmse
from cslam_tpu_torch import swarm_slice

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATE_TOL = 1e-3
SIM_TOL = 1e-5
Msg = namedtuple("Msg", ["robot_id", "keyframe_id", "descriptor"])


def _reference_slice(n_robots, n_poses, dim, seed, rounds):
    """The slice's steps written against the reference package."""
    budget, gate = swarm_slice.BUDGET, swarm_slice.GATE_M
    drift = swarm_slice.DRIFT
    world = JaxWorld(n_robots, n_poses, seed=seed, descriptor_dim=dim)
    descs = np.stack([np.stack([world.descriptor(r, kf)
                                for r in range(n_robots)])
                      for kf in range(n_poses)])
    odom = {r: world.noisy_odometry(r, drift=drift) for r in range(n_robots)}
    lcm = JaxLCSM(swarm_slice.make_params(0, n_robots, budget, "exact"))
    for kf in range(n_poses):
        for r in range(n_robots):
            if r == 0:
                lcm.add_local_global_descriptor(descs[kf, r], kf)
            else:
                lcm.add_other_robot_global_descriptor(
                    Msg(r, kf, descs[kf, r]))
    candidates = sorted((e.robot0_id, e.robot0_keyframe_id, e.robot1_id,
                         e.robot1_keyframe_id, float(e.weight))
                        for e in lcm.candidate_selector.candidate_edges
                        .values())
    selected, verified = [], []
    for _ in range(rounds):
        chosen = lcm.select_candidates(budget, {r: True
                                                for r in range(n_robots)})
        selected.append([tuple(e)[:4] for e in chosen])
        for e in chosen:
            R0, t0 = world.pose(e.robot0_id, e.robot0_keyframe_id)
            R1, t1 = world.pose(e.robot1_id, e.robot1_keyframe_id)
            if float(np.linalg.norm(t1 - t0)) < gate:
                lcm.candidate_selector.candidate_edges_to_fixed([e])
                verified.append((e, (R0.T @ R1).astype(np.float32),
                                 (R0.T @ (t1 - t0)).astype(np.float32)))
            else:
                lcm.candidate_selector.remove_candidate_edges([e],
                                                              failed=True)
    fg = FactorGraph()
    sq_o = diag_sqrt_info(swarm_slice.ODOM_NOISE_STD)
    sq_l = diag_sqrt_info(swarm_slice.LOOP_NOISE_STD)
    for r, (Rs, ts) in odom.items():
        for k in range(n_poses):
            fg.add_node((r, k), Rs[k], ts[k])
        for k in range(n_poses - 1):
            fg.add_between(BetweenFactor(
                (r, k), (r, k + 1), (Rs[k].T @ Rs[k + 1]).astype(np.float32),
                (Rs[k].T @ (ts[k + 1] - ts[k])).astype(np.float32), sq_o))
    for e, R, t in verified:
        fg.add_between(BetweenFactor((e.robot0_id, e.robot0_keyframe_id),
                                     (e.robot1_id, e.robot1_keyframe_id),
                                     R, t, sq_l, is_loop=True))
    fg.set_prior((0, 0), odom[0][0][0], odom[0][1][0])
    jpgo.optimize(fg, jpgo.PGOConfig(lm_max_iters=15, cg_max_iters=80))
    gt = np.concatenate([world.trajectories[r][1] for r in range(n_robots)])
    est = np.concatenate([np.stack([fg.t[fg.key_to_index[(r, k)]]
                                    for k in range(n_poses)])
                          for r in range(n_robots)])
    odo = np.concatenate([odom[r][1] for r in range(n_robots)])
    return {"descriptors": descs, "candidates": candidates,
            "selected": selected,
            "loop_closures": [tuple(e)[:4] for e, _, _ in verified],
            "ate_odom": ate_rmse(odo, gt), "ate_opt": ate_rmse(est, gt),
            "estimate": est}


@pytest.mark.parametrize("nns_method", ["pallas", "exact"])
def test_slice_matches_reference(nns_method):
    kw = dict(n_robots=2, n_poses=24, seed=0, rounds=4)
    ref = _reference_slice(dim=32, **kw)
    port = swarm_slice.run_slice(descriptor_dim=32, device="cpu",
                                 nns_method=nns_method, **kw)
    np.testing.assert_array_equal(port["descriptors"], ref["descriptors"])
    assert [c[:4] for c in port["candidates"]] == \
        [c[:4] for c in ref["candidates"]]
    np.testing.assert_allclose([c[4] for c in port["candidates"]],
                               [c[4] for c in ref["candidates"]],
                               atol=SIM_TOL)
    assert [sorted(s) for s in port["selected"]] == \
        [sorted(s) for s in ref["selected"]]
    assert port["loop_closures"] == ref["loop_closures"]
    assert len(port["loop_closures"]) > 0
    assert port["ate_odom"] == pytest.approx(ref["ate_odom"], abs=ATE_TOL)
    assert port["ate_opt"] == pytest.approx(ref["ate_opt"], abs=ATE_TOL)
    assert port["ate_opt"] < port["ate_odom"]
    est = np.concatenate([port["estimate"][r] for r in range(2)])
    np.testing.assert_allclose(est, ref["estimate"], atol=ATE_TOL)


# the visual slice's modules: the walk above must reach every one
VISUAL_MODULES = tuple(f"cslam_tpu_torch.{m}" for m in (
    "ops.registration", "ops.features", "ops.matching2d", "ops.pnp",
    "ops.stereo", "models.superpoint", "models.onnx_import",
    "models.lightglue", "models.convert", "models.zoo",
    "models.train_lightglue", "runtime.native", "frontend.rgbd_handler",
    "frontend.map_manager", "utils.jax_random", "visual_mission"))
# the lidar slice's modules
LIDAR_MODULES = tuple(f"cslam_tpu_torch.{m}" for m in (
    "utils.pointcloud", "ops.scancontext", "ops.fpfh",
    "matching.scancontext_matching", "frontend.lidar_handler", "mission",
    "lidar_mission"))


# the launcher slice's modules
LAUNCHER_MODULES = tuple(f"cslam_tpu_torch.{m}" for m in (
    "launch", "tools.solve_g2o", "utils.checkpoint", "backend.g2o"))
# the multi-device slice's modules
PARALLEL_MODULES = tuple(f"cslam_tpu_torch.{m}" for m in (
    "parallel", "parallel.mesh", "parallel.sharded_knn",
    "parallel.distributed_pgo", "entry", "backend.pgo_oracle"))
# the tooling and training slice's modules
TOOLING_MODULES = tuple(f"cslam_tpu_torch.{m}" for m in (
    "utils.datasets", "utils.visualization", "utils.image_sequence",
    "models.synthetic_shapes", "models.homographic_adaptation",
    "models.training", "models.train_superpoint", "models.train_lightglue",
    "models.train_cosplace", "models.train_netvlad", "tools.kitti_eval"))
SLICE_MODULES = (VISUAL_MODULES + LIDAR_MODULES + LAUNCHER_MODULES
                 + PARALLEL_MODULES + TOOLING_MODULES)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cslam_tpu_torch\n"
        "for m in pkgutil.walk_packages(cslam_tpu_torch.__path__,\n"
        "                               'cslam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = [m for m in "
        f"{SLICE_MODULES!r}\n"
        "           if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith('jax.') or m == 'cslam_tpu' or\n"
        "       m.startswith('cslam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('cslam_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok"), out.stdout


def test_entry_points_refuse_without_a_card(monkeypatch, tmp_path):
    """No card and no device="cpu": every entry point raises instead of
    running on the CPU (the launcher's robot without `--device cpu`,
    solve_g2o without `--cpu`, a mesh before it spawns a rank)."""
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.backend.factor_graph import FactorGraph as TFG
    from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
    from cslam_tpu_torch.matching.sparse_matching import \
        LoopClosureSparseMatching
    from cslam_tpu_torch.sparsification.acm import \
        AlgebraicConnectivityMaximization
    from cslam_tpu_torch.sparsification.mac import MAC
    from cslam_tpu_torch.utils.edges import Edge
    from cslam_tpu_torch.comm.bus import InProcessBus, InProcessRouter, \
        ManualClock
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler
    from cslam_tpu_torch.models.lightglue import LightGlue
    from cslam_tpu_torch.models.superpoint import SuperPoint
    from cslam_tpu_torch.visual_mission import run_visual_mission
    from cslam_tpu_torch.frontend.lidar_handler import LidarHandler, \
        ScanContextModel
    from cslam_tpu_torch.lidar_mission import make_params as lidar_params, \
        run_lidar_mission
    from cslam_tpu_torch.matching.scancontext_matching import \
        ScanContextMatching
    from cslam_tpu_torch import launch
    from cslam_tpu_torch.models import train_cosplace, train_lightglue, \
        train_netvlad, train_superpoint
    from cslam_tpu_torch.tools import kitti_eval
    from cslam_tpu_torch.backend.factor_graph import BetweenFactor as TBF, \
        diag_sqrt_info as t_sqrt_info
    from cslam_tpu_torch.backend.g2o import write_g2o
    from cslam_tpu_torch.tools import solve_g2o
    from cslam_tpu_torch import entry
    from cslam_tpu_torch.parallel import make_swarm_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fg = TFG()
    fg.add_node((0, 0))
    fg.set_prior((0, 0))
    for make in (lambda: DescriptorDatabase(),
                 lambda: LoopClosureSparseMatching(
                     swarm_slice.make_params(0, 2)),
                 lambda: AlgebraicConnectivityMaximization(),
                 lambda: MAC([Edge(0, 1, 1.0)], [Edge(0, 1, 0.5)], 2),
                 lambda: pgo.optimize(fg),
                 lambda: swarm_slice.run_slice(2, 4),
                 lambda: SuperPoint(),
                 lambda: LightGlue(num_layers=2),
                 lambda: RGBDHandler({"robot_id": 0, "max_nb_robots": 1},
                                     InProcessBus(InProcessRouter(), 0),
                                     ManualClock()),
                 lambda: run_visual_mission(2, 4),
                 lambda: ScanContextMatching(),
                 lambda: ScanContextModel(),
                 lambda: LoopClosureSparseMatching(lidar_params(0, 2)),
                 lambda: LidarHandler({"robot_id": 0, "max_nb_robots": 1},
                                      InProcessBus(InProcessRouter(), 0),
                                      ManualClock()),
                 lambda: run_lidar_mission(2, 4),
                 lambda: launch.main(["--robot-id", "0", "--robots", "1",
                                      "--sim", "--duration", "0",
                                      "--base-port", "20600"]),
                 lambda: solve_g2o.main([str(tmp_path / "none.g2o")]),
                 lambda: make_swarm_mesh(2),
                 lambda: make_swarm_mesh(2, backend="gloo"),
                 lambda: entry.dryrun_multichip(2),
                 lambda: entry.main(["2"]),
                 lambda: entry.entry(),
                 lambda: train_superpoint.main(["--steps", "1"]),
                 lambda: train_lightglue.main(["--steps", "1"]),
                 lambda: train_cosplace.main(["--steps", "1"]),
                 lambda: train_netvlad.main(["--steps", "1"]),
                 lambda: kitti_eval.run_eval(
                     np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)),
                     np.zeros((4, 3), np.float32), 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert not multiprocessing.active_children()
    # with the explicit CPU device they run
    DescriptorDatabase(device="cpu").add_item(np.ones(4), 0)
    pgo.optimize(fg, device="cpu")
    assert launch.main(["--robot-id", "0", "--robots", "1", "--sim",
                        "--duration", "0", "--base-port", "20600",
                        "--device", "cpu"]) == 0
    fg.add_between(TBF((0, 0), (0, 1), np.eye(3, dtype=np.float32),
                       np.ones(3, np.float32), t_sqrt_info([0.1] * 6)))
    write_g2o(fg, str(tmp_path / "g.g2o"))
    assert solve_g2o.main([str(tmp_path / "g.g2o"), "--cpu"]) == 0


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and in a directory that holds nothing else of the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_path_check_is_tie_aware():
    """chip_smoke's exact-path check: an edge found by one search path
    only passes when the other found an equally similar edge from the
    same query (a tie within rounding) or it sits on the threshold."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    kernel = [(0, 1, 1, 5, 0.9), (0, 2, 1, 6, 0.8), (0, 3, 2, 7, 0.5)]
    tie = [(0, 1, 1, 5, 0.9), (0, 2, 1, 9, 0.800001)]
    assert chip_smoke.compare_candidates(kernel, tie, 0.5)[
        "unexplained"] == []
    other = [(0, 1, 1, 5, 0.9), (0, 2, 1, 9, 0.81), (0, 3, 2, 7, 0.5)]
    assert sorted(chip_smoke.compare_candidates(kernel, other, 0.5)[
        "unexplained"]) == [[0, 2, 1, 6], [0, 2, 1, 9]]
    # the tied twin was also found by the other path's reverse search
    mutual = [(0, 1, 1, 5, 0.9), (0, 2, 1, 6, 0.8), (0, 2, 1, 9, 0.800001)]
    assert chip_smoke.compare_candidates(kernel, mutual, 0.5)[
        "unexplained"] == []
    drift = [(0, 1, 1, 5, 0.9001), (0, 2, 1, 6, 0.8), (0, 3, 2, 7, 0.5)]
    assert chip_smoke.compare_candidates(kernel, drift, 0.5)[
        "unexplained"] == [[0, 1, 1, 5]]
