"""The launcher's solver settings and the swarm-solve tool, on the CPU.

- `launch.pgo_config`: PGOConfig's defaults, with chordal
  initialization and nothing else changed under `--pgo-chordal`;
- `tools.swarm_solve.swarm_graph`: each robot's odometry chain, the
  closures as exact relative poses of the ground truth (frontend/sim.py
  `measure`) with the sim handler's information, a prior on robot 0;
- `tools.swarm_solve.main(["--cpu", ...])` at a small size: one
  JSON line per graph and setting, every field present and finite, and
  the chordal setting keeping every exact closure.
"""

import json

import numpy as np
import torch

from cslam_tpu_torch import launch
from cslam_tpu_torch.backend import pgo
from cslam_tpu_torch.backend.decentralized_pgo import DEFAULT_NOISE_STD
from cslam_tpu_torch.frontend.sim import SyntheticWorld
from cslam_tpu_torch.tools import swarm_solve as tool

torch.set_num_threads(1)


def test_launcher_pgo_config():
    parser = launch.argument_parser()
    assert launch.pgo_config(parser.parse_args([])) == pgo.PGOConfig()
    assert launch.pgo_config(parser.parse_args(["--pgo-chordal"])) == \
        pgo.PGOConfig(use_chordal_init=True)


def test_swarm_graph_holds_odometry_and_exact_closures():
    world = SyntheticWorld(2, 12, seed=3)
    odometry = {r: world.noisy_odometry(r, drift=0.02) for r in range(2)}
    closures = [(0, 2, 1, 5), (0, 7, 1, 9)]
    fg = tool.swarm_graph(world, odometry, closures, DEFAULT_NOISE_STD)
    g = fg.to_arrays(device="cpu")
    mask = g.edge_mask.numpy() > 0
    assert int(mask.sum()) == 2 * 11 + len(closures)
    assert int((g.is_loop.numpy()[mask] > 0).sum()) == len(closures)
    loops = [f for f in fg.factors if f.is_loop]
    for f, (r0, k0, r1, k1) in zip(loops, closures):
        R0, t0 = world.pose(r0, k0)
        R1, t1 = world.pose(r1, k1)
        np.testing.assert_allclose(f.R, R0.T @ R1, atol=1e-6)
        np.testing.assert_allclose(f.t, R0.T @ (t1 - t0), atol=1e-5)
        np.testing.assert_allclose(
            np.diag(f.sqrt_info), 1.0 / tool.SIM_CLOSURE_STD, rtol=1e-6)
    assert fg.key_to_index[(0, 0)] == int(g.prior_idx)


def test_swarm_solve_reports_each_setting(capsys):
    assert tool.main(["--robots", "2", "--poses", "24", "--closures", "6",
                      "--graphs", "2", "--settings", "12,25",
                      "12,25,chordal", "--cpu"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.splitlines()]
    assert [(r["graph"], r["lm_max_iters"], r["cg_max_iters"],
             r["chordal"]) for r in rows] == [
        (0, 12, 25, False), (0, 12, 25, True),
        (1, 12, 25, False), (1, 12, 25, True)]
    for r in rows:
        assert len(r["ate_m"]) == len(r["ate_odometry_m"]) == 2
        assert np.all(np.isfinite(r["ate_m"]))
        assert r["closures"] == 6 and 0 <= r["closures_kept"] <= 6
        assert r["device"] == "cpu" and r["wall_s"] > 0
        if r["chordal"]:
            assert r["closures_kept"] == r["closures"]
