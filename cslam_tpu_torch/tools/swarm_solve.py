"""Solve the launcher's synthetic swarm graph at given solver settings.

The graph is the one a `python -m cslam_tpu_torch.launch --sim` swarm
builds by the end of its stream: each robot's noisy odometry (the
launcher's drift, the back-end's default odometry noise, as the
keyframe messages carry no covariance) and exact inter-robot closures
stamped with the sim handler's covariance (`frontend/sim.py`
`_measurement_covariance`, std 1e-3). Which closures a mission verifies
depends on its timing, so each graph draws its own set from the pairs
within the verification gate, nearer pairs likelier (similar
descriptors). Every graph is solved at each setting: the LM and CG
caps, from odometry or, with ",chordal", from chordal relaxation:

  python -m cslam_tpu_torch.tools.swarm_solve --graphs 8 \
      --settings 12,25 12,25,chordal 30,400 [--cpu]

Prints one JSON line per graph and setting: each robot's ATE against
its odometry's, the closures GNC kept (weight > 0.5) of those in the
graph, the GNC rounds and the solve's wall seconds.
"""

import argparse
import json
import time

SIM_CLOSURE_STD = 1e-3  # frontend/sim.py: max(measurement_noise, 1e-3)


def swarm_graph(world, odometry, closures, noise_std):
    """FactorGraph of the robots' odometry chains and the closures
    ((r0, k0, r1, k1) tuples), prior on robot 0's first pose."""
    import numpy as np
    from cslam_tpu_torch.backend.factor_graph import (BetweenFactor,
                                                      FactorGraph,
                                                      diag_sqrt_info)
    from cslam_tpu_torch.frontend.sim import measure
    fg = FactorGraph()
    odo_info = diag_sqrt_info(noise_std)
    for rid, (R, t) in odometry.items():
        for k in range(len(t)):
            fg.add_node((rid, k), R[k], t[k])
        for k in range(1, len(t)):
            fg.add_between(BetweenFactor(
                (rid, k - 1), (rid, k), R[k - 1].T @ R[k],
                R[k - 1].T @ (t[k] - t[k - 1]), odo_info))
    lc_info = diag_sqrt_info(np.full(6, SIM_CLOSURE_STD, np.float32))
    for r0, k0, r1, k1 in closures:
        R, t, _ = measure(world, r0, k0, r1, k1)
        fg.add_between(BetweenFactor((r0, k0), (r1, k1), R, t, lc_info,
                                     is_loop=True))
    fg.set_prior((0, 0), odometry[0][0][0], odometry[0][1][0])
    return fg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--poses", type=int, default=200)
    ap.add_argument("--closures", type=int, default=200)
    ap.add_argument("--graphs", type=int, default=8)
    ap.add_argument("--settings", nargs="+",
                    default=["12,25", "12,25,chordal", "30,400"],
                    help="LM,CG iteration caps[,chordal], one solve each")
    ap.add_argument("--drift", type=float, default=0.02)
    ap.add_argument("--gate", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.backend.decentralized_pgo import DEFAULT_NOISE_STD
    from cslam_tpu_torch.device import resolve_device
    from cslam_tpu_torch.frontend.sim import SyntheticWorld
    from cslam_tpu_torch.utils.evaluation import ate_rmse

    device = resolve_device("cpu" if args.cpu else "cuda")
    world = SyntheticWorld(args.robots, args.poses, seed=args.seed)
    odometry = {r: world.noisy_odometry(r, drift=args.drift)
                for r in range(args.robots)}
    truth = {r: world.trajectories[r][1] for r in range(args.robots)}
    pairs = []
    for a in range(args.robots):
        for b in range(a + 1, args.robots):
            d = np.linalg.norm(truth[a][:, None] - truth[b][None], axis=2)
            for i, j in zip(*np.nonzero(d < args.gate)):
                pairs.append((a, int(i), b, int(j), float(d[i, j])))
    p = np.exp(-np.array([q[4] for q in pairs]))
    p /= p.sum()
    rng = np.random.default_rng(args.seed)
    odo_ate = [ate_rmse(odometry[r][1], truth[r])
               for r in range(args.robots)]
    for n in range(args.graphs):
        pick = rng.choice(len(pairs), args.closures, replace=False, p=p)
        closures = [pairs[i][:4] for i in pick]
        for setting in args.settings:
            lm, cg, *init = setting.split(",")
            cfg = pgo.PGOConfig(lm_max_iters=int(lm), cg_max_iters=int(cg),
                                use_chordal_init=init == ["chordal"])
            fg = swarm_graph(world, odometry, closures, DEFAULT_NOISE_STD)
            t0 = time.perf_counter()
            res = pgo.optimize(fg, cfg, device=device)
            wall = time.perf_counter() - t0
            g = fg.to_arrays(device="cpu")
            loops = (g.is_loop > 0) & (g.edge_mask > 0)
            kept = int((res.weights.cpu()[loops] > 0.5).sum())
            ate = []
            for r in range(args.robots):
                est = fg.estimates_for_robot(r)
                keys = sorted(est)
                ate.append(ate_rmse(np.stack([est[k][1] for k in keys]),
                                    truth[r][[k[1] for k in keys]]))
            print(json.dumps({
                "graph": n, "lm_max_iters": cfg.lm_max_iters,
                "cg_max_iters": cfg.cg_max_iters,
                "chordal": cfg.use_chordal_init,
                "ate_m": ate, "ate_odometry_m": odo_ate,
                "closures_kept": kept, "closures": int(loops.sum()),
                "gnc_iters": int(res.gnc_iters), "wall_s": wall,
                "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
