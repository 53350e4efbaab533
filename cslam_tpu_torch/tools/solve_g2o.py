"""Solve a g2o pose-graph file with the port's GNC-LM optimizer.

Port of cslam_tpu/tools/solve_g2o.py. The interchange format GTSAM/g2o
users benchmark with:

  python -m cslam_tpu_torch.tools.solve_g2o input.g2o [-o out.g2o]
      [--chordal] [--plain-lm] [--barc-sq 10] [--cpu]

The solve runs on the CUDA card; without one it raises unless `--cpu`
asks for the CPU. Prints one JSON line with initial/final robust cost,
per-category factor counts, rejected-loop count, wall time and the torch
device type as "platform"; optionally writes the optimized graph back
out in g2o format.
"""

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="input .g2o (VERTEX_SE3:QUAT / EDGE_SE3:QUAT)")
    ap.add_argument("-o", "--output", default="",
                    help="write optimized graph to this .g2o")
    ap.add_argument("--chordal", action="store_true",
                    help="chordal (rotation-averaging) initialization — "
                    "use when the stored vertex estimates are unreliable")
    ap.add_argument("--plain-lm", action="store_true",
                    help="disable GNC robustness (trust every edge)")
    ap.add_argument("--barc-sq", type=float, default=10.0,
                    help="GNC inlier gate on 0.5||r_whitened||^2")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from cslam_tpu_torch.backend import pgo
    from cslam_tpu_torch.backend.g2o import read_g2o, write_g2o
    from cslam_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    fg = read_g2o(args.input)
    n_loops = sum(1 for f in fg.factors if f.is_loop)
    # --plain-lm: an unreachable inlier gate makes every residual an
    # inlier, so the optimizer takes the skip_gnc path (unit weights,
    # pure LM) instead of annealing.
    cfg = pgo.PGOConfig(
        barc_sq=1e30 if args.plain_lm else args.barc_sq,
        use_chordal_init=args.chordal,
    )
    t0 = time.perf_counter()
    result = pgo.optimize(fg, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    w = result.weights.cpu().numpy()[:fg.num_factors]
    loop_w = np.asarray([wi for wi, f in zip(w, fg.factors) if f.is_loop])
    summary = {
        "poses": fg.num_nodes,
        "factors": fg.num_factors,
        "loop_closures": n_loops,
        "initial_cost": float(result.initial_cost),
        "final_cost": float(result.cost),
        "gnc_iters": int(result.gnc_iters),
        "rejected_loops": int((loop_w < 0.5).sum()) if n_loops else 0,
        "solve_wall_s": dt,
        "platform": device.type,
    }
    if args.output:
        write_g2o(fg, args.output)
        summary["output"] = args.output
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
