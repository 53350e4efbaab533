"""Port parity, GNC-LM solves: `pgo.optimize` of cslam_tpu_torch against
cslam_tpu on test_pgo.py / test_chordal_init.py graphs, on the CPU,
through the dense-Cholesky solver (the small graphs' "auto" choice),
the chordal-init option and the batched entry; the PCG paths are in
test_torch_pgo_pcg.py.
Tolerances: poses 1e-3, identical GNC inlier sets and round counts,
cost 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from cslam_tpu.backend import pgo as jpgo
from cslam_tpu_torch import interop
from cslam_tpu_torch.backend import pgo as tpgo
from test_chordal_init import scrambled_graph
from test_pgo import build_graph
from test_torch_pgo import (POSE_TOL, _assert_same_solution, _np,
                            _solve_both)

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

@pytest.mark.parametrize("n,outliers", [
    (20, ()),                   # no GNC rounds
    (40, ((3, 30), (8, 25))),   # GNC rejects two outliers
])
def test_dense_solve_matches_reference(n, outliers):
    """6P <= 1536: "auto" assembles H and solves by dense Cholesky."""
    rng = np.random.default_rng(0)
    fg, _, _ = build_graph(rng, n=n, loops=((0, n // 2), (5, n - 5)),
                           outliers=outliers, noise=0.01)
    res_r, res, tfg = _solve_both(fg, jpgo.PGOConfig())
    _assert_same_solution(res_r, res, fg.num_factors)
    np.testing.assert_allclose(np.stack(tfg.t), np.stack(fg.t),
                               atol=POSE_TOL)


def test_chordal_option_matches_reference():
    rng = np.random.default_rng(1)
    fg, _, _ = scrambled_graph(rng)
    cfg = jpgo.PGOConfig(lm_max_iters=25, cg_max_iters=80,
                         gnc_max_outer_iters=3, use_chordal_init=True)
    res_r, res, _ = _solve_both(fg, cfg)
    _assert_same_solution(res_r, res, fg.num_factors)


def test_optimize_batch_equals_individual_solves():
    """optimize_batch pads every graph to the largest bucket and gives
    each the result of its own solve (the reference's vmap semantics);
    the individual solves are held against the reference above."""
    rng = np.random.default_rng(4)
    fgs = [build_graph(rng, n=n, loops=((0, n // 2),), noise=0.01)[0]
           for n in (12, 20)]
    tfgs = [interop.factor_graph_from(fg) for fg in fgs]
    singles = []
    for fg in fgs:
        g = interop.graph_arrays_from(
            fg.to_arrays(min_node_capacity=32, min_edge_capacity=32),
            device="cpu")
        singles.append(tpgo.gnc_optimize(g, tpgo.PGOConfig()))
    batch = tpgo.optimize_batch(tfgs, tpgo.PGOConfig(), device="cpu")
    for b, s, tfg in zip(batch, singles, tfgs):
        np.testing.assert_allclose(_np(b.t), _np(s.t), atol=1e-6)
        np.testing.assert_allclose(np.stack(tfg.t), _np(b.t)[:len(tfg.t)],
                                   atol=1e-6)
