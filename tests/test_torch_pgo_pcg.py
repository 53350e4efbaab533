"""Port parity, GNC-LM solves through PCG with the BCR chain
preconditioner (the map-scale linear solver): `pgo.optimize` of
cslam_tpu_torch against cslam_tpu on test_pgo.py graphs, on the CPU —
BCR with and without reduction levels, incidence and gather/scatter edge
operators. Tolerances: poses 1e-3, identical GNC inlier sets and round
counts, cost 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from cslam_tpu.backend import pgo as jpgo
from cslam_tpu_torch.backend import pgo as tpgo
from test_pgo import build_graph
from test_torch_pgo import _assert_same_solution, _solve_both

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)


@pytest.mark.parametrize("n,outliers", [
    (40, ((3, 30), (8, 25))),   # BCR tail only (P = 64)
    (100, ((10, 70),)),         # one reduction level (P = 128)
])
def test_pcg_solve_matches_reference(n, outliers):
    rng = np.random.default_rng(0)
    fg, _, _ = build_graph(rng, n=n, loops=((0, n // 2), (5, n - 5)),
                           outliers=outliers, noise=0.01)
    res_r, res, _ = _solve_both(fg, jpgo.PGOConfig(linear_solver="pcg"))
    _assert_same_solution(res_r, res, fg.num_factors)


def test_pcg_scatter_path_matches_reference(monkeypatch):
    """The gather/index_add edge operators (graphs past the incidence
    bucket) against the reference's scatter path."""
    monkeypatch.setattr(jpgo, "_INCIDENCE_MAX_ENTRIES", 0)
    monkeypatch.setattr(tpgo, "_INCIDENCE_MAX_ENTRIES", 0)
    jpgo.gnc_optimize.clear_cache()  # re-trace with the scatter path
    rng = np.random.default_rng(0)
    fg, _, _ = build_graph(rng, n=40, loops=((0, 20), (5, 35)),
                           outliers=((3, 30),), noise=0.01)
    try:
        res_r, res, _ = _solve_both(fg, jpgo.PGOConfig(linear_solver="pcg"))
    finally:
        jpgo.gnc_optimize.clear_cache()
    _assert_same_solution(res_r, res, fg.num_factors)
