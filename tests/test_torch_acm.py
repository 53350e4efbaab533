"""Port parity, ACM bookkeeping: AlgebraicConnectivityMaximization of
cslam_tpu_torch against cslam_tpu on test_algebraic_connectivity.py's
graphs, on the CPU. Both packages' random initializations draw from the
same seeded numpy generator; selections must be identical (where MAC
runs, both are pinned to the matrix-free Fiedler path, see
test_torch_mac.py for why the warm-LOBPCG path is held to quality
contracts instead).
"""

import numpy as np
import pytest
import torch

import cslam_tpu.sparsification.mac as jmac
import cslam_tpu_torch.sparsification.mac as tmac
from cslam_tpu.sparsification.acm import \
    AlgebraicConnectivityMaximization as JaxACM
from cslam_tpu.utils.edges import EdgeInterRobot as JaxEdgeInterRobot
from cslam_tpu_torch.sparsification.acm import \
    AlgebraicConnectivityMaximization
from cslam_tpu_torch.utils.edges import EdgeInterRobot
from test_algebraic_connectivity import (build_multi_robot_graph,
                                         build_simple_graph)

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def _port_edges(edges):
    return [EdgeInterRobot(*e) for e in edges]


def _both_acms(**kw):
    ref = JaxACM(**kw)
    port = AlgebraicConnectivityMaximization(device="cpu", **kw)
    ref._rng = np.random.default_rng(5)
    port._rng = np.random.default_rng(5)
    return ref, port


def _keys(edges):
    return sorted(tuple(e)[:4] for e in edges)


@pytest.mark.parametrize("greedy", [True, False])
def test_acm_single_robot_selection_identical(greedy):
    """test_algebraic_connectivity.py's simple graph (no inter-robot
    fixed edge: connection-biased greedy), rounds of selection with
    candidates added between them."""
    rng = np.random.default_rng(42)
    fixed, cand = build_simple_graph(100, 50, rng)
    weights = rng.random(50)
    ref, port = _both_acms()
    cand = [ref.replace_weight(e, float(w)) for e, w in zip(cand, weights)]
    ref.set_graph(fixed, cand)
    port.set_graph(_port_edges(fixed), _port_edges(cand))
    for budget in (10, 12):
        assert _keys(port.select_candidates(budget, {0: True}, greedy)) == \
            _keys(ref.select_candidates(budget, {0: True}, greedy))
        extra = (0, int(rng.choice(100)), 0, int(rng.choice(100)),
                 float(rng.random()))
        ref.add_candidate_edge(JaxEdgeInterRobot(*extra))
        port.add_candidate_edge(EdgeInterRobot(*extra))


@pytest.mark.parametrize("robot_id", [0, 1])
def test_acm_multi_robot_selection_identical(robot_id, monkeypatch):
    """test_algebraic_connectivity.py's 3-robot graph, where MAC runs:
    with both packages pinned to the matrix-free Fiedler path the
    selected edges are identical, round after round."""
    monkeypatch.setattr(jmac, "_LOBPCG_NODE_THRESHOLD", 0)
    monkeypatch.setattr(tmac, "_LOBPCG_NODE_THRESHOLD", 0)
    rng = np.random.default_rng(42)
    fixed, cand = build_multi_robot_graph(100, 100, 3, rng)
    ref, port = _both_acms(robot_id=robot_id, max_nb_robots=3)
    ref.set_graph(fixed, cand)
    port.set_graph(_port_edges(fixed), _port_edges(cand))
    considered = {i: True for i in range(3)}
    for _ in range(2):
        sel_r = ref.select_candidates(10, considered, True)
        sel_p = port.select_candidates(10, considered, True)
        assert len(sel_p) == 10
        assert _keys(sel_p) == _keys(sel_r)
        ref.candidate_edges_to_fixed(sel_r[:3])
        port.candidate_edges_to_fixed(sel_p[:3])


def test_acm_bookkeeping_matches_reference():
    """add_match dedup, offsets, rekey/recover round trip, odometry
    fill and the below-floor backfill quirk, on both packages."""
    rng = np.random.default_rng(42)
    fixed, cand = build_multi_robot_graph(40, 30, 3, rng)
    params = {"frontend.enable_sparsification": True,
              "frontend.candidate_selection_min_weight": 0.7}
    ref, port = _both_acms(robot_id=0, max_nb_robots=3,
                           extra_params=params)
    cand = [ref.replace_weight(e, 0.4 + 0.01 * i)
            for i, e in enumerate(cand)]
    ref.set_graph(fixed, cand)
    port.set_graph(_port_edges(fixed), _port_edges(cand))
    for acm, edge in ((ref, JaxEdgeInterRobot), (port, EdgeInterRobot)):
        acm.add_match(edge(0, 1, 1, 3, 0.1))
        acm.add_match(edge(0, 1, 1, 3, 0.75))
    considered = {0: True, 1: False, 2: True}
    inc_r = ref.check_graph_disconnections(considered)
    inc_p = port.check_graph_disconnections(considered)
    assert inc_p == inc_r
    ref.compute_offsets(inc_r)
    port.compute_offsets(inc_p)
    assert port.offsets == ref.offsets
    rk_r = ref.rekey_edges(list(ref.candidate_edges.values()), inc_r)
    rk_p = port.rekey_edges(list(port.candidate_edges.values()), inc_p)
    assert rk_p == rk_r
    assert port.recover_inter_robot_edges(rk_p, inc_p) == \
        ref.recover_inter_robot_edges(rk_r, inc_r)
    assert port.fill_odometry() == ref.fill_odometry()
    assert _keys(port.select_candidates(5, considered)) == \
        _keys(ref.select_candidates(5, considered))
