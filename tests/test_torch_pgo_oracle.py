"""Independent-oracle parity on the port: cslam_tpu_torch's pgo_oracle
against the reference's, and the port's single-device and 8-rank
distributed GNC-LM solves held to the oracle, on the CPU.

The counterparts of tests/test_pgo_oracle.py's five tests, on the same
graphs (its `build_graph`, its sphere slice):

- the port's oracle is a copy of the reference's (numpy/scipy only):
  SE(3) helpers within 1e-6, residuals and cost within 1e-5, and its
  gnc_optimize ends at the same weights, cost within 1e-5 relative;
- the port's solves against the port's oracle, with the reference
  test's tolerances: planted outliers classified identically, robust
  cost within 1%, poses within 2% of the trajectory's scale (0.02 m for
  the inlier-only graph);
- the port's autodiff Jacobians against the oracle's central
  differences (2e-3).

The distributed solve runs on a module-scoped mesh of 8 gloo ranks.
CSLAM_SLOW_TESTS=1 adds the 600-pose sphere slice, as in the reference.
"""

import os

import numpy as np
import pytest
import torch

from cslam_tpu.backend import pgo_oracle as jor
from cslam_tpu_torch import interop
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.backend import pgo_oracle as tor
from cslam_tpu_torch.parallel import distributed_pgo as tdist
from cslam_tpu_torch.parallel import make_swarm_mesh
from test_pgo_oracle import _sphere_slice_graph, build_graph

# one intra-op thread per rank: the suite runs several pytest workers
# side by side, and every rank of the mesh is a process
torch.set_num_threads(1)

N_RANKS = 8


@pytest.fixture(scope="module")
def mesh():
    m = make_swarm_mesh(N_RANKS, device="cpu")
    yield m
    m.close()


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _solve_all(mesh, fg):
    """The reference's oracle, the port's oracle, and the port's
    single-device and distributed solves of the same graph."""
    ores_ref = jor.gnc_optimize(jor.from_graph_arrays(fg.to_arrays()))
    tfg = interop.factor_graph_from(fg)
    g = tfg.to_arrays(device="cpu")
    og = tor.from_graph_arrays(g)
    ores = tor.gnc_optimize(og)
    np.testing.assert_array_equal(ores.weights, ores_ref.weights)
    assert ores.cost == pytest.approx(ores_ref.cost, rel=1e-5)
    nm = _np(g.node_mask) > 0
    nf = len(og.e_i)  # valid factors are a prefix of the edge arrays
    single = tpgo.gnc_optimize(g, tpgo.PGOConfig())
    gd = tfg.to_arrays(edge_bucket_multiple=N_RANKS, sort_by_robot=True,
                       device="cpu")
    # one robot: the robot-sorted order is the insertion order
    np.testing.assert_array_equal(_np(gd.e_i)[:nf], og.e_i)
    dist = tdist.distributed_gnc_optimize(mesh, gd, tpgo.PGOConfig())
    solves = {name: (res, _np(res.t)[nm], _np(res.weights)[:nf])
              for name, res in (("single", single), ("distributed", dist))}
    return ores, og, solves


def test_oracle_copy_matches_reference():
    """SE(3) helpers within 1e-6; residuals and cost within 1e-5."""
    rng = np.random.default_rng(0)
    for _ in range(16):
        xi = rng.standard_normal(6) * rng.choice([1e-9, 1e-3, 0.5, 3.0])
        R, t = tor.se3_exp(xi)
        Rr, tr = jor.se3_exp(xi)
        np.testing.assert_allclose(R, Rr, atol=1e-6)
        np.testing.assert_allclose(t, tr, atol=1e-6)
        np.testing.assert_allclose(tor.se3_log(R, t), jor.se3_log(Rr, tr),
                                   atol=1e-6)
    fg, _, _ = build_graph(n=20, n_loops=5, outlier_every=2, seed=4)
    og = tor.from_graph_arrays(
        interop.factor_graph_from(fg).to_arrays(device="cpu"))
    og_ref = jor.from_graph_arrays(fg.to_arrays())
    for a, b in zip(og, og_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(tor.residuals(og, og.R, og.t),
                               jor.residuals(og_ref, og_ref.R, og_ref.t),
                               atol=1e-5)
    w = rng.uniform(size=len(og.e_i))
    assert tor.cost(og, og.R, og.t, w) == pytest.approx(
        jor.cost(og_ref, og_ref.R, og_ref.t, w), rel=1e-5)


def test_jacobians_match_numeric():
    """The port's autodiff Jacobians == central differences of the
    oracle's residual (same convention, independent derivations)."""
    fg, _, _ = build_graph(n=12, n_loops=4, outlier_every=0, seed=3)
    g = interop.factor_graph_from(fg).to_arrays(device="cpu")
    og = tor.from_graph_arrays(g)
    r, Ji, Jj = tpgo.edge_residuals_jacobians(g, g.R, g.t)
    r, Ji, Jj = _np(r), _np(Ji), _np(Jj)
    for e in range(len(og.e_i)):
        r_o = tor._edge_residual(og, e, og.R, og.t)
        np.testing.assert_allclose(r[e], r_o, rtol=1e-4, atol=1e-5)
        Ji_o, Jj_o = tor._numeric_edge_jacobians(og, e, og.R, og.t)
        np.testing.assert_allclose(Ji[e], Ji_o, atol=2e-3)
        np.testing.assert_allclose(Jj[e], Jj_o, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parity_random_graphs_with_outliers(mesh, seed):
    """Planted-outlier graphs: both port solves classify as the oracle
    (and as planted), cost within 1%, poses within tolerance."""
    fg, _, planted = build_graph(n=50, n_loops=12, outlier_every=4,
                                 seed=seed)
    ores, og, solves = _solve_all(mesh, fg)
    loops = og.is_loop
    oracle_rejected = ores.weights[loops] < 0.5
    np.testing.assert_array_equal(oracle_rejected, planted)
    scale = np.linalg.norm(ores.t - ores.t.mean(0), axis=1).max()
    for name, (res, t, w) in solves.items():
        np.testing.assert_array_equal(w[loops] < 0.5, planted, err_msg=name)
        c = float(res.cost)
        assert abs(c - ores.cost) / max(ores.cost, 1e-9) < 0.01, \
            (name, c, ores.cost)
        err = np.linalg.norm(t - ores.t, axis=1).max()
        assert err < max(0.02 * scale, 0.02), (name, err, scale)


def test_parity_inlier_only_graph(mesh):
    """No outliers: GNC fast-paths to unit weights in the oracle and in
    both port solves, which converge to the same optimum."""
    fg, _, _ = build_graph(n=40, n_loops=10, outlier_every=0, seed=7)
    ores, og, solves = _solve_all(mesh, fg)
    assert (ores.weights > 0.99).all()
    for name, (res, t, w) in solves.items():
        assert (w[og.is_loop] > 0.99).all(), name
        c = float(res.cost)
        assert abs(c - ores.cost) / max(ores.cost, 1e-9) < 0.01, \
            (name, c, ores.cost)
        err = np.linalg.norm(t - ores.t, axis=1).max()
        assert err < 0.02, (name, err)


def _sphere_parity(mesh, n):
    fg, t_gt = _sphere_slice_graph(n)
    ores, _, solves = _solve_all(mesh, fg)
    scale = np.linalg.norm(t_gt - t_gt.mean(0), axis=1).max()
    for name, (res, t, _) in solves.items():
        c = float(res.cost)
        assert abs(c - ores.cost) / max(ores.cost, 1e-9) < 0.01, \
            (name, c, ores.cost)
        err = np.linalg.norm(t - ores.t, axis=1).max()
        assert err < 0.02 * scale, (name, err, scale)


def test_parity_sphere_slice(mesh):
    """Sphere-graph slice (the classic PGO torture shape): cost within
    1% of the independent dense solver, for both port solves."""
    _sphere_parity(mesh, 150)


@pytest.mark.skipif(not os.environ.get("CSLAM_SLOW_TESTS"),
                    reason="minutes of dense numpy; CSLAM_SLOW_TESTS=1")
def test_parity_sphere_600_slow(mesh):
    _sphere_parity(mesh, 600)
