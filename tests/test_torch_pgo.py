"""Port parity, pose-graph optimization: se3, batched linear algebra,
block cyclic reduction, chordal initialization and GNC-LM PGO of
cslam_tpu_torch against cslam_tpu on the same seeded numpy inputs, on
the CPU.

Tolerances: elementwise ops 1e-5 (f32, other operation order); BCR
solves 1e-4 relative to the solution's scale; optimized poses 1e-3 and
identical GNC inlier sets (weights > 0.5), as the port's brief states.
Both linear-solver paths run: dense Cholesky (6P <= 1536, the small
graphs) and PCG with the BCR chain preconditioner (the map-scale path),
with both incidence and gather/scatter edge operators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.backend.initialization import \
    chordal_initialize as jchordal
from cslam_tpu.ops import batched_linalg as jbl
from cslam_tpu.ops import block_tridiag as jbt
from cslam_tpu.ops import se3 as jse3
from cslam_tpu_torch import interop
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.backend.initialization import chordal_initialize
from cslam_tpu_torch.ops import batched_linalg as tbl
from cslam_tpu_torch.ops import block_tridiag as tbt
from cslam_tpu_torch.ops import se3 as tse3
from test_block_tridiag import random_spd_tridiag
from test_chordal_init import scrambled_graph
from test_pgo import build_graph

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

OP_TOL = 1e-5
POSE_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _xis(rng, n=64):
    """Tangents across regimes: zero, series branch, generic, near pi."""
    xi = rng.standard_normal((n, 6)).astype(np.float32)
    xi[:8, :3] *= 1e-4
    xi[8:16, :3] *= 0.03
    axis = rng.standard_normal((8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi[16:24, :3] = (axis * (np.pi - 1e-4)).astype(np.float32)
    xi[24] = 0.0
    return xi


def test_se3_ops_match_reference():
    rng = np.random.default_rng(0)
    xi = _xis(rng)
    w = xi[:, :3]
    pairs = [
        (jse3.so3_exp, tse3.so3_exp, (w,)),
        (jse3.so3_left_jacobian, tse3.so3_left_jacobian, (w,)),
        (jse3.so3_left_jacobian_inv, tse3.so3_left_jacobian_inv, (w,)),
        (jse3.hat, tse3.hat, (w,)),
    ]
    for jf, tf, args in pairs:
        ref = jf(*map(jnp.asarray, args))
        got = tf(*map(_t, args))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=OP_TOL)
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=OP_TOL)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=OP_TOL)
    # logs of the same (reference) rotations, near-pi branch included
    logj = np.asarray(jse3.se3_log(Rj, tj))
    logt = _np(tse3.se3_log(_t(Rj), _t(tj)))
    np.testing.assert_allclose(logt, logj, atol=OP_TOL)
    A = (jnp.asarray(Rj[:32]), jnp.asarray(tj[:32]), jnp.asarray(Rj[32:]),
         jnp.asarray(tj[32:]))
    for jf, tf in ((jse3.compose, tse3.compose), (jse3.between, tse3.between)):
        for a, b in zip(jf(*A), tf(*map(_t, A))):
            np.testing.assert_allclose(_np(b), np.asarray(a), atol=OP_TOL)
    np.testing.assert_allclose(_np(tse3.adjoint(_t(Rj), _t(tj))),
                               np.asarray(jse3.adjoint(Rj, tj)), atol=OP_TOL)
    q = np.asarray(jse3.rot_to_quat(Rj))
    np.testing.assert_allclose(_np(tse3.rot_to_quat(_t(Rj))), q, atol=OP_TOL)
    np.testing.assert_allclose(_np(tse3.quat_to_rot(_t(q))),
                               np.asarray(jse3.quat_to_rot(jnp.asarray(q))),
                               atol=OP_TOL)


def test_batched_linalg_matches_reference():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, 6, 6)).astype(np.float32)
    H = A @ np.swapaxes(A, 1, 2) + 3 * np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(
        _np(tbl.batched_inv_small(_t(H))),
        np.asarray(jbl.batched_inv_small(jnp.asarray(H))), atol=OP_TOL)
    M = rng.standard_normal((32, 3, 3)).astype(np.float32)
    for jf, tf in ((jbl.inv3x3_adjugate, tbl.inv3x3_adjugate),
                   (jbl.det3x3, tbl.det3x3),
                   (jbl.polar_rotation3x3, tbl.polar_rotation3x3)):
        ref = np.asarray(jf(jnp.asarray(M)))
        np.testing.assert_allclose(_np(tf(_t(M))), ref, rtol=1e-4, atol=1e-4)
    S = M @ np.swapaxes(M, 1, 2)
    v_r = np.asarray(jbl.smallest_eigvec_sym3x3(jnp.asarray(S)))
    v = _np(tbl.smallest_eigvec_sym3x3(_t(S)))
    # an eigenvector's sign is free
    dots = np.abs(np.sum(v * v_r, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


@pytest.mark.parametrize("n", [32, 256, 1024])
def test_bcr_matches_reference(n):
    """Exact block-tridiagonal solves (0, 2 and 4 reduction levels) and
    the multi-rhs form."""
    D, O = random_spd_tridiag(n, 6, seed=n)
    rng = np.random.default_rng(n)
    b = rng.standard_normal((n, 6)).astype(np.float32)
    x_r = np.asarray(jax.jit(
        lambda D, O, b: jbt.bcr_solve(jbt.bcr_factor(D, O), b))(
            jnp.asarray(D), jnp.asarray(O), jnp.asarray(b)))
    x = _np(tbt.bcr_solve(tbt.bcr_factor(_t(D), _t(O)), _t(b)))
    scale = np.abs(x_r).max()
    np.testing.assert_allclose(x, x_r, atol=1e-4 * scale)
    D3, O3 = random_spd_tridiag(n, 3, seed=n + 1)
    bm = rng.standard_normal((n, 3, 3)).astype(np.float32)
    x_r = np.asarray(jax.jit(
        lambda D, O, b: jbt.bcr_solve_multi(jbt.bcr_factor(D, O), b))(
            jnp.asarray(D3), jnp.asarray(O3), jnp.asarray(bm)))
    x = _np(tbt.bcr_solve_multi(tbt.bcr_factor(_t(D3), _t(O3)), _t(bm)))
    np.testing.assert_allclose(x, x_r, atol=1e-4 * np.abs(x_r).max())


def test_chain_offdiag_matches_reference():
    rng = np.random.default_rng(2)
    P = 16
    e_i = np.array([0, 1, 2, 5, 9, 3, 7], np.int32)
    e_j = np.array([1, 2, 3, 4, 8, 10, 6], np.int32)
    Ji = rng.standard_normal((7, 6, 6)).astype(np.float32)
    Jj = rng.standard_normal((7, 6, 6)).astype(np.float32)
    ref = jbt.chain_offdiag_from_edges(jnp.asarray(e_i), jnp.asarray(e_j),
                                       jnp.asarray(Ji), jnp.asarray(Jj), P)
    got = tbt.chain_offdiag_from_edges(_t(e_i), _t(e_j), _t(Ji), _t(Jj), P)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=OP_TOL)


def _graphs(fg):
    return fg.to_arrays(), interop.graph_arrays_from(fg.to_arrays(),
                                                     device="cpu")


def test_chordal_init_matches_reference():
    rng = np.random.default_rng(0)
    fg, _, _ = scrambled_graph(rng)
    gj, gt = _graphs(fg)
    R_r, t_r = jchordal(gj)
    R, t = chordal_initialize(gt)
    np.testing.assert_allclose(_np(R), np.asarray(R_r), atol=POSE_TOL)
    np.testing.assert_allclose(_np(t), np.asarray(t_r), atol=POSE_TOL)


def test_residuals_and_jacobians_match_reference():
    rng = np.random.default_rng(3)
    fg, _, _ = build_graph(rng, n=20, noise=0.01,
                           outliers=((2, 12),), init_noise=0.2)
    gj, gt = _graphs(fg)
    r_r, Ji_r, Jj_r = jax.jit(jpgo.edge_residuals_jacobians)(gj, gj.R, gj.t)
    r, Ji, Jj = tpgo.edge_residuals_jacobians(gt, gt.R, gt.t)
    # residuals are whitened by 1/0.01: compare relative to their scale
    for a, b in ((r, r_r), (Ji, Ji_r), (Jj, Jj_r)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, atol=1e-5 * np.abs(b).max())
    cost_r = jpgo.graph_cost(gj, gj.R, gj.t, jnp.ones_like(gj.edge_mask))
    cost = tpgo.graph_cost(gt, gt.R, gt.t, torch.ones_like(gt.edge_mask))
    assert float(cost) == pytest.approx(float(cost_r), rel=1e-4)


def _solve_both(fg, cfg, **port_kw):
    tfg = interop.factor_graph_from(fg)
    res_r = jpgo.optimize(fg, cfg)
    res = tpgo.optimize(tfg, interop.pgo_config_from_dict(cfg),
                        device="cpu", **port_kw)
    return res_r, res, tfg


def _assert_same_solution(res_r, res, n_factors):
    np.testing.assert_allclose(_np(res.t), np.asarray(res_r.t), atol=POSE_TOL)
    np.testing.assert_allclose(_np(res.R), np.asarray(res_r.R), atol=POSE_TOL)
    w_r = np.asarray(res_r.weights)[:n_factors] > 0.5
    w = _np(res.weights)[:n_factors] > 0.5
    np.testing.assert_array_equal(w, w_r)
    assert res.gnc_iters == int(res_r.gnc_iters)
    assert float(res.cost) == pytest.approx(float(res_r.cost), rel=1e-3,
                                            abs=1e-4)


def test_single_gross_outlier_does_not_reject_true_loop():
    """test_pgo.py:283 on the port: the anneal keeps the true loop and
    rejects the 9 m outlier, as the reference does on the same graph."""
    rng = np.random.default_rng(2)
    n = 60
    sq = np.diag(1.0 / np.array([0.01] * 3 + [0.05] * 3, np.float32))
    from cslam_tpu.backend.factor_graph import BetweenFactor, FactorGraph
    fg = FactorGraph()
    Rk, tk = np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32)
    fg.add_node((0, 0), Rk, tk)
    xi = jnp.asarray([0, 0, 2 * np.pi / n, 1.0, 0, 0], dtype=jnp.float32)
    step, t_step = (np.asarray(a) for a in jse3.se3_exp(xi))
    for k in range(n - 1):
        nR, nt = jse3.se3_exp(jnp.asarray(
            rng.standard_normal(6) * 0.0005, dtype=jnp.float32))
        Rm = step @ np.asarray(nR)
        tm = t_step + np.asarray(nt)
        fg.add_between(BetweenFactor((0, k), (0, k + 1), Rm, tm, sq))
        tk = Rk @ tm + tk
        Rk = Rk @ Rm
        fg.add_node((0, k + 1), Rk, tk)
    fg.add_between(BetweenFactor((0, 0), (0, n - 1), step.T,
                                 -step.T @ t_step, sq, is_loop=True))
    fg.add_between(BetweenFactor((0, 5), (0, 40),
                                 np.eye(3, dtype=np.float32),
                                 np.asarray([9., 9., 9.], np.float32), sq,
                                 is_loop=True))
    fg.set_prior((0, 0))
    res_r, res, _ = _solve_both(fg, jpgo.PGOConfig())
    w = _np(res.weights)[:fg.num_factors]
    assert w[-1] < 0.1, "gross outlier must be rejected"
    assert w[-2] > 0.9, "true loop must survive the anneal"
    _assert_same_solution(res_r, res, fg.num_factors)
