"""Chordal initialization for pose-graph optimization.

Port of cslam_tpu/backend/initialization.py (Carlone et al., ICRA
2015): rotation averaging in the chordal relaxation — one linear least
squares over the stacked 9-D rotation vectors, projected back to SO(3)
— then translations from a second linear solve with rotations fixed.
Both solves are PCG preconditioned by an exact block-tridiagonal solve
of the odometry chain (ops/block_tridiag.py); the loop runs on the host
with the reference's stopping rule (plain residual vs tol * |b|^2).
"""

import torch

from cslam_tpu_torch.backend.factor_graph import GraphArrays
from cslam_tpu_torch.ops import se3
from cslam_tpu_torch.ops.block_tridiag import (bcr_factor, bcr_solve,
                                               bcr_solve_multi)


def _pcg(matvec, apply_minv, b, iters, tol=1e-14):
    """Preconditioned CG, gated on the plain residual norm."""
    bb = torch.clamp(torch.sum(b * b), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = apply_minv(b)
    p = z
    rz = torch.sum(b * z)
    it = 0
    while it < iters and bool(torch.sum(r * r) > tol * bb):
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_minv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x


def _chain_tridiag_factor(g, w, anchor_w, couple_fwd, couple_rev, s):
    """BCR factor of the chain-tridiagonal part of a chordal normal-
    equation system (s = 3 blocks): w on both endpoint diagonals, the
    chain edges' -w * couple(edge) as the only off-diagonals kept."""
    P = g.R.shape[0]
    ei, ej = g.e_i.long(), g.e_j.long()
    deg = torch.zeros((P,), dtype=w.dtype, device=w.device)
    deg.index_add_(0, ei, w)
    deg.index_add_(0, ej, w)
    dscale = deg + 1e-6
    dscale[int(g.prior_idx)] += anchor_w
    D = dscale[:, None, None] * torch.eye(s, dtype=w.dtype,
                                         device=w.device)[None]
    fwd = ((ej == ei + 1) & (w > 0))[:, None]
    rev = ((ei == ej + 1) & (w > 0))[:, None]
    O = torch.zeros((P, s * s), dtype=w.dtype, device=w.device)
    wb = w[:, None]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    O.index_add_(0, ej, torch.where(
        fwd, -couple_fwd.reshape(-1, s * s) * wb, zero))
    O.index_add_(0, ei, torch.where(
        rev, -couple_rev.reshape(-1, s * s) * wb, zero))
    O = O.reshape(P, s, s).clone()
    O[0] = 0.0
    return bcr_factor(D, O)


def chordal_initialize(g: GraphArrays, cg_iters=None):
    """(R, t) initial estimates from the chordal relaxation of g's
    between-measurements, anchored at the prior pose."""
    P = g.R.shape[0]
    if cg_iters is None:
        cg_iters = min(max(100, P // 4), 600)
    w = g.edge_mask
    anchor_w = 1e2
    pi = int(g.prior_idx)
    ei, ej = g.e_i.long(), g.e_j.long()
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device)

    # ---- stage 1: rotations, x_i = R_i as (P, 9) ----
    Z = g.R_meas

    def rot_matvec(X):
        Xi = X.reshape(P, 3, 3)[ei]
        Xj = X.reshape(P, 3, 3)[ej]
        r_e = (Xj - Xi @ Z) * w[:, None, None]
        back = r_e @ Z.transpose(-2, -1)
        out = torch.zeros((P, 9), dtype=X.dtype, device=X.device)
        out.index_add_(0, ej, r_e.reshape(-1, 9))
        out.index_add_(0, ei, -back.reshape(-1, 9))
        out[pi] += anchor_w * X[pi]
        return out + 1e-6 * X

    fac_rot = _chain_tridiag_factor(g, w, anchor_w, Z.transpose(-2, -1),
                                    Z, 3)

    def solve_rows(Vflat):
        return bcr_solve_multi(fac_rot, Vflat.reshape(P, 3, 3)).reshape(P, 9)

    b_rot = torch.zeros((P, 9), dtype=w.dtype, device=w.device)
    b_rot[pi] += anchor_w * g.prior_R.reshape(9)
    X = _pcg(rot_matvec, solve_rows, b_rot, iters=cg_iters).reshape(P, 3, 3)
    R_init = se3.normalize_rotation(X + 1e-6 * eye3)
    R_init = torch.where(g.node_mask[:, None, None] > 0, R_init, eye3[None])

    # ---- stage 2: translations with rotations fixed ----
    rhs_e = (R_init[ei] @ g.t_meas[..., None])[..., 0] * w[:, None]

    def t_matvec(T):
        r_e = (T[ej] - T[ei]) * w[:, None]
        out = torch.zeros_like(T)
        out.index_add_(0, ej, r_e)
        out.index_add_(0, ei, -r_e)
        out[pi] += anchor_w * T[pi]
        return out + 1e-6 * T

    b_t = torch.zeros((P, 3), dtype=w.dtype, device=w.device)
    b_t.index_add_(0, ej, rhs_e)
    b_t.index_add_(0, ei, -rhs_e)
    b_t[pi] += anchor_w * g.prior_t
    eyes = eye3.expand(Z.shape)
    fac_t = _chain_tridiag_factor(g, w, anchor_w, eyes, eyes, 3)
    t_init = _pcg(t_matvec, lambda v: bcr_solve(fac_t, v), b_t,
                  iters=cg_iters)
    return R_init, t_init * g.node_mask[:, None]
