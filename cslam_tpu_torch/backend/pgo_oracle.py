"""Independent GNC-LM pose-graph-optimization oracle (numpy/scipy).

The port's own copy of cslam_tpu/backend/pgo_oracle.py (numpy and
scipy only; the port imports nothing of the reference package).
`from_graph_arrays` reads the port's GraphArrays (torch tensors on any
device) as well as numpy arrays.

Purpose: an INDEPENDENT correctness reference for backend/pgo.py — a
deliberately slow re-implementation of the algorithm Swarm-SLAM runs
(gtsam GncOptimizer<GncParams<LevenbergMarquardtParams>>, its
decentralized_pgo.cpp:861-886), sharing no code with the port's solver
(single-device or mesh-sharded):

- rotations go through scipy.spatial.transform.Rotation (an external
  SO(3) exp/log implementation, not ops/se3);
- Jacobians are CENTRAL FINITE DIFFERENCES of the residual under right
  perturbations (the solver uses forward-mode autodiff of an
  analytically reduced form — a derivation bug there cannot also be
  here);
- the linear solve is dense numpy (`np.linalg.solve` of the damped
  normal equations) — no PCG, no preconditioner, no padding/masking.

Conventions matched to the production solver (CLAUDE.md invariants):
tangent ordering [omega, v]; between residual
r = sqrt_info @ Log(Z^-1 X_i^-1 X_j); cost 0.5 sum w ||r||^2 plus the
0.5||w_p Log(P^-1 X)||^2 gauge prior; GNC-TLS on u = 0.5||r||^2 with
gtsam's weight rule and mu schedule (initializeMu: mu0 =
barcSq/(2 u_max - barcSq); updateMu: mu *= muStep; calculateWeights
bounds (mu+1)/mu * barcSq and mu/(mu+1) * barcSq).

This is test infrastructure: O(P^3) per LM step and a Python loop over
edges per Jacobian — keep graphs in the few-hundred-pose range.
"""

from typing import NamedTuple

import numpy as np
from scipy.spatial.transform import Rotation


# ----------------------------------------------------------------------
# SE(3) via scipy Rotation
# ----------------------------------------------------------------------
def _so3_exp(w):
    return Rotation.from_rotvec(w).as_matrix()


def _so3_log(R):
    return Rotation.from_matrix(R).as_rotvec()


def _V(w):
    """Left Jacobian of SO(3): t = V(omega) v for the SE(3) exponential."""
    th = np.linalg.norm(w)
    W = np.array([[0.0, -w[2], w[1]],
                  [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    if th < 1e-8:
        return np.eye(3) + 0.5 * W + W @ W / 6.0
    a = (1.0 - np.cos(th)) / th**2
    b = (th - np.sin(th)) / th**3
    return np.eye(3) + a * W + b * (W @ W)


def se3_exp(xi):
    """xi = [omega, v] -> (R, t) with t = V(omega) v (GTSAM Expmap)."""
    w, v = np.asarray(xi[:3], float), np.asarray(xi[3:], float)
    return _so3_exp(w), _V(w) @ v


def se3_log(R, t):
    w = _so3_log(R)
    v = np.linalg.solve(_V(w), np.asarray(t, float))
    return np.concatenate([w, v])


def compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def between(Ra, ta, Rb, tb):
    """A^-1 B."""
    return Ra.T @ Rb, Ra.T @ (tb - ta)


# ----------------------------------------------------------------------
# Graph in plain-python form
# ----------------------------------------------------------------------
class OracleGraph(NamedTuple):
    R: np.ndarray          # (P, 3, 3) initial rotations
    t: np.ndarray          # (P, 3) initial translations
    e_i: np.ndarray        # (E,) int
    e_j: np.ndarray        # (E,) int
    R_meas: np.ndarray     # (E, 3, 3)
    t_meas: np.ndarray     # (E, 3)
    sqrt_info: np.ndarray  # (E, 6, 6)
    is_loop: np.ndarray    # (E,) bool
    prior_idx: int
    prior_R: np.ndarray
    prior_t: np.ndarray
    prior_weight: float


def _host(x, dtype=None):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def from_graph_arrays(g) -> OracleGraph:
    """Strip the padded/masked graph arrays down to valid entries."""
    nm = _host(g.node_mask) > 0
    em = _host(g.edge_mask) > 0
    P = int(nm.sum())
    if not nm[:P].all():
        raise ValueError("node mask must be a prefix")
    return OracleGraph(
        R=_host(g.R, float)[:P],
        t=_host(g.t, float)[:P],
        e_i=_host(g.e_i)[em].astype(int),
        e_j=_host(g.e_j)[em].astype(int),
        R_meas=_host(g.R_meas, float)[em],
        t_meas=_host(g.t_meas, float)[em],
        sqrt_info=_host(g.sqrt_info, float)[em],
        is_loop=_host(g.is_loop)[em] > 0,
        prior_idx=int(g.prior_idx),
        prior_R=_host(g.prior_R, float),
        prior_t=_host(g.prior_t, float),
        prior_weight=float(g.prior_weight),
    )


# ----------------------------------------------------------------------
# Residuals / numerical Jacobians
# ----------------------------------------------------------------------
def _edge_residual(og, e, R, t):
    i, j = og.e_i[e], og.e_j[e]
    Rrel, trel = between(R[i], t[i], R[j], t[j])
    Rerr, terr = between(og.R_meas[e], og.t_meas[e], Rrel, trel)
    return og.sqrt_info[e] @ se3_log(Rerr, terr)


def _prior_residual(og, R, t):
    Rerr, terr = between(og.prior_R, og.prior_t,
                         R[og.prior_idx], t[og.prior_idx])
    return og.prior_weight * se3_log(Rerr, terr)


def _batched_V(w):
    """(E, 3, 3) left Jacobians for a batch of rotation vectors."""
    E = len(w)
    th = np.linalg.norm(w, axis=1)
    W = np.zeros((E, 3, 3))
    W[:, 0, 1], W[:, 0, 2] = -w[:, 2], w[:, 1]
    W[:, 1, 0], W[:, 1, 2] = w[:, 2], -w[:, 0]
    W[:, 2, 0], W[:, 2, 1] = -w[:, 1], w[:, 0]
    W2 = W @ W
    small = th < 1e-8
    ths = np.where(small, 1.0, th)  # guard divisions
    a = np.where(small, 0.5, (1.0 - np.cos(ths)) / ths**2)
    b = np.where(small, 1.0 / 6.0, (ths - np.sin(ths)) / ths**3)
    return (np.eye(3)[None] + a[:, None, None] * W
            + b[:, None, None] * W2)


def _batched_se3_log(R, t):
    """(E, 6) Log for batches of (R, t) — scipy Rotation is batched."""
    w = Rotation.from_matrix(R).as_rotvec()
    v = np.linalg.solve(_batched_V(w), np.asarray(t, float)[..., None])
    return np.concatenate([w, v[..., 0]], axis=1)


def _residuals_at(og, Ri, ti, Rj, tj):
    """Batched residuals given per-edge endpoint poses (E, 3, 3)/(E, 3)."""
    Rrel = np.einsum("eba,ebc->eac", Ri, Rj)
    trel = np.einsum("eba,eb->ea", Ri, tj - ti)
    Rerr = np.einsum("eba,ebc->eac", og.R_meas, Rrel)
    terr = np.einsum("eba,eb->ea", og.R_meas, trel - og.t_meas)
    return np.einsum("eij,ej->ei", og.sqrt_info, _batched_se3_log(Rerr, terr))


def residuals(og, R, t):
    return _residuals_at(og, R[og.e_i], t[og.e_i], R[og.e_j], t[og.e_j])


def cost(og, R, t, w):
    r = residuals(og, R, t)
    rp = _prior_residual(og, R, t)
    return 0.5 * float(np.sum(w * np.sum(r * r, axis=1))
                       + np.sum(rp * rp))


def _perturbed(R, t, k, xi):
    dR, dt = se3_exp(xi)
    Rk, tk = compose(R[k], t[k], dR, dt)
    R2, t2 = R.copy(), t.copy()
    R2[k], t2[k] = Rk, tk
    return R2, t2


_EPS = 1e-6


def _numeric_edge_jacobians(og, e, R, t):
    """Central-difference d r_e / d xi at both endpoints: (6,6), (6,6)."""
    jacs = []
    for k in (og.e_i[e], og.e_j[e]):
        J = np.zeros((6, 6))
        for d in range(6):
            xi = np.zeros(6)
            xi[d] = _EPS
            rp = _edge_residual(og, e, *_perturbed(R, t, k, xi))
            xi[d] = -_EPS
            rm = _edge_residual(og, e, *_perturbed(R, t, k, xi))
            J[:, d] = (rp - rm) / (2.0 * _EPS)
        jacs.append(J)
    return jacs


def _numeric_jacobians_batched(og, R, t):
    """((E,6,6), (E,6,6)) central-difference Jacobians, vectorized over
    edges: each probe perturbs every edge's OWN endpoint copy at once
    (edge residuals only read their two endpoints, so per-edge local
    perturbations don't interfere). 24 batched residual passes replace
    E x 24 scalar ones."""
    Ri, ti = R[og.e_i], t[og.e_i]
    Rj, tj = R[og.e_j], t[og.e_j]
    E = len(og.e_i)
    Ji = np.zeros((E, 6, 6))
    Jj = np.zeros((E, 6, 6))
    for d in range(6):
        probes = []
        for s in (+_EPS, -_EPS):
            xi = np.zeros(6)
            xi[d] = s
            probes.append(se3_exp(xi))
        (dRp, dtp), (dRm, dtm) = probes
        # endpoint i
        rp = _residuals_at(og, Ri @ dRp,
                           np.einsum("eab,b->ea", Ri, dtp) + ti, Rj, tj)
        rm = _residuals_at(og, Ri @ dRm,
                           np.einsum("eab,b->ea", Ri, dtm) + ti, Rj, tj)
        Ji[:, :, d] = (rp - rm) / (2.0 * _EPS)
        # endpoint j
        rp = _residuals_at(og, Ri, ti, Rj @ dRp,
                           np.einsum("eab,b->ea", Rj, dtp) + tj)
        rm = _residuals_at(og, Ri, ti, Rj @ dRm,
                           np.einsum("eab,b->ea", Rj, dtm) + tj)
        Jj[:, :, d] = (rp - rm) / (2.0 * _EPS)
    return Ji, Jj


def _numeric_prior_jacobian(og, R, t):
    J = np.zeros((6, 6))
    for d in range(6):
        xi = np.zeros(6)
        xi[d] = _EPS
        rp = _prior_residual(og, *_perturbed(R, t, og.prior_idx, xi))
        xi[d] = -_EPS
        rm = _prior_residual(og, *_perturbed(R, t, og.prior_idx, xi))
        J[:, d] = (rp - rm) / (2.0 * _EPS)
    return J


# ----------------------------------------------------------------------
# Dense Levenberg-Marquardt
# ----------------------------------------------------------------------
def lm_optimize(og, R, t, w, max_iters=50, lam0=1e-4, rel_tol=1e-9):
    R, t = R.copy(), t.copy()
    P = len(R)
    lam = lam0
    c = cost(og, R, t, w)
    for _ in range(max_iters):
        H = np.zeros((6 * P, 6 * P))
        g = np.zeros(6 * P)
        r_all = residuals(og, R, t)
        Ji_all, Jj_all = _numeric_jacobians_batched(og, R, t)
        for e in range(len(og.e_i)):
            if w[e] == 0.0:
                continue
            r, Ji, Jj = r_all[e], Ji_all[e], Jj_all[e]
            i, j = og.e_i[e], og.e_j[e]
            for (a, Ja) in ((i, Ji), (j, Jj)):
                g[6 * a:6 * a + 6] += w[e] * (Ja.T @ r)
                for (b, Jb) in ((i, Ji), (j, Jj)):
                    H[6 * a:6 * a + 6, 6 * b:6 * b + 6] += \
                        w[e] * (Ja.T @ Jb)
        rp = _prior_residual(og, R, t)
        Jp = _numeric_prior_jacobian(og, R, t)
        k = og.prior_idx
        g[6 * k:6 * k + 6] += Jp.T @ rp
        H[6 * k:6 * k + 6, 6 * k:6 * k + 6] += Jp.T @ Jp

        dx = np.linalg.solve(H + lam * np.eye(6 * P), -g)
        R2, t2 = R.copy(), t.copy()
        for p in range(P):
            dR, dt = se3_exp(dx[6 * p:6 * p + 6])
            R2[p], t2[p] = compose(R[p], t[p], dR, dt)
        c2 = cost(og, R2, t2, w)
        if c2 < c:
            rel = abs(c - c2) / max(c, 1e-30)
            R, t, c = R2, t2, c2
            lam = max(lam * 0.5, 1e-12)
            if rel < rel_tol:
                break
        else:
            lam *= 4.0
            if lam > 1e10:
                break
    return R, t, c


# ----------------------------------------------------------------------
# GNC-TLS outer loop (gtsam GncOptimizer semantics)
# ----------------------------------------------------------------------
def _tls_weights(u, mu, barc_sq):
    ub = (mu + 1.0) / mu * barc_sq
    lb = mu / (mu + 1.0) * barc_sq
    w = np.sqrt(barc_sq * mu * (mu + 1.0) / np.maximum(u, 1e-30)) - mu
    w = np.clip(w, 0.0, 1.0)
    w[u >= ub] = 0.0
    w[u <= lb] = 1.0
    return w


class OracleResult(NamedTuple):
    R: np.ndarray
    t: np.ndarray
    cost: float
    weights: np.ndarray
    gnc_iters: int


def gnc_optimize(og: OracleGraph, barc_sq=10.0, mu_step=1.4,
                 max_outer=20, lm_iters=50,
                 gnc_on_loops_only=True) -> OracleResult:
    """Full GNC-TLS robust solve from the graph's initial estimates."""
    E = len(og.e_i)
    robust = og.is_loop if gnc_on_loops_only else np.ones(E, bool)
    ones = np.ones(E)
    R, t, _ = lm_optimize(og, og.R, og.t, ones, max_iters=lm_iters)

    r = residuals(og, R, t)
    u = 0.5 * np.sum(r * r, axis=1)
    u_rob = np.where(robust, u, 0.0)
    denom = 2.0 * float(u_rob.max()) - barc_sq
    if denom <= 0.0:  # every robust residual already an inlier
        c = cost(og, R, t, ones)
        return OracleResult(R, t, c, ones, 0)
    mu = barc_sq / denom

    w = np.where(robust, _tls_weights(u, mu, barc_sq), 1.0)
    mu *= mu_step
    it = 0
    for it in range(1, max_outer + 1):
        R, t, _ = lm_optimize(og, R, t, w, max_iters=lm_iters)
        r = residuals(og, R, t)
        u = 0.5 * np.sum(r * r, axis=1)
        w_new = np.where(robust, _tls_weights(u, mu, barc_sq), 1.0)
        frac = float(np.sum(w_new * (1.0 - w_new) * robust))
        stable = float(np.max(np.abs(w_new - w) * robust)) < 1e-3
        w = w_new
        mu *= mu_step
        if frac < 1e-5 and stable:
            break
    R, t, c = lm_optimize(og, R, t, w, max_iters=lm_iters)
    return OracleResult(R, t, c, w, it)
