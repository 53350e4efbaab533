"""GNC-robust pose-graph optimization — the port's back-end core.

Port of cslam_tpu/backend/pgo.py:

  GNC outer loop (TLS surrogate, mu *= mu_step)
    -> Levenberg-Marquardt inner loop
       -> per-edge whitened residuals r_e = Gamma Log(Z^-1 X_i^-1 X_j)
          and right-perturbation Jacobians (forward-mode autodiff of
          xi -> Gamma Log(E0 exp(xi)), J_i from the adjoint);
       -> the Gauss-Newton normal equations by dense Cholesky (small
          graphs) or PCG with the block-cyclic-reduction chain
          preconditioner (ops/block_tridiag.py).

Every `lax.while_loop` of the reference is a Python loop here whose
condition is read on the host, with the reference's conditions and caps
unchanged (CG checked every `cg_unroll` steps, LM accept/stop, GNC
binariness + stability), so iteration counts match. Padded nodes and
edges contribute zero through masks.

Instrumented (`runtime/tracing.py`): `optimize`'s host span `pgo_arrays`
around the graph's build and upload, and `gnc_optimize`'s counter `pgo`
with each solve's LM steps, CG iterations, GNC rounds and whether the
PCG path ran (the loops' own host counts: no extra host read). The
counter sits in `gnc_optimize` because that is the one-card solve entry
both `optimize` and `gnc_optimize_batch` go through; the sharded solve
(parallel/distributed_pgo.py) calls `gnc_optimize_core` and records no
counts.
"""

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from cslam_tpu_torch.backend.factor_graph import FactorGraph, GraphArrays
from cslam_tpu_torch.device import DeviceLike, require_full_fp32
from cslam_tpu_torch.ops import se3
from cslam_tpu_torch.ops.batched_linalg import batched_inv_small
from cslam_tpu_torch.ops.block_tridiag import (bcr_factor, bcr_solve,
                                               chain_offdiag_from_edges,
                                               cholesky_or_nan)
from cslam_tpu_torch.runtime.tracing import span, tracer


class EdgeReduce(NamedTuple):
    """Cross-shard reductions for factor-sharded solves: `sum` reduces
    edge-summed quantities, `max` edge maxima. None = single device."""
    sum: object
    max: object


def _rsum(red, x):
    return x if red is None else red.sum(x)


def _rmax(red, x):
    return x if red is None else red.max(x)


class PGOResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    cost: torch.Tensor          # final robust cost
    initial_cost: torch.Tensor
    gnc_iters: int
    weights: torch.Tensor       # final GNC weights per edge


class PGOConfig(NamedTuple):
    """The reference's solver settings, defaults unchanged (see
    cslam_tpu/backend/pgo.py for the measurements behind each)."""
    barc_sq: float = 10.0
    mu_step: float = 1.4
    gnc_max_outer_iters: int = 20
    lm_max_iters: int = 12
    lm_init_lambda: float = 1e-4
    cg_max_iters: int = 25
    gnc_cg_max_iters: int = 0
    cg_tol: float = 1e-6
    cg_unroll: int = 4
    gnc_lm_iters: int = 2
    lm_init_iters: int = 5
    gnc_on_loops_only: bool = True
    # "pcg", "dense", or "auto" (dense when 6P <= dense_threshold)
    linear_solver: str = "auto"
    dense_threshold: int = 1536
    # "tridiag" (BCR chain solve) or "jacobi" (6x6 block inverses)
    preconditioner: str = "tridiag"
    use_chordal_init: bool = False


# ----------------------------------------------------------------------
# Residuals and Jacobians
# ----------------------------------------------------------------------
def _jacobian_at_zero(f, n, like, *args):
    """Forward-mode Jacobian (n, out, 6) at xi = 0 of the batched map
    xi (n, 6) -> f(xi, *args) (n, out), one tangent direction per
    basis vector (the reference's jacfwd). The map is evaluated on the
    whole batch at once: forward-mode derivatives of 0-dim per-sample
    tensors times Python floats come out in float64 in this PyTorch."""
    zeros = torch.zeros((n, 6), dtype=like.dtype, device=like.device)
    basis = torch.eye(6, dtype=like.dtype, device=like.device)[:, None, :]
    cols = vmap(lambda v: jvp(lambda x: f(x, *args), (zeros,),
                              (v.expand(n, 6),))[1])(basis)
    return cols.permute(1, 2, 0)


def _log_after_perturb(xi, RE, tE, Gamma):
    """Gamma Log(E exp(xi)), batched over edges."""
    dR, dt = se3.se3_exp(xi)
    Rc, tc = se3.compose(RE, tE, dR, dt)
    return (Gamma @ se3.se3_log(Rc, tc)[..., None])[..., 0]


def _prior_residual(xi, Rp, tp, Rx, tx, w):
    dR, dt = se3.se3_exp(xi)
    Rx2, tx2 = se3.compose(Rx, tx, dR, dt)
    Rerr, terr = se3.between(Rp, tp, Rx2, tx2)
    return w * se3.se3_log(Rerr, terr)


def _long(x):
    return x.to(torch.int64)


def edge_residuals(g: GraphArrays, R, t):
    """(E, 6) whitened residuals of all between factors at (R, t)."""
    ei, ej = _long(g.e_i), _long(g.e_j)
    Rrel, trel = se3.between(R[ei], t[ei], R[ej], t[ej])
    RE, tE = se3.between(g.R_meas, g.t_meas, Rrel, trel)
    return (g.sqrt_info @ se3.se3_log(RE, tE)[..., None])[..., 0]


def edge_residuals_jacobians(g: GraphArrays, R, t):
    """Fused (r, Ji, Jj) for all between factors: Jj is the forward-mode
    Jacobian of xi -> Gamma Log(E0 exp(xi)) at 0, and
    J_i = -J_j Ad_{X_j^-1 X_i} by group structure."""
    ei, ej = _long(g.e_i), _long(g.e_j)
    Ri, ti = R[ei], t[ei]
    Rj, tj = R[ej], t[ej]
    Rrel, trel = se3.between(Ri, ti, Rj, tj)
    RE, tE = se3.between(g.R_meas, g.t_meas, Rrel, trel)
    r = (g.sqrt_info @ se3.se3_log(RE, tE)[..., None])[..., 0]
    Jj = _jacobian_at_zero(_log_after_perturb, ei.shape[0], R, RE, tE,
                           g.sqrt_info)
    Rji, tji = se3.between(Rj, tj, Ri, ti)
    Ji = -(Jj @ se3.adjoint(Rji, tji))
    return r, Ji, Jj


def edge_jacobians(g: GraphArrays, R, t):
    """((E,6,6), (E,6,6)) Jacobians wrt right-perturbations of X_i, X_j."""
    _, Ji, Jj = edge_residuals_jacobians(g, R, t)
    return Ji, Jj


def _prior_terms(g, R, t, jac=False):
    """The gauge prior's (6,) residual, or its (6, 6) Jacobian."""
    pi = int(g.prior_idx)
    args = (g.prior_R[None], g.prior_t[None], R[pi:pi + 1], t[pi:pi + 1],
            g.prior_weight)
    if jac:
        return _jacobian_at_zero(_prior_residual, 1, R, *args)[0]
    return _prior_residual(torch.zeros((1, 6), dtype=R.dtype,
                                       device=R.device), *args)[0]


def graph_cost(g: GraphArrays, R, t, weights, red=None):
    """Robust weighted cost 0.5 sum w_e |r_e|^2 (+ prior)."""
    r = edge_residuals(g, R, t)
    u = 0.5 * torch.sum(r * r, dim=-1)
    cost = _rsum(red, torch.sum(weights * g.edge_mask * u))
    rp = _prior_terms(g, R, t)
    return cost + 0.5 * torch.sum(rp * rp)


# ----------------------------------------------------------------------
# Gauss-Newton normal equations: dense Cholesky or PCG
# ----------------------------------------------------------------------
def _jtj(A, B):
    """Per-edge A^T B of (E, 6, 6) blocks."""
    return A.transpose(-2, -1) @ B


def _solve_normal_eqs_dense(g: GraphArrays, Ji, Jj, r, lam, Jp, rp):
    """Assemble H = J^T J as a dense (6P, 6P) matrix, solve by Cholesky."""
    P = g.R.shape[0]
    ei, ej = _long(g.e_i), _long(g.e_j)
    pi = int(g.prior_idx)
    H = torch.zeros((P * P, 36), dtype=r.dtype, device=r.device)
    H.index_add_(0, ei * P + ei, _jtj(Ji, Ji).reshape(-1, 36))
    H.index_add_(0, ej * P + ej, _jtj(Jj, Jj).reshape(-1, 36))
    H.index_add_(0, ei * P + ej, _jtj(Ji, Jj).reshape(-1, 36))
    H.index_add_(0, ej * P + ei, _jtj(Jj, Ji).reshape(-1, 36))
    H[pi * (P + 1)] += (Jp.T @ Jp).reshape(36)
    H6 = H.reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
    H6 = H6 + lam * torch.eye(6 * P, dtype=r.dtype, device=r.device)
    b = torch.zeros((P, 6), dtype=r.dtype, device=r.device)
    b.index_add_(0, ei, (Ji.transpose(-2, -1) @ r[..., None])[..., 0])
    b.index_add_(0, ej, (Jj.transpose(-2, -1) @ r[..., None])[..., 0])
    b[pi] += Jp.T @ rp
    rhs = -b.reshape(6 * P, 1)
    L = cholesky_or_nan(H6)
    dx = torch.cholesky_solve(rhs, L)
    return dx.reshape(P, 6) * g.node_mask[:, None]


# Max P*2E entries for the one-hot incidence matmul in the PCG matvec
# (the reference's bucket rule; module-level so tests can pin a path).
_INCIDENCE_MAX_ENTRIES = 4 * 1024 * 1024


def edge_transpose_operators(e_i, e_j, edge_mask, P, dtype):
    """(idx, gather_x, jt_scatter) for the stacked (2E,) edge layout:
    one-hot incidence matmuls up to _INCIDENCE_MAX_ENTRIES, gather /
    index_add beyond."""
    idx = torch.cat([_long(e_i), _long(e_j)])
    if P * idx.shape[0] <= _INCIDENCE_MAX_ENTRIES:
        inc = (idx[None, :] == torch.arange(P, device=idx.device)[:, None])
        emask2 = torch.cat([edge_mask, edge_mask])
        inc = inc.to(dtype) * emask2[None, :]
        inc_t = inc.T

        def gather_x(x):
            return inc_t @ x

        def jt_scatter(vals):
            return inc @ vals
    else:
        def gather_x(x):
            return x[idx]

        def jt_scatter(vals):
            out = torch.zeros((P, 6), dtype=dtype, device=vals.device)
            return out.index_add_(0, idx, vals)
    return idx, gather_x, jt_scatter


def _build_precond(g: GraphArrays, Ji, Jj, lam, cfg, Jp, red=None):
    """PCG preconditioner from sqrt(weight)*mask-scaled Jacobians, built
    once per LM solve: ("tridiag", BCR factor) or ("jacobi", inverses)."""
    P = g.R.shape[0]
    Jst = torch.cat([Ji, Jj])
    idx = torch.cat([_long(g.e_i), _long(g.e_j)])
    Hii = torch.zeros((P, 36), dtype=Ji.dtype, device=Ji.device)
    Hii.index_add_(0, idx, _jtj(Jst, Jst).reshape(-1, 36))
    Hii = _rsum(red, Hii)
    Hii[int(g.prior_idx)] += (Jp.T @ Jp).reshape(36)
    Hii = Hii.reshape(P, 6, 6) + lam * torch.eye(6, dtype=Ji.dtype,
                                                 device=Ji.device)[None]
    if cfg.preconditioner == "tridiag":
        O_chain = _rsum(red, chain_offdiag_from_edges(
            g.e_i, g.e_j, Ji, Jj, P).reshape(P, 36)).reshape(P, 6, 6)
        return ("tridiag", bcr_factor(Hii, O_chain))
    return ("jacobi", batched_inv_small(Hii))


def _solve_normal_eqs(g: GraphArrays, Ji, Jj, r, sw, lam, Jp, rp, cfg,
                      x0=None, cg_iters=None, precond=None, red=None,
                      return_iters=False):
    """PCG solve of (J^T J + lam I) dx = -J^T r; Ji/Jj/r pre-scaled by
    sqrt(weight)*mask. `x0` warm-starts CG; `precond` reuses a
    _build_precond result. Returns (P, 6) (and the CG count)."""
    P = g.R.shape[0]
    E = Ji.shape[0]
    pi = int(g.prior_idx)
    Jst = torch.cat([Ji, Jj])
    Jst_t = Jst.transpose(-2, -1)
    _, gather_x, jt_scatter = edge_transpose_operators(
        g.e_i, g.e_j, g.edge_mask, P, r.dtype)

    def jt_apply(y):
        y2 = torch.cat([y, y])
        return jt_scatter((Jst_t @ y2[..., None])[..., 0])

    b = -_rsum(red, jt_apply(r))
    b[pi] += -(Jp.T @ rp)

    def hvp(x):
        part = (Jst @ gather_x(x)[..., None])[..., 0]
        out = _rsum(red, jt_apply(part[:E] + part[E:]))
        out[pi] += Jp.T @ (Jp @ x[pi])
        return out + lam * x

    if precond is None:
        precond = _build_precond(g, Ji, Jj, lam, cfg, Jp, red=red)
    kind, state = precond
    mask = g.node_mask[:, None]
    if kind == "tridiag":
        def apply_minv(v):
            return bcr_solve(state, v) * mask
    else:
        def apply_minv(v):
            return (state @ v[..., None])[..., 0]

    def dot(a, c):
        return torch.sum(a * c)

    if x0 is None:
        x = torch.zeros((P, 6), dtype=r.dtype, device=r.device)
        rr = b
    else:
        x = x0 * mask
        rr = b - hvp(x)
    z = apply_minv(rr)
    p = z
    rz = dot(rr, z)
    b_norm = torch.clamp(dot(b, b), min=1e-30)
    unroll = max(int(cfg.cg_unroll), 1)
    cg_budget = cfg.cg_max_iters if cg_iters is None else cg_iters
    it = 0
    while it < cg_budget and bool(dot(rr, rr) > cfg.cg_tol * b_norm):
        for _ in range(unroll):  # fused steps between convergence checks
            Hp = hvp(p)
            alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = apply_minv(rr)
            rz_new = dot(rr, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new
        it += unroll
    dx = x * mask
    if return_iters:
        return dx, it
    return dx


def _retract(R, t, dx, node_mask):
    dR, dt = se3.se3_exp(dx)
    Rn, tn = se3.compose(R, t, dR, dt)
    keep = node_mask[:, None] > 0
    return (torch.where(keep[..., None], Rn, R), torch.where(keep, tn, t))


# ----------------------------------------------------------------------
# Levenberg-Marquardt with GNC weights
# ----------------------------------------------------------------------
def _uses_dense(g: GraphArrays, cfg: PGOConfig, red=None) -> bool:
    """Whether LM solves its normal equations by dense Cholesky (else
    PCG)."""
    return red is None and (cfg.linear_solver == "dense" or (
        cfg.linear_solver == "auto"
        and 6 * g.R.shape[0] <= cfg.dense_threshold))


def _lm_optimize(g: GraphArrays, R, t, weights, cfg: PGOConfig,
                 max_iters=None, lam0=None, cg_iters=None, red=None,
                 count_iters=False):
    """Up to max_iters damped Gauss-Newton steps from (R, t). lam0
    carries the trust-region lambda across GNC rounds. count_iters
    also returns (lm_steps_taken, cg_iterations_total)."""
    max_iters = cfg.lm_max_iters if max_iters is None else max_iters
    sw = torch.sqrt(torch.clamp(weights * g.edge_mask, min=0.0))
    use_dense = _uses_dense(g, cfg, red)

    def eval_point(R, t):
        r, Ji, Jj = edge_residuals_jacobians(g, R, t)
        rp = _prior_terms(g, R, t)
        cost = (_rsum(red, torch.sum(weights * g.edge_mask *
                                     0.5 * torch.sum(r * r, dim=-1)))
                + 0.5 * torch.sum(rp * rp))
        return r, Ji, Jj, rp, cost

    r, Ji, Jj, rp, cost = eval_point(R, t)
    lam = (torch.tensor(cfg.lm_init_lambda, dtype=torch.float32,
                        device=R.device) if lam0 is None else lam0)
    precond = None
    if not use_dense:
        precond = _build_precond(g, Ji * sw[:, None, None],
                                 Jj * sw[:, None, None], lam, cfg,
                                 _prior_terms(g, R, t, jac=True), red=red)
    dx_prev = torch.zeros((g.R.shape[0], 6), dtype=R.dtype, device=R.device)
    it = 0
    cg_tot = 0
    done = False
    while it < max_iters and not done:
        r_s = r * sw[:, None]
        Ji_s = Ji * sw[:, None, None]
        Jj_s = Jj * sw[:, None, None]
        Jp = _prior_terms(g, R, t, jac=True)
        if use_dense:
            dx = _solve_normal_eqs_dense(g, Ji_s, Jj_s, r_s, lam, Jp, rp)
        else:
            dx, cg_it = _solve_normal_eqs(
                g, Ji_s, Jj_s, r_s, sw, lam, Jp, rp, cfg, x0=dx_prev,
                cg_iters=cg_iters, precond=precond, red=red,
                return_iters=True)
            cg_tot += cg_it
        Rc, tc = _retract(R, t, dx, g.node_mask)
        r_c, Ji_c, Jj_c, rp_c, cost_c = eval_point(Rc, tc)
        accept = bool(cost_c < cost)
        rel = torch.abs(cost - cost_c) / torch.clamp(cost, min=1e-30)
        if accept:
            R, t, r, Ji, Jj, rp = Rc, tc, r_c, Ji_c, Jj_c, rp_c
            done = bool(rel < 1e-7)
            cost = cost_c
            lam = lam * 0.5
        else:
            lam = lam * 4.0
        dx_prev = dx
        it += 1
    if count_iters:
        return R, t, cost, lam, it, cg_tot
    return R, t, cost, lam


# ----------------------------------------------------------------------
# GNC outer loop (TLS)
# ----------------------------------------------------------------------
def _gnc_weights_tls(u, mu, barc_sq):
    """gtsam GncOptimizer::calculateWeights for TLS, on u = 0.5|r|^2."""
    ub = (mu + 1.0) / mu * barc_sq
    lb = mu / (mu + 1.0) * barc_sq
    mid = torch.sqrt(barc_sq * mu * (mu + 1.0)
                     / torch.clamp(u, min=1e-30)) - mu
    return torch.where(u >= ub, torch.zeros_like(u),
                       torch.where(u <= lb, torch.ones_like(u),
                                   torch.clamp(mid, 0.0, 1.0)))


def gnc_optimize_core(g: GraphArrays, cfg: PGOConfig, red=None,
                      stop_after: str = "polish",
                      count_iters: bool = False):
    """GNC-TLS robust PGO from the graph's stored initial estimates.

    stop_after in {"init", "gnc", "polish"} truncates the pipeline;
    count_iters also returns a dict of per-phase LM-step and CG totals."""
    require_full_fp32(g.R.device)
    if cfg.use_chordal_init:
        if red is not None:
            raise ValueError("chordal init runs on the full edge set; "
                             "initialize before sharding")
        from cslam_tpu_torch.backend.initialization import chordal_initialize
        R0, t0 = chordal_initialize(g)
        g = g._replace(R=R0, t=t0)
    R0, t0 = g.R, g.t
    ones = torch.ones_like(g.edge_mask)
    initial_cost = graph_cost(g, R0, t0, ones, red=red)
    robust_mask = g.is_loop if cfg.gnc_on_loops_only else g.edge_mask

    lm_init = cfg.lm_init_iters if cfg.lm_init_iters > 0 else cfg.lm_max_iters
    gnc_cg = cfg.gnc_cg_max_iters if cfg.gnc_cg_max_iters > 0 \
        else cfg.cg_max_iters
    stats = {}
    R1, t1, _, lam1, stats["lm_init"], stats["cg_init"] = _lm_optimize(
        g, R0, t0, ones, cfg, max_iters=lm_init, cg_iters=gnc_cg, red=red,
        count_iters=True)
    if stop_after == "init":
        result = PGOResult(R=R1, t=t1,
                           cost=graph_cost(g, R1, t1, ones, red=red),
                           initial_cost=initial_cost, gnc_iters=0,
                           weights=ones)
        return (result, stats) if count_iters else result

    r = edge_residuals(g, R1, t1)
    u = 0.5 * torch.sum(r * r, dim=-1) * g.edge_mask
    max_u = _rmax(red, torch.max(u * robust_mask))
    # gtsam initializeMu (TLS): mu0 = barcSq / (2 rmax^2 - barcSq);
    # non-positive => all residuals already inliers, no GNC needed
    denom = 2.0 * max_u - cfg.barc_sq
    mu0 = cfg.barc_sq / torch.clamp(denom, min=1e-12)
    skip_gnc = bool(denom <= 0.0)

    def weights_for(mu, u):
        w = _gnc_weights_tls(u, mu, cfg.barc_sq)
        return torch.where(robust_mask > 0, w, torch.ones_like(w))

    gnc_lm = cfg.gnc_lm_iters if cfg.gnc_lm_iters > 0 else cfg.lm_max_iters
    w = ones if skip_gnc else weights_for(mu0, u)
    mu = torch.clamp(mu0, min=1e-6)
    R, t, lam = R1, t1, lam1
    gnc_iters, lm_gnc, cg_gnc = 0, 0, 0
    done = skip_gnc
    while gnc_iters < cfg.gnc_max_outer_iters and not done:
        R, t, _, lam, lmN, cgN = _lm_optimize(
            g, R, t, w, cfg, max_iters=gnc_lm, lam0=lam, cg_iters=gnc_cg,
            red=red, count_iters=True)
        lm_gnc += lmN
        cg_gnc += cgN
        r = edge_residuals(g, R, t)
        u = 0.5 * torch.sum(r * r, dim=-1) * g.edge_mask
        w_new = weights_for(mu, u)
        # converged = weights binary on robust factors AND stable across
        # rounds (binariness alone is a trap, see the reference)
        frac = _rsum(red, torch.sum(w_new * (1.0 - w_new) * robust_mask))
        stable = _rmax(red, torch.max(torch.abs(w_new - w) * robust_mask))
        done = bool(frac < 1e-5) and bool(stable < 1e-3)
        gnc_iters += 1
        mu = mu * cfg.mu_step
        w = w_new
    stats["gnc_rounds"] = gnc_iters
    stats["lm_gnc"] = lm_gnc
    stats["cg_gnc"] = cg_gnc
    if stop_after == "gnc":
        result = PGOResult(R=R, t=t, cost=graph_cost(g, R, t, w, red=red),
                           initial_cost=initial_cost, gnc_iters=gnc_iters,
                           weights=w)
        return (result, stats) if count_iters else result

    R, t, cost, _, stats["lm_polish"], stats["cg_polish"] = _lm_optimize(
        g, R, t, w, cfg, lam0=lam, red=red, count_iters=True)
    result = PGOResult(R=R, t=t, cost=cost, initial_cost=initial_cost,
                       gnc_iters=gnc_iters, weights=w)
    return (result, stats) if count_iters else result


def gnc_optimize(g: GraphArrays, cfg: PGOConfig = PGOConfig()) -> PGOResult:
    """Full GNC-TLS robust PGO from the graph's stored initial estimates;
    adds the solve's LM steps, CG iterations, GNC rounds and whether PCG
    ran to the counter `pgo`."""
    result, stats = gnc_optimize_core(g, cfg, count_iters=True)
    phases = ("init", "gnc", "polish")
    tracer.counter("pgo", lm_steps=sum(stats["lm_" + p] for p in phases),
                   cg_iters=sum(stats["cg_" + p] for p in phases),
                   gnc_rounds=stats["gnc_rounds"],
                   pcg=int(not _uses_dense(g, cfg)))
    return result


def gnc_optimize_batch(gs, cfg: PGOConfig = PGOConfig()):
    """GNC-LM over independent graphs of one capacity bucket: a list of
    GraphArrays, solved one after another (the reference's vmap gives
    each member the result of its own solve, so this is the same)."""
    return [gnc_optimize(g, cfg) for g in gs]


def optimize_batch(fgs, cfg: PGOConfig = PGOConfig(),
                   device: DeviceLike = None):
    """Host entry for a list of FactorGraphs: pad to the largest bucket,
    solve each, write back. Returns a list of PGOResults."""
    n_cap = max(fg.node_capacity for fg in fgs)
    e_cap = max(fg.edge_capacity for fg in fgs)
    gs = [fg.to_arrays(min_node_capacity=n_cap, min_edge_capacity=e_cap,
                       device=device) for fg in fgs]
    out = gnc_optimize_batch(gs, cfg)
    for fg, r in zip(fgs, out):
        fg.update_estimates(r.R, r.t)
    return out


def optimize(fg: FactorGraph, cfg: PGOConfig = PGOConfig(),
             device: DeviceLike = None) -> PGOResult:
    """Host entry: arrays on `device` (None = the CUDA card), the solve,
    write-back of estimates. Chordal initialization runs first, on its
    own, as in the reference."""
    with span("pgo_arrays", n_factors=fg.num_factors):
        g = fg.to_arrays(device=device)
    if cfg.use_chordal_init:
        from cslam_tpu_torch.backend.initialization import chordal_initialize
        R0, t0 = chordal_initialize(g)
        g = g._replace(R=R0, t=t0)
        cfg = cfg._replace(use_chordal_init=False)
    result = gnc_optimize(g, cfg)
    fg.update_estimates(result.R, result.t)
    return result
