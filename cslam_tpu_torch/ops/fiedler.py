"""Fiedler pair (algebraic connectivity + eigenvector).

Port of cslam_tpu/ops/fiedler.py:
- `fiedler_pair_inverse`: matrix-free inverse iteration with a
  chain-exact (cyclic-reduction) preconditioned CG — the map-scale path;
- `fiedler_pair_dense`: full `eigh` of the padding-augmented Laplacian;
- `fiedler_pair_lobpcg`: matrix-free LOBPCG (ops/lobpcg.py, the port of
  JAX's `lobpcg_standard`) on a spectrum-flipped operator.

The reference's `lax.while_loop`s are Python loops whose conditions are
read on the host, with the same conditions and caps (iteration counts
are part of parity). `fiedler_pair_inverse` also takes a leading batch
axis on `weights`/`v0`: each member then runs its own gated loops, as
the reference's vmap over the same function does (a member whose gate
closed keeps its state while the others step).

Every gate decision reads a dot product; the reference computes them at
HIGHEST precision, so matrix products here must be full fp32 (no TF32).
"""

import torch

from cslam_tpu_torch.device import require_full_fp32
from cslam_tpu_torch.ops.block_tridiag import bcr_factor, bcr_solve
from cslam_tpu_torch.ops.laplacian import degree_vector, laplacian_matvec
from cslam_tpu_torch.utils import jax_random


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _where(mask, new, old):
    """Per-member select: mask (Bt,) against (Bt, ...) values."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def fiedler_pair_inverse(e_i, e_j, weights, node_mask, v0=None,
                         invit_iters=12, cg_iters=24, eps=1e-6,
                         invit_tol=1e-6, cg_tol=1e-8, return_iters=False):
    """Matrix-free Fiedler pair by inverse iteration x <- L^+ x, each
    solve a CG preconditioned by an exact tridiagonal solve of the
    Laplacian's chain part; lambda_2 from the quadratic form
    sum_e w_e (x_i - x_j)^2 / |x|^2.

    Both loops are tolerance-gated with caps: CG stops at relative
    squared residual < cg_tol, inverse iteration once successive
    iterates align to |<x_k, x_{k-1}>| > 1 - invit_tol (after a floor
    of 2 iterations).

    weights: (E,) or (Bt, E); v0: None, (P,) or (Bt, P). Returns
    (lambda_2, v) — scalar and (P,), or (Bt,) and (Bt, P) when batched —
    plus (invit_taken, cg_taken_total) when return_iters.
    """
    require_full_fp32(weights.device)
    batched = weights.dim() == 2
    w = weights.float() if batched else weights.float()[None]
    Bt = w.shape[0]
    dev = w.device
    P = node_mask.shape[0]
    mask = node_mask.float()
    n_real = torch.clamp(torch.sum(mask), min=1.0)
    ones = mask / torch.sqrt(n_real)
    ei, ej = e_i.to(torch.int64), e_j.to(torch.int64)

    def project(x):
        return (x - ones * _dot(ones, x)[..., None]) * mask

    def lap(x):
        return laplacian_matvec(ei, ej, w, x) + eps * x

    deg = degree_vector(ei, ej, w, P)
    D = (deg + eps)[..., None, None]
    zero = torch.zeros((), device=dev)
    O = torch.zeros((Bt, P), device=dev)
    O.index_add_(1, ej, torch.where(ej == ei + 1, -w, zero))
    O.index_add_(1, ei, torch.where(ei == ej + 1, -w, zero))
    O[:, 0] = 0.0
    fac = bcr_factor(D, O[..., None, None])

    def minv(r):
        return project(bcr_solve(fac, r[..., None])[..., 0])

    def cg_solve(b):
        b = project(b)
        bb = torch.clamp(_dot(b, b), min=1e-30)
        x = torch.zeros_like(b)
        r = b
        z = minv(r)
        p = z
        rz = _dot(r, z)
        it = torch.zeros(Bt, dtype=torch.int32, device=dev)
        while True:
            active = (it < cg_iters) & (_dot(r, r) > cg_tol * bb)
            if not bool(active.any()):
                break
            Ap = project(lap(p))
            pAp = _dot(p, Ap)
            # freeze once converged: past machine precision alpha/beta
            # overflow and a body that keeps stepping turns into NaN
            ok = (rz > 1e-25) & (pAp > 1e-30) & torch.isfinite(pAp)
            alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-30), zero)
            x_n = x + alpha[:, None] * p
            r_n = _where(ok, r - alpha[:, None] * Ap, r)
            z = minv(r_n)
            rz_new = _dot(r_n, z)
            beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), zero)
            p_n = z + beta[:, None] * p
            rz_n = torch.where(ok, rz_new, rz)
            x = _where(active, x_n, x)
            r = _where(active, r_n, r)
            p = _where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            it = it + active.to(torch.int32)
        return x, it

    if v0 is None:
        v0 = torch.from_numpy(jax_random.normal(13, (P,))).to(dev)
    x = project(v0.float().expand(Bt, P))
    x = x / torch.clamp(torch.sqrt(_dot(x, x)), min=1e-30)[:, None]
    it = torch.zeros(Bt, dtype=torch.int32, device=dev)
    align = torch.zeros(Bt, device=dev)
    cg_total = torch.zeros(Bt, dtype=torch.int32, device=dev)
    while True:
        active = (it < invit_iters) & ((it < 2) | (align < 1.0 - invit_tol))
        if not bool(active.any()):
            break
        y, cg_it = cg_solve(x)
        y = project(y)
        y = y / torch.clamp(torch.sqrt(_dot(y, y)), min=1e-30)[:, None]
        align_n = torch.abs(_dot(y, x))
        x = _where(active, y, x)
        align = torch.where(active, align_n, align)
        cg_total = cg_total + torch.where(active, cg_it, 0)
        it = it + active.to(torch.int32)
    dx = x[..., ei] - x[..., ej]
    lam2 = torch.sum(w * dx * dx, dim=-1) / torch.clamp(_dot(x, x),
                                                        min=1e-30)
    if not batched:
        lam2, x, it, cg_total = lam2[0], x[0], it[0], cg_total[0]
    if return_iters:
        return lam2, x, it, cg_total
    return lam2, x


def _augment(L, node_mask):
    """Add BIG to padded diagonal entries; returns (L_aug, BIG)."""
    big = 2.0 * torch.trace(L) + 1.0
    pad = (1.0 - node_mask) * big
    return L + torch.diag(pad), big


def fiedler_pair_dense(L, node_mask):
    """(lambda_2, v_2) of the Laplacian restricted to node_mask == 1."""
    L_aug, _ = _augment(L, node_mask)
    vals, vecs = torch.linalg.eigh(L_aug)
    return vals[1], vecs[:, 1]


def fiedler_pair_lobpcg(e_i, e_j, weights, node_mask, num_iters=100,
                        block_size=4, X0=None, return_block=False):
    """Matrix-free Fiedler pair via LOBPCG on B = sigma*I_real - L with
    the constant vector deflated analytically."""
    from cslam_tpu_torch.ops.lobpcg import lobpcg_standard

    require_full_fp32(weights.device)
    dev = weights.device
    P = node_mask.shape[0]
    mask = node_mask.float()
    w = weights.float()
    n_real = torch.clamp(torch.sum(mask), min=1.0)
    degs = degree_vector(e_i, e_j, w, P)
    sigma = 2.0 * torch.max(degs) + 1.0
    ones = mask / torch.sqrt(n_real)

    def matvec(X):
        X = X - ones[:, None] * (ones @ X)[None, :]
        LX = laplacian_matvec(e_i, e_j, w, X.T).T
        BX = sigma * X * mask[:, None] - LX
        return BX - ones[:, None] * (ones @ BX)[None, :]

    if X0 is None:
        X0 = torch.from_numpy(jax_random.normal(7, (P, block_size))).to(dev)
    X0 = X0 * mask[:, None]
    X0 = X0 - ones[:, None] * (ones @ X0)[None, :]
    theta, U, _ = lobpcg_standard(matvec, X0, m=num_iters)
    lam2 = sigma - theta[0]
    if return_block:
        return lam2, U[:, 0], U
    return lam2, U[:, 0]
