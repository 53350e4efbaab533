"""Exact block-tridiagonal solves by cyclic reduction — the chain
preconditioner of the Fiedler inverse iteration, chordal init and PGO.

Port of cslam_tpu/ops/block_tridiag.py. System M x = b with n
(power-of-two) blocks of size s; D: (..., n, s, s) diagonal blocks;
O: (..., n, s, s) with O[j] = M[j, j-1] (O[0] must be zero). Each level
eliminates the odd blocks with batched Gauss-Jordan inverses; below
_DENSE_TAIL_BLOCKS blocks the rest is one dense Cholesky whose explicit
inverse is kept. Leading batch axes are allowed throughout (MAC solves
a batch of swapped selections at once).
"""

import torch

from cslam_tpu_torch.ops.batched_linalg import batched_inv_small

_DENSE_TAIL_BLOCKS = 64


def _shift_down(x, axis):
    """x shifted one step along `axis` (zero first entry)."""
    first = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([first, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)


def _shift_up(x, axis):
    """x shifted one step back along `axis` (zero last entry)."""
    last = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([x.narrow(axis, 1, x.shape[axis] - 1), last], dim=axis)


def cholesky_or_nan(A):
    """Lower Cholesky factor; NaN (no exception) where A is not positive
    definite, as the reference's factorization behaves."""
    chol, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def bcr_factor(D, O):
    """Factor the block-tridiagonal system for repeated solves."""
    n, s = D.shape[-3], D.shape[-1]
    if n & (n - 1):
        raise ValueError("block count must be a power of two")
    levels = []
    while n > _DENSE_TAIL_BLOCKS:
        D_even, D_odd = D[..., 0::2, :, :], D[..., 1::2, :, :]
        O_even, O_odd = O[..., 0::2, :, :], O[..., 1::2, :, :]
        Dinv_odd = batched_inv_small(D_odd)
        L = O_even @ _shift_down(Dinv_odd, -3)
        R = O_odd.transpose(-2, -1) @ Dinv_odd
        D_new = D_even - L @ O_even.transpose(-2, -1) - R @ O_odd
        O_new = -(L @ _shift_down(O_odd, -3))
        O_new[..., 0, :, :] = 0.0
        levels.append({"Dinv_odd": Dinv_odd, "O_even": O_even,
                       "O_odd": O_odd, "L": L, "R": R})
        D, O = D_new, O_new
        n //= 2
    batch = D.shape[:-3]
    tail = torch.zeros(batch + (n, n, s, s), dtype=D.dtype, device=D.device)
    idx = torch.arange(n, device=D.device)
    tail[..., idx, idx, :, :] = D
    if n > 1:
        tail[..., idx[1:], idx[:-1], :, :] = O[..., 1:, :, :]
        tail[..., idx[:-1], idx[1:], :, :] = O[..., 1:, :, :].transpose(-2, -1)
    dense = tail.transpose(-3, -2).reshape(batch + (n * s, n * s))
    chol = cholesky_or_nan(dense)
    eye = torch.eye(n * s, dtype=D.dtype, device=D.device).expand(dense.shape)
    inv = torch.cholesky_solve(eye, chol)
    return {"levels": levels, "tail_inv": inv, "tail_n": n, "s": s}


def _bmv(A, x):
    return (A @ x[..., None])[..., 0]


def bcr_solve(factor, b):
    """Solve M x = b using a factor from bcr_factor. b: (..., n, s)."""
    s = factor["s"]
    rhs_stack = []
    for lv in factor["levels"]:
        b_even, b_odd = b[..., 0::2, :], b[..., 1::2, :]
        b = (b_even - _bmv(lv["L"], _shift_down(b_odd, -2))
             - _bmv(lv["R"], b_odd))
        rhs_stack.append(b_odd)
    n_tail = factor["tail_n"]
    lead = b.shape[:-2]
    x = (factor["tail_inv"] @ b.reshape(lead + (n_tail * s, 1))).reshape(
        lead + (n_tail, s))
    for lv, b_odd in zip(reversed(factor["levels"]), reversed(rhs_stack)):
        rhs_odd = (b_odd - _bmv(lv["O_odd"], x)
                   - _bmv(_shift_up(lv["O_even"], -3).transpose(-2, -1),
                          _shift_up(x, -2)))
        x_odd = _bmv(lv["Dinv_odd"], rhs_odd)
        x = torch.stack([x, x_odd], dim=-2).reshape(
            x.shape[:-2] + (2 * x.shape[-2], s))
    return x


def bcr_solve_multi(factor, b):
    """Solve M x = b for m right-hand sides at once. b: (n, m, s)."""
    return bcr_solve(factor, b.transpose(0, 1)).transpose(0, 1)


def chain_offdiag_from_edges(e_i, e_j, Ji, Jj, P: int):
    """(P, s, s) sub-diagonal blocks O[m] = H[m, m-1] from the CHAIN
    edges (|e_i - e_j| == 1) of a stacked edge list; O[0] = 0. Ji/Jj
    already carry the sqrt(weight)*mask scaling."""
    s = Ji.shape[-1]
    ei, ej = e_i.to(torch.int64), e_j.to(torch.int64)
    fwd = (ej == ei + 1)[:, None]
    rev = (ei == ej + 1)[:, None]
    cross_ji = (Jj.transpose(-2, -1) @ Ji).reshape(-1, s * s)
    cross_ij = (Ji.transpose(-2, -1) @ Jj).reshape(-1, s * s)
    O = torch.zeros((P, s * s), dtype=Ji.dtype, device=Ji.device)
    O.index_add_(0, ej, torch.where(fwd, cross_ji, torch.zeros_like(cross_ji)))
    O.index_add_(0, ei, torch.where(rev, cross_ij, torch.zeros_like(cross_ij)))
    O = O.reshape(P, s, s).clone()
    O[0] = 0.0
    return O
