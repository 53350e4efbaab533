"""Batched tiny-matrix linear algebra as unrolled elementwise arithmetic.

Port of cslam_tpu/ops/batched_linalg.py, operation for operation, so the
numerics match the reference: Gauss-Jordan without pivoting for SPD
(+lam*I) blocks, the closed-form 3x3 adjugate inverse and determinant,
the scaled Newton polar iteration for rotations, and the squaring
extraction of a 3x3 smallest eigenvector.
"""

import torch


def inv3x3_adjugate(M, eps=1e-30):
    """Closed-form inverse of (..., 3, 3) batches via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > eps, det,
                                torch.full_like(det, eps))
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def det3x3(M):
    """Determinant of (..., 3, 3) batches, closed form."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return (a * (e * i - f * h) - b * (d * i - f * g)
            + c * (d * h - e * g))


def polar_rotation3x3(M, iters=8):
    """Rotation near (..., 3, 3) M by determinant-scaled Newton polar
    iteration X <- (X + X^-T)/2 (sign-flipped first when det(M) < 0)."""
    sign = torch.sign(det3x3(M))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    X = M * sign[..., None, None]
    norm = torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True))
    X = X * (3.0 ** 0.5 / torch.clamp(norm, min=1e-12))
    for _ in range(iters):
        mu = torch.abs(det3x3(X)) ** (-1.0 / 3.0)
        mu = torch.clamp(mu, 0.1, 10.0)[..., None, None]
        Xs = X * mu
        X = 0.5 * (Xs + torch.swapaxes(inv3x3_adjugate(Xs), -2, -1))
    return X


def smallest_eigvec_sym3x3(M, squarings=10):
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    (..., 3, 3) batches, by squaring tr(M) I - M."""
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    B = tr[..., None, None] * eye - M
    norm = torch.sqrt(torch.sum(B * B, dim=(-2, -1), keepdim=True))
    B = B / torch.clamp(norm, min=1e-30)
    B = B + 0.1 * eye
    for _ in range(squarings):
        B = B @ B
        n2 = torch.sqrt(torch.sum(B * B, dim=(-2, -1), keepdim=True))
        B = B / torch.clamp(n2, min=1e-30)
    colnorm = torch.sum(B * B, dim=-2)
    onehot = (colnorm >= torch.amax(colnorm, dim=-1, keepdim=True)).to(M.dtype)
    first = torch.cumsum(onehot, dim=-1) <= 1.0
    onehot = onehot * first.to(M.dtype)
    v = torch.einsum("...ij,...j->...i", B, onehot)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def batched_inv_small(H, eps=1e-30):
    """Inverse of a (..., n, n) batch of small matrices: Gauss-Jordan
    without pivoting, unrolled over the static n (SPD-shifted blocks)."""
    n = H.shape[-1]
    A = H
    Inv = torch.eye(n, dtype=H.dtype, device=H.device).expand(H.shape)
    rows = torch.arange(n, device=H.device)
    for i in range(n):
        piv = A[..., i:i + 1, i:i + 1]
        inv_piv = 1.0 / torch.where(torch.abs(piv) > eps, piv,
                                    torch.full_like(piv, eps))
        row_a = A[..., i:i + 1, :] * inv_piv
        row_inv = Inv[..., i:i + 1, :] * inv_piv
        col = A[..., :, i:i + 1]
        is_i = (rows == i)[:, None]
        A = torch.where(is_i, row_a, A - col * row_a)
        Inv = torch.where(is_i, row_inv, Inv - col * row_inv)
    return Inv
