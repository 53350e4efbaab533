"""Point-set alignment for visual verification.

Port of the RGB-D part of cslam_tpu/ops/registration.py: the weighted
Kabsch/Umeyama fit through Horn's quaternion method
(`horn_rotation`: the top eigenvector of a 4x4 symmetric matrix by ten
fixed squarings, no SVD) and the Gauss-Newton covariance of an SE(3)
point-registration estimate. Every function takes leading batch
dimensions, so the RANSAC stages fit all hypotheses in one call.

The lidar half of the reference module (`RegistrationResult`, GNC-TLS
ICP, nearest neighbours, voxel downsampling, the yaw seed) comes with
the lidar slice.
"""

import torch

from cslam_tpu_torch.ops.batched_linalg import batched_inv_small


def se3_estimate_covariance(moved, w, sigma_sq):
    """Gauss-Newton covariance diagonal of an SE(3) point-registration
    estimate: sigma^2 (J^T W J + 1e-4 I)^-1 with J_i = [-[a_i]_x | I_3]
    for the moved source points a_i (left-perturbation tangent
    [omega, v]).

    moved: (..., N, 3); w: (..., N); sigma_sq: (...). Returns (..., 6).
    """
    a = moved
    zeros = torch.zeros_like(a[..., 0])
    A = torch.stack([
        torch.stack([zeros, -a[..., 2], a[..., 1]], dim=-1),
        torch.stack([a[..., 2], zeros, -a[..., 0]], dim=-1),
        torch.stack([-a[..., 1], a[..., 0], zeros], dim=-1),
    ], dim=-2)                                     # (..., N, 3, 3)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(A.shape)
    J = torch.cat([-A, eye], dim=-1)               # (..., N, 3, 6)
    H = torch.einsum("...nij,...nik,...n->...jk", J, J, w)
    H = H + 1e-4 * torch.eye(6, dtype=a.dtype, device=a.device)
    cov = torch.clamp(sigma_sq, min=1e-8)[..., None, None] * \
        batched_inv_small(H)
    return torch.diagonal(cov, dim1=-2, dim2=-1)


def horn_rotation(cov):
    """Proper rotation maximizing tr(R^T cov) for (..., 3, 3) cov =
    sum w xd xs^T: Horn's quaternion matrix N, B = N / |N|_F + I squared
    ten times (renormalized each time); the largest column of B^1024 is
    the top eigenvector, i.e. the quaternion."""
    S = torch.swapaxes(cov, -1, -2)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N4 = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    scale = torch.clamp(torch.linalg.vector_norm(N4, dim=(-2, -1)),
                        min=1e-12)
    Bk = N4 / scale[..., None, None] + torch.eye(4, dtype=N4.dtype,
                                                 device=N4.device)
    for _ in range(10):
        Bk = Bk @ Bk
        Bk = Bk / torch.clamp(torch.linalg.vector_norm(Bk, dim=(-2, -1)),
                              min=1e-30)[..., None, None]
    col = torch.argmax(torch.sum(Bk * Bk, dim=-2), dim=-1)
    q = torch.take_along_dim(
        Bk, col[..., None, None].expand(*Bk.shape[:-1], 1), dim=-1)[..., 0]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def weighted_kabsch(src, dst, w):
    """Best-fit (R, t) minimizing sum w_i ||R src_i + t - dst_i||^2.

    src, dst: (..., N, 3); w: (..., N). Returns (..., 3, 3), (..., 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    cov = torch.swapaxes(xd * w[..., None], -1, -2) @ xs / wsum[..., None]
    R = horn_rotation(cov)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t
