"""Point-set alignment: weighted Kabsch, robust ICP, voxel grid.

Port of cslam_tpu/ops/registration.py. The visual half: the weighted
Kabsch/Umeyama fit through Horn's quaternion method (`horn_rotation`:
the top eigenvector of a 4x4 symmetric matrix by ten fixed squarings,
no SVD) and the Gauss-Newton covariance of an SE(3) point-registration
estimate; these take leading batch dimensions, so the RANSAC stages fit
all hypotheses in one call. The lidar half (the Swarm-SLAM reference's
TEASER++ + ICP registration, lidar_pr/icp_utils.py):

- `nearest_neighbors`: one (N, M) squared-distance matrix in the
  expanded form |s|^2 + |d|^2 - 2 s.d (one GEMM with the norms as its
  addend), the first minimum of each row;
- `gnc_icp`: point-to-point ICP with truncated-least-squares weights
  under a graduated non-convexity schedule (10 levels of at most
  `iters_per_level` iterations, mu from 0.05 times 1.4 per level, then a
  final pass of at most `max_iters`). The reference's
  `lax.while_loop`s are host loops with the same exit test
  (it < cap and step > step_tol), so each iteration reads its step size
  back from the device: one host sync per iteration, counted in
  `RegistrationResult.iterations`;
- `voxel_downsample`: the centroid of each occupied voxel, in the
  reference's layout (points sorted by voxel key, the centroid repeated
  over its voxel, `keep` on each voxel's first point). The per-voxel
  sums run over sorted, contiguous segments, one point after the other
  (`torch.segment_reduce`, no atomics), so two runs on the card give
  the same bits, and the CPU gives the reference's.

f32 throughout, as the reference.
"""

from typing import NamedTuple

import numpy as np
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


class RegistrationResult(NamedTuple):
    R: torch.Tensor         # (3, 3)
    t: torch.Tensor         # (3,)
    rmse: torch.Tensor      # inlier RMSE
    inlier_frac: torch.Tensor
    success: torch.Tensor   # bool
    cov_diag: torch.Tensor  # (6,) [omega, v] estimate covariance diagonal
    iterations: int         # ICP iterations run (one host sync each)


def squared_norms(x):
    """(N,) squared L2 norms of the rows of (N, D) x, rounded as the
    reference's compiled sum(x * x, axis=1) on the CPU: up to 32 columns,
    one fused multiply-add after the other; 33-64 columns, the rounded
    squares summed in two sequential halves, then the halves added. The
    multiply-adds are exact f64 products and sums rounded to f32 (this
    double rounding can differ from a true FMA only when the f64 sum
    falls exactly on an f32 rounding boundary). Distance matrices built
    on these norms then equal the reference's bit for bit on the CPU,
    so near-equal neighbours keep the reference's order."""
    n = x.shape[1]
    if n > 64:
        raise ValueError(f"squared_norms takes at most 64 columns, got {n}")
    if n > 32:
        sq = x * x
        half = -(-n // 2)
        parts = []
        for lo, hi in ((0, half), (half, n)):
            acc = sq[:, lo]
            for j in range(lo + 1, hi):
                acc = acc + sq[:, j]
            parts.append(acc)
        return parts[0] + parts[1]
    acc = x[:, 0] * x[:, 0]
    xd = x.to(torch.float64)
    for j in range(1, n):
        acc = (xd[:, j] * xd[:, j] + acc.to(torch.float64)).to(torch.float32)
    return acc


def squared_distances(a, b, b_mask=None):
    """(N, M) |a_i|^2 + |b_j|^2 - 2 a_i.b_j: the norms' sum is the
    addend of one GEMM. Columns where b_mask is 0 are +inf."""
    b2 = squared_norms(b)
    if b_mask is not None:
        # inf - 2 a.b = inf, as the reference's where() after the sum
        b2 = torch.where(b_mask > 0, b2, torch.full_like(b2, torch.inf))
    d2 = squared_norms(a)[:, None] + b2[None, :]
    return d2.addmm_(a, b.T, alpha=-2.0)


def nearest_neighbors(src, src_mask, dst, dst_mask):
    """(idx, d2): for each of the (N, 3) src points the index of its
    nearest valid dst point (the first among equals) and the squared
    distance, clamped at 0 (the expanded form can cancel below it for
    an exact match); masked src rows get d2 = inf."""
    best, idx = torch.min(squared_distances(src, dst, dst_mask), dim=1)
    best = torch.clamp(best, min=0.0)
    best = torch.where(src_mask > 0, best, torch.full_like(best, torch.inf))
    return idx, best


def _tls_weights(r_sq, mu, c_sq):
    """Truncated-least-squares GNC weights at level mu (the reference's
    f32 scalar arithmetic, then one division per element)."""
    one = np.float32(1.0)
    ub = (mu + one) / mu * c_sq
    lb = mu / (mu + one) * c_sq
    num = torch.full_like(r_sq, float(c_sq * mu * (mu + one)))
    mid = torch.sqrt(num / torch.clamp(r_sq, min=1e-12)) - float(mu)
    return torch.where(r_sq >= float(ub), torch.zeros_like(r_sq),
                       torch.where(r_sq <= float(lb), torch.ones_like(r_sq),
                                   torch.clamp(mid, 0.0, 1.0)))


def gnc_icp(src, src_mask, dst, dst_mask, R_init, t_init,
            max_corr_dist=1.0, max_iters=30, gnc_steps=10,
            fitness_threshold=0.3, step_tol=1e-4, iters_per_level=5):
    """Robust point-to-point ICP.

    src, dst: (N, 3) / (M, 3) padded clouds with (N,), (M,) masks;
    R_init, t_init: the initial guess; max_corr_dist: the TLS inlier
    scale c (meters); iters_per_level: the iteration cap of each GNC
    level (small on purpose: at soft mu the weights oscillate, and the
    next level refines); max_iters: the cap of the final pass at the
    hardest mu; step_tol: the exit threshold on ||dR||_F + ||dt||.

    Returns RegistrationResult; success = inlier fraction above
    fitness_threshold."""
    f32 = np.float32
    c_sq = f32(max_corr_dist) * f32(max_corr_dist)
    tol = float(f32(step_tol))
    iterations = 0

    def icp_at(mu, R, t, iter_cap):
        nonlocal iterations
        delta, it = np.inf, 0
        while it < iter_cap and delta > tol:
            moved = src @ R.T + t
            idx, d2 = nearest_neighbors(moved, src_mask, dst, dst_mask)
            w = _tls_weights(d2, mu, c_sq) * src_mask
            w = torch.where(torch.isfinite(d2), w, torch.zeros_like(w))
            Rn, tn = weighted_kabsch(src, dst[idx], w)
            step = torch.sqrt(torch.sum((Rn - R) ** 2)) + \
                torch.linalg.vector_norm(tn - t)
            R, t, it = Rn, tn, it + 1
            delta = step.item()
        iterations += it
        return R, t

    # mu small = soft (near-convex), growing toward hard TLS
    R, t, mu = R_init, t_init, f32(0.05)
    for _ in range(gnc_steps):
        R, t = icp_at(mu, R, t, iters_per_level)
        mu = f32(mu * f32(1.4))
    # final refinement at the hardest mu, run to convergence
    R, t = icp_at(mu, R, t, max_iters)

    moved = src @ R.T + t
    _, d2 = nearest_neighbors(moved, src_mask, dst, dst_mask)
    inlier = (d2 < float(c_sq)) & (src_mask > 0) & torch.isfinite(d2)
    n_src = torch.clamp(torch.sum(src_mask), min=1.0)
    inlier_frac = torch.sum(inlier) / n_src
    n_in = torch.clamp(torch.sum(inlier), min=1).to(torch.float32)
    rmse = torch.sqrt(torch.sum(torch.where(inlier, d2, torch.zeros_like(
        d2))) / n_in)
    cov_diag = se3_estimate_covariance(moved, inlier.to(torch.float32),
                                       rmse * rmse)
    return RegistrationResult(
        R=R, t=t, rmse=rmse, inlier_frac=inlier_frac,
        success=inlier_frac > float(f32(fitness_threshold)),
        cov_diag=cov_diag, iterations=iterations)


def yaw_rotation(yaw_rad):
    """(3, 3) rotation about z by the 0-d tensor yaw_rad."""
    c, s = torch.cos(yaw_rad), torch.sin(yaw_rad)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero]),
                        torch.stack([s, c, zero]),
                        torch.stack([zero, zero, one])])


# points farther than this from the sensor on any axis are dropped
ORIGIN_RANGE = 100.0


def voxel_downsample(points, mask, voxel_size: float):
    """Deterministic voxel-grid downsample (centroid per voxel) at a
    static shape.

    Returns (centroids, keep): (N, 3) points sorted by voxel key, each
    replaced by its voxel's centroid, and an (N,) f32 mask on each
    voxel's first point; points outside +-ORIGIN_RANGE and masked ones
    sort last and are never kept."""
    n = points.shape[0]
    vs = float(np.float32(voxel_size))
    vox = torch.floor((points + ORIGIN_RANGE) / torch.full_like(
        points, vs)).to(torch.int32)
    cells = int(np.ceil(np.float32(2 * ORIGIN_RANGE) / np.float32(vs)))
    in_range = torch.all((vox >= 0) & (vox < cells), dim=1)
    valid = (mask > 0) & in_range
    # the reference's lexicographic sort on (vox_x, vox_y * cells +
    # vox_z) as one stable sort on that pair packed into 64 bits;
    # invalid points carry the largest key
    sentinel = torch.iinfo(torch.int32).max
    k_hi = torch.where(valid, vox[:, 0], torch.full_like(vox[:, 0],
                                                         sentinel))
    k_lo = torch.where(valid, vox[:, 1] * cells + vox[:, 2],
                       torch.full_like(vox[:, 0], sentinel))
    key = (k_hi.to(torch.int64) << 32) | k_lo.to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    seg_id = torch.cumsum(first, dim=0) - 1
    w = (key_s != (sentinel << 32 | sentinel)).to(torch.float32)
    lengths = torch.bincount(seg_id, minlength=n)
    sums = torch.segment_reduce(points[order] * w[:, None], "sum",
                                lengths=lengths, axis=0)
    counts = torch.segment_reduce(w, "sum", lengths=lengths)
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    keep = first & (w > 0)
    return centroids[seg_id], keep.to(torch.float32)
