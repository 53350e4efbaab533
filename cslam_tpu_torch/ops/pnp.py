"""Batched 2D-3D (PnP) RANSAC — verification without query-side depth.

Port of cslam_tpu/ops/pnp.py. P3P through the Grunert depth-ratio
system: for a 3-correspondence sample g(v) is evaluated on a fixed
log-spaced v grid for both u-branches, up to four sign-change cells per
branch are refined by 24 fixed bisection steps, and each recovered
depth triple gives a pose by weighted Kabsch. All candidate poses
(hypotheses x 2 branches x 4 root slots) are scored at once on
normalized-reprojection consensus with a cheirality gate; the winner is
polished by 8 Gauss-Newton steps on its inliers. The Jacobians the
reference takes with `jax.jacfwd` are written out here: at xi = 0 the
point X = R (dR p + dt) + t moves by R [-[p]_x | I] xi, and the
projection's derivative follows (zero in z where the depth is clamped).
The 6x6 solves use the unrolled Gauss-Jordan inverse.

The bisection and the polish are host loops of small launches; every
function takes leading batch dimensions so one loop serves all
hypotheses and all targets.
"""

import numpy as np
import torch

from cslam_tpu_torch.ops import se3
from cslam_tpu_torch.ops.batched_linalg import batched_inv_small
from cslam_tpu_torch.ops.features import top_k
from cslam_tpu_torch.ops.matching2d import (RansacResult, _gather_rows,
                                            _unbatch, batch_seeds,
                                            draw_samples, mutual_match)
from cslam_tpu_torch.ops.registration import weighted_kabsch

_V_GRID = 128
_BISECT_ITERS = 24
_ROOT_SLOTS = 4  # a quartic has <= 4 real roots across both branches
_POLISH_ITERS = 8
# the reference's v grid, jnp.logspace(log10(1/8), log10(8), 129) in
# float32, as its bits (XLA's pow differs from torch's in the last place
# on about a third of the points)
_V_GRID_BITS = """
3dffffff 3e043a29 3e08980f 3e0d1ade 3e11c3d3 3e16942d 3e1b8d3a 3e20b052
3e25fed5 3e2b7a38 3e3123f5 3e36fd92 3e3d08a4 3e4346ce 3e49b9bc 3e506333
3e5744fc 3e5e60f5 3e65b908 3e6d4f2e 3e75257c 3e7d3e0b 3e82cd87 3e871f62
3e8b95c3 3e9031db 3e94f4ef 3e99e046 3e9ef533 3ea43516 3ea9a15a 3eaf3b78
3eb504f3 3ebaff5b 3ec12c4d 3ec78d74 3ece248b 3ed4f35a 3edbfbb8 3ee33f8a
3eeac0c6 3ef28177 3efa83b2 3f0164d2 3f05aac4 3f0a14d6 3f0ea439 3f135a2b
3f1837f0 3f1d3eda 3f227043 3f27cd93 3f2d583e 3f3311c4 3f38fbb0 3f3f179a
3f45672b 3f4bec14 3f52a81d 3f599d16 3f60ccdf 3f68396a 3f6fe4ba 3f77d0df
3f800000 3f843a29 3f88980e 3f8d1adf 3f91c3d3 3f96942d 3f9b8d3a 3fa0b051
3fa5fed7 3fab7a3a 3fb123f5 3fb6fd92 3fbd08a4 3fc346cd 3fc9b9be 3fd06334
3fd744fd 3fde60f5 3fe5b907 3fed4f31 3ff5257c 3ffd3e0c 4002cd87 40071f61
400b95c2 401031dd 4014f4ef 4019e046 401ef533 40243516 4029a15b 402f3b79
403504f3 403aff5b 40412c4d 40478d75 404e248b 4054f35b 405bfbb8 40633f89
406ac0c7 40728178 407a83b3 408164d2 4085aac4 408a14d5 408ea43a 40935a2b
409837f1 409d3eda 40a27043 40a7cd94 40ad583e 40b311c4 40b8fbb0 40bf1799
40c5672a 40cbec16 40d2a81d 40d99d16 40e0cce0 40e8396a 40efe4bb 40f7d0df
41000000"""
V_GRID = np.array([int(w, 16) for w in _V_GRID_BITS.split()],
                  np.uint32).view(np.float32)


def _grunert_residual(v, cos_ab, cos_ac, cos_bc, a2, b2, c2, branch):
    """g(v) for one u-branch; returns (g, valid, u).

    Depths s1, s2 = u s1, s3 = v s1; Q(v) = 1 + v^2 - 2 v cos_ac,
    u = cos_ab +- sqrt(cos_ab^2 - 1 + c2 Q / b2),
    g(v) = u^2 + v^2 - 2 u v cos_bc - a2 Q / b2."""
    Q = 1.0 + v * v - 2.0 * v * cos_ac
    b2c = torch.clamp(b2, min=1e-12)
    Cv = c2 * Q / b2c
    disc = cos_ab * cos_ab - 1.0 + Cv
    valid = (disc >= 0.0) & (Q > 1e-9)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = cos_ab + branch * sq
    valid = valid & (u > 1e-6)
    g = u * u + v * v - 2.0 * u * v * cos_bc - a2 * Q / b2c
    return g, valid, u


def _p3p_poses(W, f):
    """All P3P candidate poses of 3-correspondence samples.

    W: (..., 3, 3) world points (frame a); f: (..., 3, 3) unit rays
    (frame b). Returns R (..., 8, 3, 3), t (..., 8, 3) and a (..., 8)
    validity mask (slot = branch * 4 + root)."""
    c2 = torch.sum((W[..., 0, :] - W[..., 1, :]) ** 2, dim=-1)
    b2 = torch.sum((W[..., 0, :] - W[..., 2, :]) ** 2, dim=-1)
    a2 = torch.sum((W[..., 1, :] - W[..., 2, :]) ** 2, dim=-1)
    cos_ab = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)
    cos_ac = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)
    cos_bc = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)
    dev = W.device
    vgrid = torch.from_numpy(V_GRID).to(dev)
    # (..., 2 branches, 1) coefficients against the grid / root slots
    branch = torch.tensor([1.0, -1.0], device=dev)[:, None]
    co = [x[..., None, None] for x in (cos_ab, cos_ac, cos_bc, a2, b2, c2)]
    g, valid, _ = _grunert_residual(vgrid, *co, branch)
    change = (torch.sign(g[..., :-1]) * torch.sign(g[..., 1:]) < 0.0) & \
        valid[..., :-1] & valid[..., 1:]
    rank = 2.0 - torch.arange(_V_GRID, device=dev) / _V_GRID
    score = torch.where(change, 1.0, 0.0) * rank
    _, cells = top_k(score, _ROOT_SLOTS)
    slot_ok = torch.gather(change, -1, cells)
    lo = vgrid[cells]
    hi = vgrid[cells + 1]
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        g_lo, _, _ = _grunert_residual(lo, *co, branch)
        g_mid, _, _ = _grunert_residual(mid, *co, branch)
        same = torch.sign(g_mid) == torch.sign(g_lo)
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    v = 0.5 * (lo + hi)
    _, v_ok, u = _grunert_residual(v, *co, branch)
    Q = 1.0 + v * v - 2.0 * v * co[1]
    s1 = torch.sqrt(torch.clamp(co[4], min=1e-12) /
                    torch.clamp(Q, min=1e-9))
    oks = (slot_ok & v_ok).flatten(-2)                   # (..., 8)
    depths = torch.stack([s1, u * s1, v * s1], dim=-1).flatten(-3, -2)
    X = depths[..., :, :, None] * f[..., None, :, :]     # (..., 8, 3, 3)
    Wb = W[..., None, :, :].expand(X.shape)
    R, t = weighted_kabsch(Wb, X, torch.ones(X.shape[:-1], device=dev))
    return R, t, oks


def _reproject_residuals(R, t, pts3d, rays):
    """Normalized-plane reprojection residual per point + cheirality.
    R (..., 3, 3), t (..., 3), pts3d (..., N, 3), rays (..., N, 2)."""
    X = pts3d @ torch.swapaxes(R, -1, -2) + t[..., None, :]
    z = X[..., 2]
    front = z > 1e-6
    pred = X[..., :2] / torch.clamp(z, min=1e-6)[..., None]
    res = torch.linalg.vector_norm(pred - rays, dim=-1)
    return res, front


def _residuals_and_jacobian(R, t, pts3d, rays, weights):
    """Weighted reprojection residuals r (..., 2N), ordered x0, y0, x1,
    ..., and their Jacobian (..., 2N, 6) w.r.t. the right perturbation
    xi = [omega, v] of (R, t) at xi = 0."""
    X = pts3d @ torch.swapaxes(R, -1, -2) + t[..., None, :]
    zc = X[..., 2]
    z = torch.clamp(zc, min=1e-6)
    pred = X[..., :2] / z[..., None]
    r = ((pred - rays) * weights[..., None]).flatten(-2)
    # d pred / d X: (..., N, 2, 3); the clamped depth is a constant
    inv_z = 1.0 / z
    dz = torch.where(zc > 1e-6, -inv_z * inv_z, torch.zeros_like(z))
    zero = torch.zeros_like(z)
    dpred = torch.stack([
        torch.stack([inv_z, zero, X[..., 0] * dz], dim=-1),
        torch.stack([zero, inv_z, X[..., 1] * dz], dim=-1)], dim=-2)
    # d X / d xi = R [-[p]_x | I]: (..., N, 3, 6)
    Rn = R[..., None, :, :]
    dX = torch.cat([-(Rn @ se3.hat(pts3d)), Rn.expand(
        *pts3d.shape[:-1], 3, 3)], dim=-1)
    J = (dpred @ dX) * weights[..., None, None]
    return r, J.flatten(-3, -2)


def _gn_polish(R, t, pts3d, rays, weights, iters=_POLISH_ITERS):
    """Fixed-iteration Gauss-Newton on the weighted reprojection error
    (batched over leading dimensions)."""
    eye = torch.eye(6, device=R.device)
    for _ in range(iters):
        r, J = _residuals_and_jacobian(R, t, pts3d, rays, weights)
        Jt = torch.swapaxes(J, -1, -2)
        H = Jt @ J + 1e-8 * eye
        g = (Jt @ r[..., None])[..., 0]
        dx = -(batched_inv_small(H) @ g[..., None])[..., 0]
        dR, dt = se3.se3_exp(dx)
        R, t = se3.compose(R, t, dR, dt)
    return R, t


def _unit_rays(rays):
    f = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


def ransac_pnp_batched(pts3d, rays, valid, samples, inlier_threshold=0.01,
                       min_inliers=6):
    """PnP RANSAC over B correspondence sets at once: pts3d (B, N, 3),
    rays (B, N, 2), valid (B, N), samples (B, H, 3). Returns a
    RansacResult with leading (B,) axes."""
    B = pts3d.shape[0]
    f = _unit_rays(rays)
    Rs, ts, oks = _p3p_poses(_gather_rows(pts3d, samples),
                             _gather_rows(f, samples))
    Rs = Rs.reshape(B, -1, 3, 3)
    ts = ts.reshape(B, -1, 3)
    oks = oks.reshape(B, -1)
    X = torch.einsum("bhij,bnj->bhni", Rs, pts3d) + ts[:, :, None, :]
    z = X[..., 2]
    pred = X[..., :2] / torch.clamp(z, min=1e-6)[..., None]
    res = torch.linalg.vector_norm(pred - rays[:, None], dim=-1)
    inl = (res < inlier_threshold) & (z > 1e-6) & (valid[:, None] > 0)
    counts = torch.where(oks, torch.sum(inl, dim=-1),
                         torch.full_like(oks, -1, dtype=torch.int64))
    best = torch.argmax(counts, dim=-1)
    w_best = torch.gather(
        inl, 1, best[:, None, None].expand(-1, 1, inl.shape[-1]))[:, 0]
    R0 = torch.gather(Rs, 1, best[:, None, None, None].expand(-1, 1, 3, 3))
    t0 = torch.gather(ts, 1, best[:, None, None].expand(-1, 1, 3))
    R_ref, t_ref = _gn_polish(R0[:, 0], t0[:, 0], pts3d, rays,
                              w_best.to(torch.float32))
    res_f, front = _reproject_residuals(R_ref, t_ref, pts3d, rays)
    final = ((res_f < inlier_threshold) & front & (valid > 0)).to(
        torch.float32)
    num = torch.sum(final, dim=-1)
    sigma_sq = torch.sum(final * res_f * res_f, dim=-1) / torch.clamp(
        num, min=1.0)
    _, J = _residuals_and_jacobian(R_ref, t_ref, pts3d, rays, final)
    JtJ = torch.swapaxes(J, -1, -2) @ J + 1e-8 * torch.eye(
        6, device=J.device)
    cov = batched_inv_small(JtJ) * torch.clamp(sigma_sq,
                                               min=1e-8)[:, None, None]
    return RansacResult(R=R_ref, t=t_ref, inliers=final, num_inliers=num,
                        success=num >= min_inliers,
                        cov_diag=torch.diagonal(cov, dim1=-2, dim2=-1))


def ransac_pnp(pts3d, rays, valid, inlier_threshold=0.01, min_inliers=6,
               num_hypotheses=128, seed=0):
    """Robust absolute pose from matched 3D points and 2D rays.

    pts3d: (N, 3) landmarks in frame a; rays: (N, 2) matched normalized
    image coordinates in the query camera b (no depth); valid: (N,)
    float mask. Returns RansacResult (the pose maps frame-a points into
    the query camera frame) with the covariance diagonal of the polished
    Gauss-Newton system."""
    samples = draw_samples(valid[None], [seed], num_hypotheses)
    return _unbatch(ransac_pnp_batched(
        pts3d[None], rays[None], valid[None], samples,
        inlier_threshold=inlier_threshold, min_inliers=min_inliers))


def verify_keyframe_pairs_pnp(desc0, pts0, mask0, desc1, rays1, mask1,
                              ratio_threshold=0.9, inlier_threshold=0.01,
                              min_inliers=6, num_hypotheses=128, seed=0):
    """B of my keyframes (3D landmarks) against ONE depth-less query
    frame: desc0/pts0/mask0 (B, K, D), (B, K, 3), (B, K); desc1/rays1/
    mask1 (K, D), (K, 2), (K,). Returns (RansacResult with leading (B,)
    axes, (B,) match counts)."""
    idx1, valid = mutual_match(desc0, mask0, desc1, mask1, ratio_threshold)
    samples = draw_samples(valid, batch_seeds(seed, desc0.shape[0]),
                           num_hypotheses)
    res = ransac_pnp_batched(pts0, rays1[idx1], valid, samples,
                             inlier_threshold=inlier_threshold,
                             min_inliers=min_inliers)
    return res, torch.sum(valid, dim=-1)


def normalize_keypoints(xy, intrinsics):
    """Pixel keypoints -> normalized image coordinates (x/z, y/z) on the
    host; intrinsics: (fx, fy, cx, cy)."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    xy = np.asarray(xy, dtype=np.float32)
    return np.stack([(xy[:, 0] - cx) / max(fx, 1e-6),
                     (xy[:, 1] - cy) / max(fy, 1e-6)], axis=1)


def verify_keyframe_pair_pnp(desc0, pts0, mask0, desc1, rays1, mask1,
                             ratio_threshold=0.9, inlier_threshold=0.01,
                             min_inliers=6, seed=0):
    """Match descriptors, then PnP RANSAC; frame 0 = my keyframe (3D
    landmarks), frame 1 = the query frame (2D only). Returns
    (RansacResult, match_count), same pose convention as
    matching2d.verify_keyframe_pair."""
    idx1, match_valid = mutual_match(desc0, mask0, desc1, mask1,
                                     ratio_threshold)
    result = ransac_pnp(pts0, rays1[idx1], match_valid,
                        inlier_threshold=inlier_threshold,
                        min_inliers=min_inliers, seed=seed)
    return result, torch.sum(match_valid)
