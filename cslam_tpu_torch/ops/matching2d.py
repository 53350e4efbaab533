"""Descriptor matching + robust 3D-3D pose verification.

Port of cslam_tpu/ops/matching2d.py: mutual nearest-neighbour matching
with Lowe's ratio test (one (K, K) similarity product, row and column
argmax), and batched-hypothesis RANSAC over matched 3D keypoints (the
3-point weighted Kabsch for every hypothesis at once, every hypothesis
scored against every correspondence in one (H, N) residual block). The
batched entry (`verify_keyframe_pairs`) stacks B targets into the same
tensors, one pipeline for a detection round's budget.

The hypothesis samples are the reference's `jax.random.choice(PRNGKey
(seed), N, (H, 3), p=valid / sum(valid))` reproduced bit for bit on the
host (`utils/jax_random.choice_p`), so the card, the CPU and the
reference draw the same samples. Drawing them reads the (B, N) validity
mask back from the device: one device-to-host copy per call.
"""

from typing import NamedTuple

import numpy as np
import torch

from cslam_tpu_torch.ops import registration
from cslam_tpu_torch.ops.registration import weighted_kabsch
from cslam_tpu_torch.utils.jax_random import choice_p

# seed stride between the targets of one batched verification (the
# reference's seed + 9973 b)
SEED_STRIDE = 9973


def mutual_match(desc0, mask0, desc1, mask1, ratio_threshold=0.9,
                 min_similarity=-1.0):
    """Mutual-NN matches with ratio test.

    desc0/mask0 may carry leading batch dimensions against one desc1.
    Returns (idx1_for_0, valid): for each keypoint in image 0 the matched
    index in image 1 (int64), and a (..., K0) float mask of surviving
    matches."""
    sims = desc0 @ desc1.T
    valid_pair = (mask0[..., :, None] > 0) & (mask1[None, :] > 0)
    sims = torch.where(valid_pair, sims, torch.full_like(sims, -torch.inf))
    best1 = torch.argmax(sims, dim=-1)
    top2 = torch.topk(sims, 2, dim=-1).values
    ratio_ok = top2[..., 0] * ratio_threshold >= top2[..., 1]
    best0 = torch.argmax(sims, dim=-2)
    mutual = torch.gather(best0, -1, best1) == torch.arange(
        desc0.shape[-2], device=desc0.device)
    score_ok = top2[..., 0] >= min_similarity
    valid = mutual & ratio_ok & score_ok & (mask0 > 0) & \
        torch.isfinite(top2[..., 0])
    return best1, valid.to(torch.float32)


class RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor       # (N,) float mask
    num_inliers: torch.Tensor   # scalar
    success: torch.Tensor       # bool
    cov_diag: torch.Tensor      # (6,) [omega, v] estimate covariance diag


def draw_samples(valid, seeds, num_hypotheses: int):
    """(B, H, 3) int64 sample indices on valid's device: per row b of the
    (B, N) mask, `jax.random.choice(PRNGKey(seeds[b]), N, (H, 3),
    replace=True, p=valid_b / max(sum(valid_b), 1))`."""
    v = valid.detach().to("cpu", torch.float32).numpy()
    n = v.shape[-1]
    out = np.empty((v.shape[0], num_hypotheses, 3), np.int64)
    for b, (row, seed) in enumerate(zip(v, seeds)):
        probs = row / np.float32(max(float(row.sum()), 1.0))
        out[b] = choice_p(int(seed), n, (num_hypotheses, 3), probs)
    return torch.from_numpy(out).to(valid.device)


def batch_seeds(seed: int, batch: int):
    """The reference's per-target seeds of a batched verification."""
    return [int(seed) + SEED_STRIDE * b for b in range(batch)]


def _gather_rows(x, idx):
    """x (B, N, C) at idx (B, ...) -> (B, ..., C)."""
    b = x.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(x, 1, flat[..., None].expand(*flat.shape,
                                                    x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def ransac_rigid3d_batched(pts0, pts1, valid, samples, inlier_threshold=0.3,
                           min_inliers=6):
    """RANSAC over B correspondence sets at once.

    pts0, pts1: (B, N, 3) with pts1 ~ R pts0 + t; valid: (B, N);
    samples: (B, H, 3) indices (draw_samples). Returns a RansacResult
    with leading (B,) axes."""
    src = _gather_rows(pts0, samples)               # (B, H, 3, 3)
    dst = _gather_rows(pts1, samples)
    Rs, ts = weighted_kabsch(src, dst, torch.ones(
        src.shape[:-1], dtype=src.dtype, device=src.device))
    moved = torch.einsum("bhij,bnj->bhni", Rs, pts0) + ts[:, :, None, :]
    res = torch.linalg.vector_norm(moved - pts1[:, None], dim=-1)
    inliers = (res < inlier_threshold) & (valid[:, None] > 0)
    counts = torch.sum(inliers, dim=-1)
    best = torch.argmax(counts, dim=-1)
    best_inliers = torch.gather(
        inliers, 1, best[:, None, None].expand(-1, 1, inliers.shape[-1]))[
        :, 0].to(torch.float32)
    R_ref, t_ref = weighted_kabsch(pts0, pts1, best_inliers)
    moved = pts0 @ torch.swapaxes(R_ref, -1, -2) + t_ref[:, None, :]
    res = torch.linalg.vector_norm(moved - pts1, dim=-1)
    final = ((res < inlier_threshold) & (valid > 0)).to(torch.float32)
    num = torch.sum(final, dim=-1)
    sigma_sq = torch.sum(final * res * res, dim=-1) / torch.clamp(num,
                                                                  min=1.0)
    cov_diag = registration.se3_estimate_covariance(moved, final, sigma_sq)
    return RansacResult(R=R_ref, t=t_ref, inliers=final, num_inliers=num,
                        success=num >= min_inliers, cov_diag=cov_diag)


def _unbatch(result: RansacResult) -> RansacResult:
    return RansacResult(*(x[0] for x in result))


def ransac_rigid3d(pts0, pts1, valid, inlier_threshold=0.3,
                   min_inliers=6, num_hypotheses=256, seed=0):
    """Robust relative pose from matched 3D points, batched hypotheses.

    pts0, pts1: (N, 3) matched camera-frame points (pts1 ~ R pts0 + t);
    valid: (N,) float mask; min_inliers: the success gate (reference
    frontend.pnp_min_inliers). Returns RansacResult, the pose refined on
    the winning inliers."""
    samples = draw_samples(valid[None], [seed], num_hypotheses)
    return _unbatch(ransac_rigid3d_batched(
        pts0[None], pts1[None], valid[None], samples,
        inlier_threshold=inlier_threshold, min_inliers=min_inliers))


def verify_keyframe_pair(desc0, pts0, mask0, desc1, pts1, mask1,
                         ratio_threshold=0.9, inlier_threshold=0.3,
                         min_inliers=6, seed=0):
    """Match descriptors, then robust 3D alignment. Returns
    (RansacResult, match_count); the pose maps frame-0 points into
    frame 1 (T_1<-0)."""
    idx1, match_valid = mutual_match(desc0, mask0, desc1, mask1,
                                     ratio_threshold)
    result = ransac_rigid3d(pts0, pts1[idx1], match_valid,
                            inlier_threshold=inlier_threshold,
                            min_inliers=min_inliers, seed=seed)
    return result, torch.sum(match_valid)


def verify_keyframe_pairs(desc0, pts0, mask0, desc1, pts1, mask1,
                          ratio_threshold=0.9, inlier_threshold=0.3,
                          min_inliers=6, num_hypotheses=256, seed=0):
    """B keyframes of mine against ONE received frame in one pipeline.

    desc0/pts0/mask0: (B, K, D), (B, K, 3), (B, K); desc1/pts1/mask1:
    (K, D), (K, 3), (K,). Target b draws its samples from seed
    seed + 9973 b. Returns (RansacResult with leading (B,) axes, (B,)
    match counts)."""
    idx1, valid = mutual_match(desc0, mask0, desc1, mask1, ratio_threshold)
    samples = draw_samples(valid, batch_seeds(seed, desc0.shape[0]),
                           num_hypotheses)
    res = ransac_rigid3d_batched(pts0, pts1[idx1], valid, samples,
                                 inlier_threshold=inlier_threshold,
                                 min_inliers=min_inliers)
    return res, torch.sum(valid, dim=-1)
