"""Batched sparse stereo correspondence.

Port of cslam_tpu/ops/stereo.py: every keypoint of the left image
scores every candidate disparity along its scan line with ZNCC, in one
(K, D, P) gather and contraction, then a parabola refines the best
disparity to subpixel.
"""

import torch


def stereo_correspondences(left, right, xy, mask, max_disparity=64,
                           patch_radius=4, min_zncc=0.6):
    """Per-keypoint disparity by exhaustive scan-line ZNCC matching.

    left, right: (H, W) float32 rectified images; xy: (K, 2) keypoints
    (x, y) in the LEFT image; mask: (K,) validity. Returns (disparity
    (K,) float32 parabola-refined, valid (K,) float32: keypoint valid,
    ZNCC above min_zncc, disparity strictly inside [0, max_disparity),
    window inside both images)."""
    H, W = left.shape
    K = xy.shape[0]
    r = patch_radius
    D = max_disparity
    dev = left.device
    xs = torch.round(xy[:, 0]).to(torch.int64)
    ys = torch.round(xy[:, 1]).to(torch.int64)
    d = torch.arange(-r, r + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dy = dy.reshape(-1)
    dx = dx.reshape(-1)
    P = dy.shape[0]

    ly = torch.clamp(ys[:, None] + dy[None, :], 0, H - 1)
    lx = torch.clamp(xs[:, None] + dx[None, :], 0, W - 1)
    lp = left[ly, lx]
    lp = lp - torch.mean(lp, dim=1, keepdim=True)
    ln = torch.clamp(torch.linalg.vector_norm(lp, dim=1, keepdim=True),
                     min=1e-6)
    lp = lp / ln

    ds = torch.arange(D, device=dev)
    ry = torch.clamp(ys[:, None, None] + dy[None, None, :], 0, H - 1)
    rx_raw = xs[:, None, None] - ds[None, :, None] + dx[None, None, :]
    rx = torch.clamp(rx_raw, 0, W - 1)
    rp = right[ry.expand(K, D, P), rx]
    rp = rp - torch.mean(rp, dim=2, keepdim=True)
    rn = torch.clamp(torch.linalg.vector_norm(rp, dim=2, keepdim=True),
                     min=1e-6)
    rp = rp / rn

    scores = torch.einsum("kp,kdp->kd", lp, rp)
    window_ok = rx_raw.amin(dim=2) >= 0
    scores = torch.where(window_ok, scores, torch.full_like(scores, -1.0))

    best = torch.argmax(scores, dim=1)
    s_best = torch.gather(scores, 1, best[:, None])[:, 0]
    bm1 = torch.clamp(best - 1, 0, D - 1)
    bp1 = torch.clamp(best + 1, 0, D - 1)
    sm1 = torch.gather(scores, 1, bm1[:, None])[:, 0]
    sp1 = torch.gather(scores, 1, bp1[:, None])[:, 0]
    denom = sm1 - 2.0 * s_best + sp1
    ok = torch.abs(denom) > 1e-9
    delta = torch.where(ok, 0.5 * (sm1 - sp1) / torch.where(
        ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    disparity = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    left_window_ok = ((xs - r >= 0) & (xs + r < W) &
                      (ys - r >= 0) & (ys + r < H))
    valid = (mask > 0) & (s_best >= min_zncc) & left_window_ok & \
        (best >= 1) & (best <= D - 2) & (disparity > 0.5)
    return disparity, valid.to(torch.float32)


def depth_from_disparity(disparity, valid, fx, baseline):
    """z = fx * b / d, zeroed where the correspondence was rejected."""
    d = torch.clamp(disparity, min=1e-3)
    return torch.where(valid > 0, fx * baseline / d, torch.zeros_like(d))
