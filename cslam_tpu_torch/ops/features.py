"""Visual local features: corner detection + patch descriptors.

Port of cslam_tpu/ops/features.py, the weight-free `frontend.features:
classical` path: Shi-Tomasi response from Sobel gradients and a box
filter (zero-padded cross-correlations, as the reference's
`conv_general_dilated` "SAME"), non-maximum suppression by a max pool
padded with -inf, a fixed keypoint budget with validity masks, and
mean/std-normalized intensity patches as descriptors.

Top-k ties: the reference's `lax.top_k` returns the lower index first
among equal scores, and the padded slots (all -inf) carry the first
pixels' coordinates into depth lookups and messages. `torch.topk`
promises no order among ties on the card, so `top_k` here is a stable
descending sort, which provably keeps the lower index first.
"""

import torch
import torch.nn.functional as F


def top_k(x, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _conv_same(img, kernel):
    """(H, W) cross-correlation with an odd (k, k) kernel, zero padding."""
    k = kernel.shape[-1]
    return F.conv2d(img[None, None], kernel[None, None],
                    padding=k // 2)[0, 0]


def _sobel(img):
    """(H, W) -> (gx, gy) via Sobel filters."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=img.device) / 8.0
    return _conv_same(img, kx), _conv_same(img, kx.T.contiguous())


def _box_filter(x, radius):
    k = 2 * radius + 1
    kernel = torch.ones((k, k), dtype=torch.float32,
                        device=x.device) / (k * k)
    return _conv_same(x, kernel)


def shi_tomasi_response(img, radius=2):
    """Min-eigenvalue corner response of the structure tensor."""
    gx, gy = _sobel(img.to(torch.float32))
    axx = _box_filter(gx * gx, radius)
    ayy = _box_filter(gy * gy, radius)
    axy = _box_filter(gx * gy, radius)
    tr = axx + ayy
    det = axx * ayy - axy * axy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc


def nms_max_pool(x, radius: int):
    """(H, W) max over a (2r+1)^2 window, -inf outside the image (the
    reference's `reduce_window(..., -inf, max, ..., "SAME")`)."""
    k = 2 * radius + 1
    return F.max_pool2d(x[None, None], k, stride=1, padding=radius)[0, 0]


def detect_keypoints(img, max_keypoints=256, nms_radius=4, border=8,
                     min_response=1e-4):
    """Top-k corners after local-max NMS.

    Returns (xy, scores, mask): (K, 2) float32 pixel coordinates (x, y),
    (K,) responses, (K,) validity (padded slots 0)."""
    H, W = img.shape
    resp = shi_tomasi_response(img)
    pooled = nms_max_pool(resp, nms_radius)
    is_max = (resp >= pooled) & (resp > min_response)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    in_border = (ys >= border) & (ys < H - border) & \
        (xs >= border) & (xs < W - border)
    scores = torch.where(is_max & in_border, resp,
                         torch.full_like(resp, -torch.inf)).reshape(-1)
    top_scores, top_idx = top_k(scores, max_keypoints)
    yy = (top_idx // W).to(torch.float32)
    xx = (top_idx % W).to(torch.float32)
    mask = (top_scores > -torch.inf).to(torch.float32)
    xy = torch.stack([xx, yy], dim=-1)
    return xy, torch.where(mask > 0, top_scores,
                           torch.zeros_like(top_scores)), mask


def patch_descriptors(img, xy, mask, patch_radius=7):
    """Mean/std-normalized intensity patches as descriptors.

    (K, (2r+1)^2) float32, L2-normalized; invalid keypoints give zero
    descriptors."""
    img = img.to(torch.float32)
    H, W = img.shape
    r = patch_radius
    d = torch.arange(-r, r + 1, device=img.device)
    offy, offx = torch.meshgrid(d, d, indexing="ij")
    ys = torch.clamp(xy[:, 1].to(torch.int64)[:, None, None] + offy[None],
                     0, H - 1)
    xs = torch.clamp(xy[:, 0].to(torch.int64)[:, None, None] + offx[None],
                     0, W - 1)
    patches = img[ys, xs].reshape(xy.shape[0], -1)
    mu = torch.mean(patches, dim=1, keepdim=True)
    sd = torch.sqrt(torch.mean((patches - mu) ** 2, dim=1, keepdim=True))
    desc = (patches - mu) / torch.clamp(sd, min=1e-6)
    desc = desc / torch.clamp(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-6)
    return desc * mask[:, None]


def extract_features(img, max_keypoints=256):
    """Keypoints + descriptors in one call: (xy, desc, scores, mask)."""
    xy, scores, mask = detect_keypoints(img, max_keypoints=max_keypoints)
    desc = patch_descriptors(img, xy, mask)
    return xy, desc, scores, mask


def backproject(xy, depth_at_kp, fx, fy, cx, cy):
    """Pixel + depth -> 3D camera-frame points (K, 3)."""
    x = (xy[:, 0] - cx) / fx * depth_at_kp
    y = (xy[:, 1] - cy) / fy * depth_at_kp
    return torch.stack([x, y, depth_at_kp], dim=-1)
