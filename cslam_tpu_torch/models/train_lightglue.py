"""Evaluation helpers of the LightGlue matcher's self-training.

Port of the evaluation half of cslam_tpu/models/train_lightglue.py:
`make_match_batch` (numpy; the synthetic matching problems the shipped
lightglue_synth.npz was trained on, with the same RNG draws in the same
order, so one seed gives both packages the same batch) and
`eval_matching` (precision/recall of LightGlue's mutual-argmax matches
against raw-descriptor mutual matching). The homography helpers are the
port's copies of the two that `make_match_batch` calls from the
reference's models/synthetic_shapes.py. Training itself is not ported.
"""

import numpy as np
import torch

from cslam_tpu_torch.models.lightglue import normalize_keypoints


def random_homography(rng, H, W, max_angle=0.6, max_scale=0.25,
                      max_translate=0.15, max_persp=0.0008):
    """Random similarity + perspective homography mapping (x, y, 1)."""
    a = rng.uniform(-max_angle, max_angle)
    s = np.exp(rng.uniform(-max_scale, max_scale))
    tx = rng.uniform(-max_translate, max_translate) * W
    ty = rng.uniform(-max_translate, max_translate) * H
    cx, cy = W / 2.0, H / 2.0
    ca, sa = np.cos(a), np.sin(a)
    A = np.array([[s * ca, -s * sa, cx - s * (ca * cx - sa * cy) + tx],
                  [s * sa, s * ca, cy - s * (sa * cx + ca * cy) + ty],
                  [0, 0, 1]], dtype=np.float64)
    P = np.eye(3)
    P[2, 0] = rng.uniform(-max_persp, max_persp)
    P[2, 1] = rng.uniform(-max_persp, max_persp)
    return (A @ P).astype(np.float32)


def apply_homography(Hm, xy):
    """(N, 2) points through a 3x3 homography."""
    xy1 = np.concatenate([xy, np.ones((len(xy), 1), np.float32)], axis=1)
    w = xy1 @ Hm.T
    return w[:, :2] / np.maximum(w[:, 2:3], 1e-8)


def make_match_batch(rng, batch, K=96, D=256, H=120, W=160,
                     noise_lo=0.4, noise_hi=0.95):
    """Synthetic matching problems: two views share n_inlier points
    (view 1 through a random homography), descriptors
    unit(sqrt(1 - s^2) z + s u) with noise level s.

    Returns (desc0, xy0, m0, desc1, xy1, m1, gt1_for_0, matched0,
    matched1): gt1_for_0[i] = index in view 1 matched to view-0 point i
    (or -1), matched* are {0, 1} masks."""
    desc0 = np.zeros((batch, K, D), np.float32)
    desc1 = np.zeros((batch, K, D), np.float32)
    xy0 = np.zeros((batch, K, 2), np.float32)
    xy1 = np.zeros((batch, K, 2), np.float32)
    gt = np.full((batch, K), -1, np.int32)

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-9)

    for b in range(batch):
        n_in = int(rng.integers(K // 4, 3 * K // 4))
        sigma = rng.uniform(noise_lo, noise_hi)
        z = unit(rng.standard_normal((n_in, D)).astype(np.float32))
        p0 = np.stack([rng.uniform(5, W - 5, K),
                       rng.uniform(5, H - 5, K)], axis=1).astype(np.float32)
        Hm = random_homography(rng, H, W)
        p1_in = apply_homography(Hm, p0[:n_in]) + \
            rng.normal(0, 0.5, (n_in, 2)).astype(np.float32)
        inside = (p1_in[:, 0] >= 0) & (p1_in[:, 0] < W) & \
                 (p1_in[:, 1] >= 0) & (p1_in[:, 1] < H)
        p1 = np.stack([rng.uniform(5, W - 5, K),
                       rng.uniform(5, H - 5, K)], axis=1).astype(np.float32)
        slots = rng.permutation(K)[: int(inside.sum())]
        p1[slots] = p1_in[inside]
        d0 = unit(rng.standard_normal((K, D)).astype(np.float32))
        d1 = unit(rng.standard_normal((K, D)).astype(np.float32))
        signal = np.sqrt(max(1.0 - sigma ** 2, 0.0))

        def noisy(base):
            u = unit(rng.standard_normal(base.shape).astype(np.float32))
            return unit(signal * base + sigma * u)

        d0[:n_in] = noisy(z)
        d1[slots] = noisy(z[inside])
        gt[b, np.nonzero(inside)[0]] = slots
        desc0[b], desc1[b], xy0[b], xy1[b] = d0, d1, p0, p1
    m = np.ones((batch, K), np.float32)
    matched0 = (gt >= 0).astype(np.float32)
    matched1 = np.zeros((batch, K), np.float32)
    for b in range(batch):
        matched1[b, gt[b][gt[b] >= 0]] = 1.0
    return desc0, xy0, m, desc1, xy1, m, gt, matched0, matched1


def eval_matching(model, rng, n_pairs=32, K=96, sigma=0.6, H=120, W=160,
                  threshold=0.1, device=None):
    """Precision/recall of mutual-argmax matches at one noise level,
    compared with raw-descriptor mutual matching. `model` is a
    LightGlueNet on `device` (default: the model's own); all pairs run
    in one batched forward."""
    if device is None:
        device = next(model.parameters()).device
    size = torch.tensor([W, H], dtype=torch.float32, device=device)
    batch = make_match_batch(rng, n_pairs, K=K, noise_lo=sigma,
                             noise_hi=sigma, H=H, W=W)
    d0, p0, m0, d1, p1, m1 = (torch.from_numpy(x).to(device)
                              for x in batch[:6])
    gt = batch[6]
    with torch.no_grad():
        scores = model(d0, normalize_keypoints(p0, size), m0, d1,
                       normalize_keypoints(p1, size), m1)
    p = np.exp(scores.cpu().numpy())
    stats = {"tp": 0, "fp": 0, "pos": int((gt >= 0).sum())}
    raw = {"tp": 0, "fp": 0}
    for b in range(n_pairs):
        best1 = p[b].argmax(axis=1)
        best0 = p[b].argmax(axis=0)
        mutual = best0[best1] == np.arange(p.shape[1])
        conf = p[b].max(axis=1) > threshold
        sel = mutual & conf
        stats["tp"] += int((sel & (best1 == gt[b]) & (gt[b] >= 0)).sum())
        stats["fp"] += int((sel & (best1 != gt[b])).sum())
        sim = batch[0][b] @ batch[3][b].T
        rb1 = sim.argmax(axis=1)
        rb0 = sim.argmax(axis=0)
        rmut = rb0[rb1] == np.arange(sim.shape[0])
        raw["tp"] += int((rmut & (rb1 == gt[b]) & (gt[b] >= 0)).sum())
        raw["fp"] += int((rmut & (rb1 != gt[b])).sum())
    out = {}
    for name, s in (("lightglue", stats), ("raw", raw)):
        n_sel = s["tp"] + s["fp"]
        out[name] = {"precision": s["tp"] / max(n_sel, 1),
                     "recall": s["tp"] / max(stats["pos"], 1)}
    return out
