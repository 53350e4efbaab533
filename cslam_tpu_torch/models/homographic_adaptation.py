"""Homographic-adaptation pseudo-labels: self-supervised SuperPoint
training on real photographs (DeTone et al. 2018, section 5).

Port of cslam_tpu/models/homographic_adaptation.py. Fine-tuning on real
images with synthetic-style labels teaches the detector to suppress the
real corners the rendered labels mark as background. Homographic
adaptation sidesteps that: the labels come from the detector's own
responses aggregated over many homography warps of the real image.

Pipeline:
1. `aggregate_heatmap`: run the detector on N random warps of a source
   photograph (the warps drawn on the host exactly as in the reference,
   the forwards batched on the detector's device through the port's
   SuperPoint heatmap), pull each response map back through the inverse
   homography on the host, and average where valid;
2. `pseudo_corners`: NMS + threshold the aggregate into a corner list;
3. `RealPseudoDataset`: homography-pair training samples (crops of the
   source photographs with pseudo-corner cell labels) in the dict
   contract of synthetic_shapes.make_pair_sample, so train_superpoint's
   batch assembly and losses run unchanged (--real-mix).

The reference's `apply_fn(params, x)` and `params` keep their places:
here `params` is the SuperPointNet module (it holds the weights, and its
device is where the forwards run) and `apply_fn` calls it
(`apply_superpoint`, the default in the trainer).
"""

from typing import List, Sequence

import numpy as np
import torch

from cslam_tpu_torch.models.superpoint import _cell_scores_to_heatmap
from cslam_tpu_torch.models.synthetic_shapes import (apply_homography,
                                                     corners_to_cell_labels,
                                                     random_homography,
                                                     warp_image)
from cslam_tpu_torch.models.training import parameters_on

# warped images per forward (bounds the activations of large photos)
WARP_CHUNK = 8


def apply_superpoint(model, images):
    """(det_logits, desc) of a SuperPointNet over (B, H, W, 1) images."""
    return model(images)


def aggregate_heatmap(apply_fn, params, img, rng, n_warps=48,
                      include_identity=True):
    """Mean detector probability per source pixel over homography warps.

    apply_fn(params, (B, H, W, 1) tensor) -> (det_logits, desc); params:
    the SuperPointNet (the forwards run on its device); img: (H, W) in
    [0, 1] with H, W multiples of 8. Returns (heat, counts)."""
    H, W = img.shape
    device = parameters_on(params)
    warps = ([np.eye(3, dtype=np.float32)] if include_identity else [])
    while len(warps) < n_warps:
        warps.append(random_homography(rng, H, W))
    warped = [warp_image(img, Hm) for Hm in warps]
    heats = []
    with torch.no_grad():
        for c in range(0, len(warped), WARP_CHUNK):
            x = torch.from_numpy(np.stack(
                [w for w, _ in warped[c:c + WARP_CHUNK]])).to(device)
            det, _ = apply_fn(params, x[..., None])
            heats.append(_cell_scores_to_heatmap(det)[:, :H, :W].cpu())
    heats = torch.cat(heats).numpy()
    acc = np.zeros((H, W), np.float64)
    cnt = np.zeros((H, W), np.float64)
    for Hm, (_, wvalid), heat_w in zip(warps, warped, heats):
        # pull back to the source frame: S(p) = heat_w(Hm p)
        Hinv = np.linalg.inv(Hm.astype(np.float64)).astype(np.float32)
        back, bvalid = warp_image(heat_w * wvalid, Hinv)
        vback, _ = warp_image(wvalid, Hinv)
        ok = bvalid * (vback > 0.5)
        acc += back * ok
        cnt += ok
    heat = (acc / np.maximum(cnt, 1.0)).astype(np.float32)
    return heat, cnt.astype(np.float32)


def pseudo_corners(heat, nms_radius=4, threshold=0.015,
                   max_corners=1200):
    """Corner list from an aggregated heatmap: greedy NMS by max-pool
    equality + absolute threshold, strongest `max_corners` kept."""
    H, W = heat.shape
    k = nms_radius
    padded = np.pad(heat, k, mode="constant")
    stacked = np.stack([
        padded[k + dy:k + dy + H, k + dx:k + dx + W]
        for dy in range(-k, k + 1) for dx in range(-k, k + 1)], axis=0)
    is_max = (heat >= stacked.max(axis=0) - 1e-9) & (heat > threshold)
    ys, xs = np.nonzero(is_max)
    if len(xs) > max_corners:
        order = np.argsort(-heat[ys, xs])[:max_corners]
        ys, xs = ys[order], xs[order]
    return np.stack([xs, ys], axis=1).astype(np.float32) \
        if len(xs) else np.zeros((0, 2), np.float32)


def default_source_images(extra_paths: Sequence[str] = ()) -> List[np.ndarray]:
    """The offline real-pixel corpus: the full source photograph plus
    every checked-in real_seq / real_seq_b frame."""
    import glob
    import os
    from PIL import Image
    from cslam_tpu_torch.models.synthetic_shapes import _photo_source

    imgs = [_photo_source()]
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    for seq in ("real_seq", "real_seq_b"):
        for p in sorted(glob.glob(os.path.join(
                repo, "tests", "data", seq, "image_2", "*.jpg"))):
            imgs.append(np.asarray(Image.open(p).convert("L"),
                                   np.float32) / 255.0)
    for p in extra_paths:
        imgs.append(np.asarray(Image.open(p).convert("L"),
                               np.float32) / 255.0)
    # crop every image to 8-multiples (cell grid)
    out = []
    for im in imgs:
        h8, w8 = (im.shape[0] // 8) * 8, (im.shape[1] // 8) * 8
        out.append(np.ascontiguousarray(im[:h8, :w8]))
    return out


class RealPseudoDataset:
    """Homography-pair training samples from pseudo-labeled real images.

    Built once per training run: labels come from the CURRENT detector
    (`apply_fn(params, x)`, as in `aggregate_heatmap`) via homographic
    adaptation (self-supervision: no human or synthetic labels touch
    real pixels). `images` defaults to `default_source_images()`."""

    def __init__(self, apply_fn, params, images=None, rng=None,
                 n_warps=48, threshold=0.010, ignore_frac=0.35):
        rng = rng or np.random.default_rng(0)
        images = images if images is not None else default_source_images()
        self.threshold = threshold
        self.ignore_thr = ignore_frac * threshold
        self.images: List[np.ndarray] = []
        self.corners: List[np.ndarray] = []
        self.heats: List[np.ndarray] = []
        for img in images:
            heat, _ = aggregate_heatmap(apply_fn, params, img, rng,
                                        n_warps=n_warps)
            cs = pseudo_corners(heat, threshold=threshold)
            self.images.append(img)
            self.corners.append(cs)
            self.heats.append(heat)

    def corner_counts(self):
        return [len(c) for c in self.corners]

    def sample_pair(self, rng, H, W):
        """One make_pair_sample-contract dict from a random crop of a
        random source image."""
        for _ in range(20):
            i = int(rng.integers(len(self.images)))
            img = self.images[i]
            cs = self.corners[i]
            if img.shape[0] < H + 8 or img.shape[1] < W + 8:
                continue
            y0 = int(rng.integers(0, img.shape[0] - H + 1)) & ~7
            x0 = int(rng.integers(0, img.shape[1] - W + 1)) & ~7
            crop = img[y0:y0 + H, x0:x0 + W]
            heat_crop = self.heats[i][y0:y0 + H, x0:x0 + W]
            if cs.size:
                inside = (cs[:, 0] >= x0 + 1) & (cs[:, 0] < x0 + W - 1) & \
                    (cs[:, 1] >= y0 + 1) & (cs[:, 1] < y0 + H - 1)
                corners = cs[inside] - np.array([x0, y0], np.float32)
            else:
                corners = np.zeros((0, 2), np.float32)
            if len(corners) >= 8:
                break
        # photometric jitter on the source view too (real cameras vary)
        img0 = np.clip(crop * rng.uniform(0.85, 1.15) +
                       rng.uniform(-0.06, 0.06), 0, 1).astype(np.float32)
        Hm = random_homography(rng, H, W)
        img1, valid1 = warp_image(img0, Hm)
        img1 = np.clip(img1 * rng.uniform(0.7, 1.3) +
                       rng.uniform(-0.12, 0.12), 0, 1).astype(np.float32)
        img1 = np.clip(img1 + 0.02 * rng.standard_normal((H, W)),
                       0, 1).astype(np.float32)
        labels0 = corners_to_cell_labels(corners, H, W)
        c1 = apply_homography(Hm, corners) if len(corners) else corners
        keep = np.ones(len(corners), dtype=bool)
        if len(corners):
            keep = (c1[:, 0] >= 2) & (c1[:, 0] <= W - 3) & \
                   (c1[:, 1] >= 2) & (c1[:, 1] <= H - 3)
        labels1 = corners_to_cell_labels(
            c1[keep] if len(corners) else c1, H, W)
        Hc, Wc = H // 8, W // 8
        # ignore-cells: intermediate aggregate response without a
        # labeled pseudo-corner — the detector fired there sometimes,
        # so a dustbin label would teach suppression of a maybe-corner
        # (the exact round-4 failure mode). train_superpoint zeroes the
        # detector loss on (label==dustbin & ignore) cells.
        cellmax = heat_crop[:Hc * 8, :Wc * 8].reshape(
            Hc, 8, Wc, 8).max(axis=(1, 3))
        ignore0 = cellmax > self.ignore_thr
        ig_px = np.repeat(np.repeat(ignore0.astype(np.float32), 8, 0),
                          8, 1)[:H, :W]
        ig1_px, _ = warp_image(ig_px, Hm)
        ignore1 = ig1_px[4::8, 4::8][:Hc, :Wc] > 0.25
        return {"img0": img0, "img1": img1, "H": Hm, "corners0": corners,
                "corners1": c1[keep] if len(corners) else c1,
                "labels0": labels0, "labels1": labels1, "valid1": valid1,
                "ignore0": ignore0, "ignore1": ignore1}
