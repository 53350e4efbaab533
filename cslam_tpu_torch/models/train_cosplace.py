"""Evaluation data for the CosPlace global-descriptor CNN: rendered
places on persistent synthetic worlds and the held-out recall@1 gate.

Port of the evaluation helpers of cslam_tpu/models/train_cosplace.py
(`make_world`, `render_view`, `sample_places`, `make_batch`,
`eval_recall`), numpy-identical to the reference for the same seeds: the
same worlds, camera jitters and renders in the same RNG order. A
"place" is a camera position; its views are renders from pose-jittered
cameras with sensor noise. The training step, the weight saver and the
training script are not ported yet: they belong to the training slice.
"""

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.sim import render_corner_scene
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.models.cosplace import embed, preprocess


class _Intr:
    fx = 120.0
    fy = 120.0
    cx = 80.0
    cy = 60.0


def make_world(seed, n=160):
    """Persistent world: corner squares on the z=5 plane, spread wide
    enough that different camera positions see different subsets."""
    rng = np.random.default_rng(seed)
    squares_w = np.stack([rng.uniform(-7.0, 7.0, n),
                          rng.uniform(-5.5, 5.5, n),
                          np.full(n, 5.0)], axis=1).astype(np.float32)
    shades = np.where(rng.random(n) < 0.5,
                      rng.uniform(0.0, 0.18, n),
                      rng.uniform(0.82, 1.0, n))
    return squares_w, shades


def _yaw_R(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def render_view(world, xy, rng, jitter_t=0.0, jitter_yaw=0.0):
    squares_w, shades = world
    t = np.array([xy[0] + rng.uniform(-jitter_t, jitter_t),
                  xy[1] + rng.uniform(-jitter_t, jitter_t), 0.0],
                 np.float32)
    R = _yaw_R(rng.uniform(-jitter_yaw, jitter_yaw))
    img, _ = render_corner_scene((R, t), _Intr, rng,
                                 squares_w=squares_w, shades=shades)
    return img


def sample_places(rng, n_places, cell=1.2):
    """Distinct camera positions: grid cells picked without replacement,
    jittered inside each (>= cell/3 apart)."""
    xs = np.arange(-3.0, 3.01, cell)
    ys = np.arange(-2.5, 2.51, cell)
    cells = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    if n_places > len(cells):
        raise ValueError(f"n_places {n_places} > grid cells {len(cells)}")
    idx = rng.choice(len(cells), n_places, replace=False)
    jitter = rng.uniform(-cell / 3, cell / 3, (n_places, 2))
    return (cells[idx] + jitter).astype(np.float32)


def render_places(rng, world, n_places, n_views, jitter_t, jitter_yaw):
    """(n_places * n_views, H, W, 3) uint8 renders and their place
    labels, in make_batch's draw order."""
    places = sample_places(rng, n_places)
    imgs, labels = [], []
    for pid, xy in enumerate(places):
        for _ in range(n_views):
            g = rng.integers(0, 2**31)
            vr = np.random.default_rng(g)
            im = render_view(world, xy, vr, jitter_t, jitter_yaw)
            imgs.append(np.broadcast_to(im[..., None], im.shape + (3,)))
            labels.append(pid)
    return np.stack(imgs), np.asarray(labels, np.int32)


def make_batch(rng, world, n_places, n_views, jitter_t, jitter_yaw,
               crop_size):
    imgs, labels = render_places(rng, world, n_places, n_views, jitter_t,
                                 jitter_yaw)
    return preprocess(imgs, crop_size).astype(np.float32), labels


def top1_recall(emb: np.ndarray, labels: np.ndarray,
                device: DeviceLike = None) -> float:
    """Share of descriptors whose nearest other descriptor (cosine) has
    the same label. The search is the port's DescriptorDatabase on
    `device` (the cosine top-k kernel on a card): top-2 of every
    descriptor, itself excluded."""
    db = DescriptorDatabase(dim=emb.shape[1], method="pallas",
                            device=device)
    for i, e in enumerate(emb):
        db.add_item(e, i)
    items, _ = db.batch_search(emb, 2)
    top1 = np.array([row[1] if row[0] == i else row[0]
                     for i, row in enumerate(items)])
    return float((labels[top1] == labels).mean())


def eval_recall(model: torch.nn.Module, seed=9999, n_places=24,
                crop_size=224, displacement=0.35, yaw=0.06, n_worlds=3,
                device: DeviceLike = None):
    """Recall@1 averaged over held-out worlds: each query view must
    retrieve the other view of its place (top-1 excluding self). `model`
    is a GeoLocalizationNet whose weights are on `device`."""
    dev = resolve_device(device)
    recalls = []
    for w in range(n_worlds):
        rng = np.random.default_rng(seed + 17 * w)
        world = make_world(seed + 17 * w, n=160)
        batch, labels = make_batch(rng, world, n_places, 2,
                                   displacement, yaw, crop_size)
        emb = embed(model, batch, dev)
        recalls.append(top1_recall(emb, labels, dev))
    return float(np.mean(recalls))
