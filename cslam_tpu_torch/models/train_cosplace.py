"""Self-training of the CosPlace global-descriptor CNN on synthetic
rendered scenes.

Port of cslam_tpu/models/train_cosplace.py. The data helpers
(`make_world`, `render_view`, `sample_places`, `make_batch`) are
numpy-identical to the reference for the same seeds: the same worlds,
camera jitters and renders in the same RNG order. A "place" is a camera
position; its views are renders from pose-jittered cameras with sensor
noise. The training signal is supervised-contrastive (NT-Xent) place
recognition (`build_train_step`): same place => embeddings close,
different places => far. The network trains with its BatchNorms in
train mode (Flax's batch statistics and running-stat update,
models/cosplace.BatchNorm), in the reference's precision (bf16 convs),
with Adam under optax's cosine-decay schedule (models/training.py).
`main` keeps the checkpoint with the best held-out recall@1
(`eval_recall`, top-1 through the port's DescriptorDatabase).

Run (on the card; `--cpu` for the CPU):

    python -m cslam_tpu_torch.models.train_cosplace --steps 1500

The output (default `cslam_tpu_torch/_build/weights/cosplace_synth.npz`)
holds the reference's flat "params/..." and "batch_stats/..." keys.
"""

import argparse
import sys
import time

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.frontend.sim import render_corner_scene
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.models import convert
from cslam_tpu_torch.models.cosplace import GeoLocalizationNet, embed, \
    flax_init_, load_flat_weights, preprocess
from cslam_tpu_torch.models.training import CosineAdam, StepTimer, \
    default_out, flat_variables, parameters_on, save_flat, state_numpy


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


def supcon_loss(emb, labels, temperature=0.1):
    """Supervised NT-Xent: all same-place pairs are positives."""
    sim = emb @ emb.T / temperature
    n = emb.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=emb.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
    logz = torch.logsumexp(sim, dim=1, keepdim=True)
    logp = sim - logz
    per_anchor = -torch.sum(torch.where(pos, logp, torch.zeros_like(logp)),
                            dim=1) / torch.clamp(pos.sum(dim=1), min=1)
    return torch.mean(per_anchor)


def build_train_step(model, lr, steps, temperature=0.1):
    """(optimizer, train_step): train_step(images, labels) takes host
    arrays (a preprocessed (B, H, W, 3) batch and its place labels),
    takes one Adam step on the parameters' device with the BatchNorms in
    train mode (their running statistics move) and returns the loss as
    a tensor. The gradients of the step stay in the parameters' .grad."""
    opt = CosineAdam(model.parameters(), lr, steps, alpha=0.05)
    device = parameters_on(model)

    def train_step(images, labels):
        model.train()
        opt.zero_grad()
        emb = model(torch.from_numpy(np.asarray(images, np.float32))
                    .to(device))
        loss = supcon_loss(emb, torch.from_numpy(
            np.asarray(labels, np.int64)).to(device), temperature)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, train_step


def save_variables(model, path):
    """The model's params and batch_stats in the reference's flat layout
    at `path`."""
    save_flat(flat_variables(model, "cosplace"), path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--places", type=int, default=8)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--crop-size", type=int, default=224)
    ap.add_argument("--jitter-t", type=float, default=0.3)
    ap.add_argument("--jitter-yaw", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--init-from", default="",
                    help="warm-start from an existing .npz checkpoint")
    ap.add_argument("--out", default=default_out("cosplace_synth.npz"))
    return ap.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))
    return 0


def train(args, log=print):
    """main's training run: held-out recall@1 before training and every
    100 steps, the best-recall checkpoint saved. Returns (model
    holding the saved weights, per-step losses, device ms per step, host
    batch ms per step, best recall@1)."""
    device = resolve_device("cpu" if args.cpu else None)
    model = GeoLocalizationNet(fc_output_dim=args.dim)
    rng = np.random.default_rng(args.seed)
    flax_init_(model, args.seed)
    if args.init_from:
        load_flat_weights(model, convert.cosplace_state_dict(
            convert.load_flat(args.init_from)))
        log("warm-started from", args.init_from, flush=True)
    model.to(device)

    def recall():
        model.eval()
        return eval_recall(model, crop_size=args.crop_size, device=device)

    r0 = recall()
    log(f"recall@1 before training: {r0:.3f}", flush=True)
    _, train_step = build_train_step(model, args.lr, args.steps)
    losses, step_ms, batch_ms = [], [], []
    best = (r0, state_numpy(model))
    t0 = time.time()
    for step in range(args.steps):
        # a fresh world every step: a single persistent world overfits
        tb = time.perf_counter()
        world = make_world(int(rng.integers(2**31)), n=160)
        images, labels = make_batch(rng, world, args.places, args.views,
                                    args.jitter_t, args.jitter_yaw,
                                    args.crop_size)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        with StepTimer(device, step_ms):
            loss = train_step(images, labels)
        losses.append(float(loss))
        if step % 25 == 0 or step == args.steps - 1:
            log(f"step {step} loss {float(loss):.4f} "
                f"({time.time() - t0:.0f}s)", flush=True)
        if step % 100 == 99 or step == args.steps - 1:
            rec = recall()
            log(f"  eval recall@1 (held-out world): {rec:.3f}", flush=True)
            if rec > best[0]:
                best = (rec, state_numpy(model))
    # ship the best-by-held-out-recall checkpoint, not the last
    load_flat_weights(model, best[1])
    model.eval()
    save_variables(model, args.out)
    log(f"saved {args.out} (best recall@1 {best[0]:.3f})", flush=True)
    return model, losses, step_ms, batch_ms, best[0]


if __name__ == "__main__":
    sys.exit(main())
