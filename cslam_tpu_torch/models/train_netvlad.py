"""Self-training of the NetVLAD place-recognition model on synthetic
rendered scenes: the NetVLAD counterpart of train_cosplace.py.

Port of cslam_tpu/models/train_netvlad.py. Differences from the CosPlace
run, as in the reference:
- VGG16 has no normalization layers, so there are no batch statistics,
  and training renders are embedded at crop 128;
- `data_driven_init` sets NetVLAD's published initialization (centroids
  from real backbone features, assignment conv 2 * alpha * centroids);
- after training, a PCA projection to `--pca-dim` is fitted on
  training-world descriptors (`fit_pca`: the SVD on the host in numpy,
  as the reference, so the components keep the reference's signs) and
  saved beside the weights (mean + components).

The forwards and the step run on the model's device in the reference's
precision (bf16 convs, an f32 NetVLAD layer), with Adam under optax's
cosine-decay schedule (models/training.py). Held-out recall@1
(`eval_recall`) ranks the descriptors on the host, as the reference.

Run (on the card; `--cpu` for the CPU):

    python -m cslam_tpu_torch.models.train_netvlad --steps 800

Outputs default to `cslam_tpu_torch/_build/weights/netvlad_synth.npz`
and `netvlad_pca_synth.npz`.
"""

import argparse
import sys
import time

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.models import convert
from cslam_tpu_torch.models.cosplace import embed, flax_init_, \
    load_flat_weights
from cslam_tpu_torch.models.netvlad import NetVLADNet
from cslam_tpu_torch.models.train_cosplace import make_batch, make_world, \
    supcon_loss
from cslam_tpu_torch.models.training import CosineAdam, StepTimer, \
    default_out, flat_variables, parameters_on, save_flat, state_numpy


def build_train_step(model, lr, steps, temperature=0.1):
    """(optimizer, train_step): train_step(images, labels) takes host
    arrays, takes one Adam step on the parameters' device and returns
    the supervised NT-Xent loss as a tensor. The gradients of the step
    stay in the parameters' .grad."""
    opt = CosineAdam(model.parameters(), lr, steps, alpha=0.05)
    device = parameters_on(model)

    def train_step(images, labels):
        opt.zero_grad()
        emb = model(torch.from_numpy(np.asarray(images, np.float32))
                    .to(device))
        loss = supcon_loss(emb, torch.from_numpy(
            np.asarray(labels, np.int64)).to(device), temperature)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, train_step


def data_driven_init(model, rng, crop_size, alpha=8.0):
    """NetVLAD's published initialization (Arandjelovic et al., sec. 4):
    the centroids are real (l2-normalized) backbone features and the
    assignment conv is 2 * alpha * centroids. Features of two rendered
    batches are drawn in the reference's RNG order; the centroids are
    sampled from them with `rng` on the host. Sets `model`'s layer in
    place and returns the model."""
    device = parameters_on(model)
    feats = []
    with torch.no_grad():
        for _ in range(2):
            world = make_world(int(rng.integers(2**31)), n=160)
            batch, _ = make_batch(rng, world, 8, 2, 0.3, 0.05, crop_size)
            x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
            f = model.encoder(x).float().permute(0, 2, 3, 1)
            feats.append(f.reshape(-1, f.shape[-1]).cpu().numpy())
    X = np.concatenate(feats)
    X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    K = model.pool.num_clusters
    pick = rng.choice(len(X), K, replace=False)
    centroids = X[pick]                        # (K, C), unit rows
    with torch.no_grad():
        model.pool.centroids.copy_(torch.from_numpy(centroids))
        model.pool.conv.weight.copy_(torch.from_numpy(
            2.0 * alpha * centroids)[:, :, None, None])
    return model


def _embeddings(model, batch, device):
    model.eval()
    return embed(model, batch, device)


def eval_recall(model, seed=9999, n_places=24, crop_size=128,
                displacement=0.35, yaw=0.06, n_worlds=3,
                device: DeviceLike = None):
    """Recall@1 over held-out worlds: each query view must retrieve the
    other view of its place (top-1 excluding self, ranked on the host).
    `model` is a NetVLADNet whose weights are on `device` (None: the
    model's own)."""
    device = parameters_on(model) if device is None else \
        resolve_device(device)
    recalls = []
    for w in range(n_worlds):
        rng = np.random.default_rng(seed + 17 * w)
        world = make_world(seed + 17 * w, n=160)
        batch, labels = make_batch(rng, world, n_places, 2,
                                   displacement, yaw, crop_size)
        emb = _embeddings(model, batch, device)
        sim = emb @ emb.T
        np.fill_diagonal(sim, -np.inf)
        top1 = sim.argmax(axis=1)
        recalls.append(float((labels[top1] == labels).mean()))
    return float(np.mean(recalls))


def fit_pca(model, pca_dim, seed, crop_size, n_batches=6,
            device: DeviceLike = None):
    """PCA basis over descriptors of training-distribution renders: the
    descriptors on the model's device, the economy SVD on the host in
    numpy (its signs are the reference's). Returns (mean, components)."""
    device = parameters_on(model) if device is None else \
        resolve_device(device)
    descs = []
    rng = np.random.default_rng(seed + 1)
    for b in range(n_batches):
        world = make_world(seed + 100 + b, n=160)
        batch, _ = make_batch(rng, world, 12, 2, 0.3, 0.05, crop_size)
        descs.append(_embeddings(model, batch, device))
    X = np.concatenate(descs)            # (N, 32768)
    mean = X.mean(axis=0)
    Xc = X - mean
    U, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    comps = Vt[:pca_dim]                 # (pca_dim, D)
    return mean.astype(np.float32), comps.astype(np.float32)


def save_variables(model, path):
    """The model's params in the reference's flat layout at `path`."""
    save_flat(flat_variables(model, "netvlad"), path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--places", type=int, default=8)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crop-size", type=int, default=128)
    ap.add_argument("--pca-dim", type=int, default=128)
    ap.add_argument("--jitter-t", type=float, default=0.3)
    ap.add_argument("--jitter-yaw", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--init-from", default="")
    ap.add_argument("--out", default=default_out("netvlad_synth.npz"))
    ap.add_argument("--pca-out", default=default_out("netvlad_pca_synth.npz"))
    return ap.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))
    return 0


def train(args, log=print):
    """main's training run: data-driven init (unless warm-started),
    held-out recall@1 before training and every 100 steps, the
    best-recall weights saved, then the PCA fitted on them and saved.
    Returns (model holding the saved weights, per-step losses, device ms
    per step, host batch ms per step, best recall@1, (mean,
    components))."""
    device = resolve_device("cpu" if args.cpu else None)
    model = NetVLADNet()
    rng = np.random.default_rng(args.seed)
    flax_init_(model, args.seed)
    model.to(device)
    if args.init_from:
        load_flat_weights(model, convert.netvlad_state_dict(
            convert.load_flat(args.init_from)))
        model.to(device)
        log("warm-started from", args.init_from, flush=True)
    else:
        data_driven_init(model, rng, args.crop_size)

    r0 = eval_recall(model, crop_size=args.crop_size)
    log(f"recall@1 before training: {r0:.3f}", flush=True)
    _, train_step = build_train_step(model, args.lr, args.steps)
    losses, step_ms, batch_ms = [], [], []
    # the data-driven init is itself a candidate
    best = (r0, state_numpy(model))
    t0 = time.time()
    for step in range(args.steps):
        tb = time.perf_counter()
        world = make_world(int(rng.integers(2**31)), n=160)
        images, labels = make_batch(rng, world, args.places, args.views,
                                    args.jitter_t, args.jitter_yaw,
                                    args.crop_size)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        model.train()
        with StepTimer(device, step_ms):
            loss = train_step(images, labels)
        losses.append(float(loss))
        if step % 25 == 0 or step == args.steps - 1:
            log(f"step {step} loss {float(loss):.4f} "
                f"({time.time() - t0:.0f}s)", flush=True)
        if step % 100 == 99 or step == args.steps - 1:
            rec = eval_recall(model, crop_size=args.crop_size)
            log(f"  eval recall@1 (held-out world): {rec:.3f}", flush=True)
            if rec > best[0]:
                best = (rec, state_numpy(model))
    load_flat_weights(model, best[1])
    save_variables(model, args.out)
    log(f"saved {args.out} (best recall@1 {best[0]:.3f})", flush=True)

    mean, comps = fit_pca(model, args.pca_dim, args.seed, args.crop_size)
    save_flat({"mean": mean, "components": comps}, args.pca_out)
    log("saved", args.pca_out, flush=True)
    return model, losses, step_ms, batch_ms, best[0], (mean, comps)


if __name__ == "__main__":
    sys.exit(main())
