"""Self-training of the SuperPoint detector/descriptor on synthetic
shapes (models/synthetic_shapes.py).

Port of cslam_tpu/models/train_superpoint.py:

- detector head: 65-way per-cell cross-entropy against exact corner
  positions of rendered primitives (the MagicPoint stage of DeTone et
  al. 2018);
- descriptor head: InfoNCE over cell pairs of a homography-warped image
  pair: each corner cell's descriptor must pick out its warped
  counterpart against every other valid cell (cells within 8 px of the
  target are excluded from the negative set as near-duplicates).

The batches are drawn on the host with the reference's RNG order
(`_batch`), the step runs on the model's device, in f32 (the reference
trains `SuperPointNet(dtype=float32)`), with Adam under optax's
cosine-decay schedule (models/training.py).

Run (on the card; `--cpu` for the CPU):

    python -m cslam_tpu_torch.models.train_superpoint \
        --steps 1500 --batch 16 --height 64 --width 96

The output .npz (default `cslam_tpu_torch/_build/weights/
superpoint_synth.npz`) holds the reference's flat "params/..." keys, so
both packages' `SuperPoint(checkpoint=<path>)` load it.
"""

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from cslam_tpu_torch.device import resolve_device
from cslam_tpu_torch.models import convert
from cslam_tpu_torch.models.cosplace import flax_init_, load_flat_weights
from cslam_tpu_torch.models.superpoint import SuperPointNet
from cslam_tpu_torch.models.synthetic_shapes import apply_homography, \
    make_pair_sample
from cslam_tpu_torch.models.training import CosineAdam, StepTimer, \
    batch_to, default_out, flat_variables, parameters_on, save_flat


def _batch(rng, n, H, W, background="gradient", real_ds=None,
           real_mix=0.0):
    """Host-side batch: images, cell labels for both views, the warp
    grid correspondence (cell-center positions of view 0 mapped into
    view 1), a validity mask for view-1 cells, and the detector-loss
    weights of both views.

    real_ds/real_mix: blend homographic-adaptation pseudo-labeled real
    image pairs (models/homographic_adaptation.RealPseudoDataset) into
    the synthetic stream."""
    im0 = np.zeros((n, H, W, 1), np.float32)
    im1 = np.zeros((n, H, W, 1), np.float32)
    Hc, Wc = H // 8, W // 8
    lab0 = np.zeros((n, Hc, Wc), np.int32)
    lab1 = np.zeros((n, Hc, Wc), np.int32)
    warped_centers = np.zeros((n, Hc * Wc, 2), np.float32)
    valid1 = np.zeros((n, Hc, Wc), np.float32)
    # detector-loss weights: 1 everywhere except dustbin-labeled cells
    # whose background has its own (unlabeled) corner structure
    det_w0 = np.ones((n, Hc, Wc), np.float32)
    det_w1 = np.ones((n, Hc, Wc), np.float32)
    cy, cx = np.mgrid[0:Hc, 0:Wc]
    centers = np.stack([cx.ravel() * 8 + 4, cy.ravel() * 8 + 4],
                       axis=1).astype(np.float32)
    for i in range(n):
        if real_ds is not None and rng.random() < real_mix:
            s = real_ds.sample_pair(rng, H, W)
        else:
            s = make_pair_sample(rng, H, W, background=background)
        im0[i, :, :, 0] = s["img0"]
        im1[i, :, :, 0] = s["img1"]
        lab0[i] = s["labels0"]
        lab1[i] = s["labels1"]
        warped_centers[i] = apply_homography(s["H"], centers)
        # a view-1 cell is usable when its center came from inside the
        # source image (warp validity map, subsampled at cell centers)
        v = s["valid1"][4::8, 4::8]
        valid1[i] = v[:Hc, :Wc]
        ig0 = s["ignore0"][:Hc, :Wc]
        ig1 = s["ignore1"][:Hc, :Wc]
        det_w0[i] = np.where((lab0[i] >= 64) & ig0, 0.0, 1.0)
        det_w1[i] = np.where((lab1[i] >= 64) & ig1, 0.0, 1.0)
    return im0, im1, lab0, lab1, warped_centers, valid1, det_w0, det_w1


def detector_loss(det_logits, labels, cell_valid, pos_weight=2.0):
    """(B, Hc, Wc, 65) logits vs (B, Hc, Wc) labels; corner cells get a
    modest extra weight (the labels are dustbin-heavy)."""
    logp = torch.log_softmax(det_logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.where(labels < 64, pos_weight, 1.0) * cell_valid
    return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1.0)


def descriptor_loss(desc0, desc1, labels0, warped_centers, valid1,
                    temp=0.1):
    """InfoNCE with the corner cells of view 0 as anchors: the positive
    is the view-1 cell whose center is nearest the warped anchor center;
    other cells within 8 px of it are near-duplicates and left out of
    the negatives. desc*: (B, Hc, Wc, D) unit descriptors."""
    B, Hc, Wc, D = desc0.shape
    C = Hc * Wc
    d0 = desc0.reshape(B, C, D)
    d1 = desc1.reshape(B, C, D)
    sim = torch.einsum("bid,bjd->bij", d0, d1) / temp       # (B, C, C)
    cy, cx = torch.meshgrid(torch.arange(Hc, device=desc0.device),
                            torch.arange(Wc, device=desc0.device),
                            indexing="ij")
    centers1 = torch.stack([cx.reshape(-1) * 8 + 4, cy.reshape(-1) * 8 + 4],
                           dim=1).to(torch.float32)         # (C, 2)
    dist = torch.linalg.vector_norm(
        warped_centers[:, :, None, :] - centers1[None, None, :, :],
        dim=-1)                                             # (B, C, C)
    d_min, j_star = torch.min(dist, dim=2)                  # (B, C)
    v1 = valid1.reshape(B, C)
    is_pos = F.one_hot(j_star, C).to(torch.bool)            # (B, C, C)
    # anchor usable: a corner cell whose warp target is a valid,
    # nearby view-1 cell
    corner0 = labels0.reshape(B, C) < 64
    pos_ok = corner0 & (d_min <= 6.0) & (torch.gather(v1, 1, j_star) > 0)
    # denominator: the positive + every valid cell farther than 8 px
    keep = is_pos | ((dist > 8.0) & (v1[:, None, :] > 0))
    logits = torch.where(keep, sim, torch.full_like(sim, -1e9))
    ll = torch.gather(sim, 2, j_star[:, :, None])[..., 0] - \
        torch.logsumexp(logits, dim=2)
    w = pos_ok.to(torch.float32)
    return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1.0)


def build_train_step(model, lr, steps, desc_weight=1.0):
    """(optimizer, train_step): train_step(batch) takes `_batch`'s host
    arrays, takes one Adam step of `model`'s parameters on their device
    and returns (loss, detector loss, descriptor loss) as tensors. The
    gradients of the step stay in the parameters' .grad."""
    opt = CosineAdam(model.parameters(), lr, steps, alpha=0.1)
    device = parameters_on(model)

    def train_step(batch):
        im0, im1, lab0, lab1, wc, v1, dw0, dw1 = batch_to(batch, device)
        opt.zero_grad()
        det0, desc0 = model(im0)
        det1, desc1 = model(im1)
        ld = detector_loss(det0, lab0, dw0) + \
            detector_loss(det1, lab1, v1 * dw1)
        ldesc = descriptor_loss(desc0, desc1, lab0, wc, v1)
        loss = ld + desc_weight * ldesc
        loss.backward()
        opt.step()
        return loss.detach(), ld.detach(), ldesc.detach()

    return opt, train_step


def save_params(model, path):
    """The model's weights in the reference's flat layout at `path`."""
    save_flat(flat_variables(model, "superpoint"), path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--desc-weight", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--init-from", default="",
                    help="warm-start from an existing .npz checkpoint")
    ap.add_argument("--background", default="gradient",
                    choices=["gradient", "black", "texture", "photo",
                             "mixed"],
                    help="background distribution ('mixed' adds black/"
                         "texture/real-photo canvases to the gradient)")
    ap.add_argument("--real-mix", type=float, default=0.0,
                    help="fraction of each batch drawn from homographic-"
                         "adaptation pseudo-labeled real images")
    ap.add_argument("--real-warps", type=int, default=48,
                    help="homography warps aggregated per pseudo-label")
    ap.add_argument("--out", default=default_out("superpoint_synth.npz"))
    return ap.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))
    return 0


def train(args, log=print):
    """main's training run; returns (model, per-step losses, device ms
    per step, host batch ms per step)."""
    device = resolve_device("cpu" if args.cpu else None)
    model = SuperPointNet(dtype=torch.float32)
    rng = np.random.default_rng(args.seed)
    flax_init_(model, args.seed)
    if args.init_from:
        load_flat_weights(model, convert.superpoint_state_dict(
            convert.load_flat(args.init_from)))
        log("warm-started from", args.init_from, flush=True)
    model.to(device).train()
    real_ds = None
    if args.real_mix > 0:
        from cslam_tpu_torch.models.homographic_adaptation import \
            RealPseudoDataset, apply_superpoint
        log("building homographic-adaptation pseudo-labels "
            f"({args.real_warps} warps/image)...", flush=True)
        real_ds = RealPseudoDataset(apply_superpoint, model, rng=rng,
                                    n_warps=args.real_warps)
        log("pseudo-corner counts per source image:",
            real_ds.corner_counts(), flush=True)
    _, train_step = build_train_step(model, args.lr, args.steps,
                                     desc_weight=args.desc_weight)
    losses, step_ms, batch_ms = [], [], []
    t0 = time.time()
    for step in range(args.steps):
        tb = time.perf_counter()
        batch = _batch(rng, args.batch, args.height, args.width,
                       background=args.background, real_ds=real_ds,
                       real_mix=args.real_mix)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        with StepTimer(device, step_ms):
            loss, ld, ldesc = train_step(batch)
        losses.append(float(loss))
        if step % 50 == 0 or step == args.steps - 1:
            log(f"step {step} loss {float(loss):.4f} det "
                f"{float(ld):.4f} desc {float(ldesc):.4f} "
                f"({time.time() - t0:.0f}s)", flush=True)
    save_params(model, args.out)
    log("saved", args.out, flush=True)
    return model, losses, step_ms, batch_ms


if __name__ == "__main__":
    sys.exit(main())
