"""Self-training of the LightGlue matcher on synthetic correspondence
problems.

Port of cslam_tpu/models/train_lightglue.py:

- `make_match_batch` (numpy; the synthetic matching problems the shipped
  lightglue_synth.npz was trained on, with the same RNG draws in the
  same order, so one seed gives both packages the same batch): two views
  share n_inlier true points, each view sees a noisy copy of the point's
  unit descriptor plus independent outliers, view-1 keypoints are
  view-0's through a random homography;
- `build_real_match_pool` / `sample_pool_batch`: real-patch homography
  pairs featurized by a SuperPoint (the deployed descriptor
  distribution);
- `build_train_step`: the official LightGlue loss, the NLL of the
  ground-truth assignment under the sigmoid-log-double-softmax scores
  plus matchability BCE on unmatched points, averaged over the pairs of
  a batch (the reference's vmap over pairs is the model's batch
  dimension here); Adam under optax's cosine-decay schedule
  (models/training.py), f32 at full precision;
- `eval_matching`: precision/recall of mutual-argmax matches against
  raw-descriptor mutual matching.

Run (on the card; `--cpu` for the CPU):

    python -m cslam_tpu_torch.models.train_lightglue \
        --steps 1200 --batch 16 --layers 3

The output (default `cslam_tpu_torch/_build/weights/
lightglue_synth.npz`) loads in either package with LightGlue(checkpoint=
<path>, num_layers=3).
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
from cslam_tpu_torch.models.lightglue import LightGlueNet, \
    normalize_keypoints
from cslam_tpu_torch.models.synthetic_shapes import apply_homography, \
    random_homography, warp_image
from cslam_tpu_torch.models.training import CosineAdam, StepTimer, \
    batch_to, default_out, flat_variables, parameters_on, save_flat


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


def build_real_match_pool(superpoint, rng, n_pairs=256, K=96, H=120,
                          W=160, match_px=3.0):
    """Real-patch homography matching problems: crops of the offline real
    photographs and their homography warps, featurized by `superpoint`
    (the port's SuperPoint wrapper, on its device). Ground-truth matches
    are mutual nearest under the homography within match_px.

    Returns a tuple of stacked arrays in make_match_batch's layout, to
    be sampled as training batches."""
    from cslam_tpu_torch.models.homographic_adaptation import \
        default_source_images
    images = [im for im in default_source_images()
              if im.shape[0] >= H + 8 and im.shape[1] >= W + 8]
    out = {k: [] for k in ("d0", "p0", "m0", "d1", "p1", "m1", "gt",
                           "mt0", "mt1")}
    while len(out["d0"]) < n_pairs:
        img = images[int(rng.integers(len(images)))]
        y0 = int(rng.integers(0, img.shape[0] - H + 1))
        x0 = int(rng.integers(0, img.shape[1] - W + 1))
        crop = np.ascontiguousarray(img[y0:y0 + H, x0:x0 + W])
        crop = np.clip(crop * rng.uniform(0.85, 1.15) +
                       rng.uniform(-0.06, 0.06), 0, 1).astype(np.float32)
        Hm = random_homography(rng, H, W)
        warped, _ = warp_image(crop, Hm)
        warped = np.clip(warped * rng.uniform(0.8, 1.2) +
                         rng.uniform(-0.08, 0.08) +
                         0.02 * rng.standard_normal((H, W)),
                         0, 1).astype(np.float32)
        xy0, d0, _, m0 = (a.cpu().numpy() for a in
                          superpoint.extract_features(crop,
                                                      max_keypoints=K))
        xy1, d1, _, m1 = (a.cpu().numpy() for a in
                          superpoint.extract_features(warped,
                                                      max_keypoints=K))
        if m0.sum() < K // 4 or m1.sum() < K // 4:
            continue
        w0 = apply_homography(Hm, xy0)
        dist = np.linalg.norm(w0[:, None] - xy1[None], axis=-1)
        dist = np.where((m0[:, None] > 0) & (m1[None] > 0), dist, np.inf)
        nn1 = dist.argmin(1)
        nn0 = dist.argmin(0)
        gt = np.full(K, -1, np.int32)
        for i in range(K):
            j = nn1[i]
            if dist[i, j] < match_px and nn0[j] == i:
                gt[i] = j
        if (gt >= 0).sum() < 8:
            continue
        mt0 = (gt >= 0).astype(np.float32)
        mt1 = np.zeros(K, np.float32)
        mt1[gt[gt >= 0]] = 1.0
        for k, v in zip(("d0", "p0", "m0", "d1", "p1", "m1", "gt",
                         "mt0", "mt1"),
                        (d0, xy0, m0, d1, xy1, m1, gt, mt0, mt1)):
            out[k].append(v)
    return tuple(np.stack(out[k]) for k in
                 ("d0", "p0", "m0", "d1", "p1", "m1", "gt", "mt0",
                  "mt1"))


def sample_pool_batch(pool, rng, batch):
    idx = rng.integers(0, len(pool[0]), size=batch)
    return tuple(arr[idx] for arr in pool)


def pair_losses(model, d0, p0, m0, d1, p1, m1, gt, mt0, mt1, size):
    """(B,) loss of each pair: the NLL of its ground-truth matches plus
    half the matchability BCE of its unmatched points."""
    scores, z0, z1 = model(d0, normalize_keypoints(p0, size), m0,
                           d1, normalize_keypoints(p1, size), m1,
                           with_aux=True)
    gt_safe = torch.clamp(gt, min=0)
    ll = torch.gather(scores, -1, gt_safe[..., None])[..., 0]
    n_pos = torch.clamp(torch.sum(mt0, dim=-1), min=1.0)
    loss_pos = -torch.sum(ll * mt0, dim=-1) / n_pos
    # matchability BCE on unmatched points: want sigmoid(z) -> 0
    un0 = (1.0 - mt0) * m0
    un1 = (1.0 - mt1) * m1
    loss_un = -(torch.sum(F.logsigmoid(-z0) * un0, dim=-1) +
                torch.sum(F.logsigmoid(-z1) * un1, dim=-1)) / \
        torch.clamp(torch.sum(un0, dim=-1) + torch.sum(un1, dim=-1),
                    min=1.0)
    return loss_pos + 0.5 * loss_un


def build_train_step(model, lr, steps, H=120, W=160):
    """(optimizer, train_step): train_step(batch) takes make_match_batch's
    host arrays, takes one Adam step of `model`'s parameters on their
    device and returns the batch's mean loss as a tensor. The gradients
    of the step stay in the parameters' .grad."""
    opt = CosineAdam(model.parameters(), lr, steps, alpha=0.1)
    device = parameters_on(model)
    size = torch.tensor([W, H], dtype=torch.float32, device=device)

    def train_step(batch):
        opt.zero_grad()
        loss = torch.mean(pair_losses(model, *batch_to(batch, device),
                                      size))
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, train_step


def save_params(model, path):
    """The model's weights in the reference's flat layout at `path`."""
    save_flat(flat_variables(model, "lightglue", model.num_layers), path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--keypoints", type=int, default=96)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--init-from", default="",
                    help="warm-start from an existing .npz checkpoint")
    ap.add_argument("--noise-lo", type=float, default=0.4)
    ap.add_argument("--noise-hi", type=float, default=0.95)
    ap.add_argument("--real-mix", type=float, default=0.0,
                    help="fraction of batches drawn from the real-patch "
                         "SuperPoint pair pool")
    ap.add_argument("--real-pairs", type=int, default=256,
                    help="pool size of precomputed real pairs")
    ap.add_argument("--superpoint", default="",
                    help="SuperPoint checkpoint used to featurize the "
                         "real pairs (default: shipped)")
    ap.add_argument("--out", default=default_out("lightglue_synth.npz"))
    return ap.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))
    return 0


def train(args, log=print):
    """main's training run; returns (model, per-step losses, device ms
    per step, host batch ms per step)."""
    device = resolve_device("cpu" if args.cpu else None)
    model = LightGlueNet(num_layers=args.layers)
    rng = np.random.default_rng(args.seed)
    K = args.keypoints
    flax_init_(model, args.seed)
    if args.init_from:
        load_flat_weights(model, convert.lightglue_state_dict(
            convert.load_flat(args.init_from), args.layers))
        log("warm-started from", args.init_from, flush=True)
    model.to(device).train()
    pool = None
    if args.real_mix > 0:
        from cslam_tpu_torch.models import zoo
        from cslam_tpu_torch.models.superpoint import SuperPoint
        sp_ckpt = args.superpoint or \
            zoo.shipped_checkpoint("superpoint_synth.npz")
        sp = SuperPoint(checkpoint=sp_ckpt, max_keypoints=K, device=device)
        log(f"building {args.real_pairs} real SuperPoint pairs from "
            f"{sp_ckpt}...", flush=True)
        pool = build_real_match_pool(sp, rng, n_pairs=args.real_pairs,
                                     K=K)
        log(f"pool ready: mean matches/pair "
            f"{float(pool[7].sum(1).mean()):.1f}", flush=True)
    _, train_step = build_train_step(model, args.lr, args.steps)
    losses, step_ms, batch_ms = [], [], []
    t0 = time.time()
    for step in range(args.steps):
        tb = time.perf_counter()
        if pool is not None and rng.random() < args.real_mix:
            batch = sample_pool_batch(pool, rng, args.batch)
        else:
            batch = make_match_batch(rng, args.batch, K=K,
                                     noise_lo=args.noise_lo,
                                     noise_hi=args.noise_hi)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        with StepTimer(device, step_ms):
            loss = train_step(batch)
        losses.append(float(loss))
        if step % 50 == 0 or step == args.steps - 1:
            log(f"step {step} loss {float(loss):.4f} "
                f"({time.time() - t0:.0f}s)", flush=True)
        if step % 300 == 299 or step == args.steps - 1:
            for sig in (0.6, 0.85):
                ev = eval_matching(model, np.random.default_rng(1234),
                                   K=K, sigma=sig)
                log(f"  eval@sigma={sig}: "
                    f"lg P={ev['lightglue']['precision']:.3f} "
                    f"R={ev['lightglue']['recall']:.3f} | raw "
                    f"P={ev['raw']['precision']:.3f} "
                    f"R={ev['raw']['recall']:.3f}", flush=True)
    save_params(model, args.out)
    log("saved", args.out, flush=True)
    return model, losses, step_ms, batch_ms


if __name__ == "__main__":
    sys.exit(main())
