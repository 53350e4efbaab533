"""Plain reference of NetVLAD with its projection.

NetVLAD (Arandjelovic, Gronat, Torii, Pajdla and Sivic, CVPR 2016,
arXiv:1511.07247): VGG-16 cut at conv5_3 (512 channels), soft-assignment
VLAD pooling over K clusters (K = 64 gives a 32,768-d vector), then a
linear projection to the published 4,096-d descriptor. Written from the
paper as plain `torch` functions over a state dict in the published
PyTorch port's key names (`encoder.<i>` at torchvision's VGG-16
`features` indices, `pool.centroids`, `pool.conv.weight`), which the
program's module also uses.

The weights reach it on their own path: `netvlad_weights` reads the
shipped Flax file (`netvlad_synth.npz`) with this module's own key
mapping, and the projection (`mean`, `components`) is handed to
`descriptors` as arrays by the caller, which drew them.

Everything is float32 with both TF32 switches off (`full_precision`,
called by `descriptors`): no kernels, no caches, no padding; images go
through in blocks of `BLOCK` so that a batch fits on a card. This module
imports nothing but `numpy` (to read the file) and `torch`, so it can
judge a program that runs the network in another precision or with
other kernels.

Departures from the paper, each the program's rule:
- the input is the grey image center-cropped to a square and resized by
  picking pixel floor(i (side - 1) / (crop - 1)), broadcast to three
  channels and ImageNet-normalized (the paper feeds the whole image);
- the 2x2 max pools floor odd sizes (VALID);
- the local descriptors are L2-normalized over channels before the
  assignment, and the 1x1 assignment convolution has no bias (the
  published PyTorch port's default; the paper's assignment has b_k);
- the projection is `(v - mean) @ components.T` then L2, with the
  caller's components: no whitening is applied beyond what they hold.

`conv_round` rounds the inputs and weights of every convolution (e.g. to
fp8 e4m3), `product_round` those of the projection (e.g. to TF32), for a
control one precision below the program.
"""

import numpy as np
import torch
import torch.nn.functional as F

# torchvision's VGG-16 `features` layout through conv5_3 ("M": 2x2 pool)
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# images a forward takes at once
BLOCK = 16


def conv_indices():
    """torchvision's `features` index of each of the 13 convolutions."""
    out, i = [], 0
    for c in VGG16:
        if c == "M":
            i += 1
        else:
            out.append(i)
            i += 2          # the convolution and its ReLU
    return out


def netvlad_weights(path):
    """The state of `vlad_vectors` from a Flax NetVLAD file: the 13
    convolutions `params/VGG16Conv5_0/Conv_i` (kernel (kh, kw, in, out),
    bias) in the network's order, the centroids (K, 512) and the 1x1
    assignment kernel (1, 1, 512, K) of `params/NetVLADLayer_0`."""
    with np.load(path) as z:
        flat = {k: torch.from_numpy(np.array(z[k], np.float32))
                for k in z.files}
    state = {}
    for i, idx in enumerate(conv_indices()):
        src = f"params/VGG16Conv5_0/Conv_{i}"
        state[f"encoder.{idx}.weight"] = flat[src + "/kernel"].permute(
            3, 2, 0, 1).contiguous()
        state[f"encoder.{idx}.bias"] = flat[src + "/bias"]
    layer = "params/NetVLADLayer_0"
    state["pool.centroids"] = flat[layer + "/centroids"]
    state["pool.conv.weight"] = flat[layer + "/assign_conv/kernel"].permute(
        3, 2, 0, 1).contiguous()
    return state


def full_precision():
    """Float32 products and convolutions at full precision on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _same(x):
    return x


def network_input(images, crop):
    """(B, 3, crop, crop) float32 of (B, H, W) or (B, H, W, C) uint8
    images."""
    x = images.to(torch.float32)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    h, w = x.shape[1:3]
    side = min(h, w)
    y0, x0 = (h - side) // 2, (w - side) // 2
    x = x[:, y0:y0 + side, x0:x0 + side]
    pick = torch.arange(crop, device=x.device) * (side - 1) // max(crop - 1,
                                                                   1)
    x = x[:, pick][:, :, pick] / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def vgg16_conv5(state, x, conv_round=None):
    """(B, 512, h, w) conv5_3 map of a (B, 3, H, W) input: 3x3
    convolutions with padding 1, a ReLU after each but the last, 2x2
    max pools."""
    rnd = conv_round or _same
    idx = conv_indices()
    convs = 0
    for c in VGG16:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        name = f"encoder.{idx[convs]}"
        x = F.conv2d(rnd(x), rnd(state[name + ".weight"]),
                     state[name + ".bias"], padding=1)
        convs += 1
        if convs < len(idx):
            x = F.relu(x)
    return x


def vlad(state, feats):
    """(B, K * C) unit VLAD vectors of a (B, C, h, w) map, cluster-major:
    per cluster k the sum over positions p of a_k(p) (x_p - c_k), with
    a = softmax over clusters of the 1x1 assignment of the L2-normalized
    x; each cluster's residual L2-normalized, then the whole."""
    B, C, h, w = feats.shape
    x = feats / torch.clamp(torch.linalg.vector_norm(feats, dim=1,
                                                     keepdim=True), min=1e-12)
    a = torch.softmax(F.conv2d(x, state["pool.conv.weight"]).reshape(
        B, -1, h * w), dim=1)                                  # (B, K, P)
    x = x.reshape(B, C, h * w)
    v = torch.bmm(a, x.transpose(1, 2)) - a.sum(dim=2)[..., None] * \
        state["pool.centroids"][None]                          # (B, K, C)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=2, keepdim=True),
                        min=1e-12)
    v = v.reshape(B, -1)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                           min=1e-12)


def vlad_vectors(state, images, crop, conv_round=None):
    """(B, K * 512) VLAD vectors of (B, H, W[, C]) uint8 images, in
    blocks of BLOCK images."""
    out = []
    for lo in range(0, len(images), BLOCK):
        x = network_input(images[lo:lo + BLOCK], crop)
        out.append(vlad(state, vgg16_conv5(state, x, conv_round)))
    return torch.cat(out)


def project(v, mean, components, product_round=None):
    """(B, D) unit descriptors: (v - mean) @ components.T, L2-normalized."""
    rnd = product_round or _same
    y = rnd(v - mean[None]) @ rnd(components).T
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True),
                           min=1e-12)


def descriptors(state, images, crop, mean, components, conv_round=None,
                product_round=None):
    """(B, D) published descriptors of (B, H, W[, C]) uint8 images, with
    the projection (mean (K * 512,), components (D, K * 512)) as tensors
    on the images' device."""
    full_precision()
    return project(vlad_vectors(state, images, crop, conv_round), mean,
                   components, product_round)
