"""Plain reference of the learned visual front end's three networks.

SuperPoint (DeTone, Malisiewicz and Rabinovich, CVPRW 2018,
arXiv:1712.07629), LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV
2023, arXiv:2306.13643; the cvg/LightGlue `superpoint_lightglue`
topology) and CosPlace (Berton, Masone and Caputo, CVPR 2022,
arXiv:2204.02287; ResNet-18, GeM, a linear head), written from the
published descriptions as plain `torch` functions over a state dict (the
published models' key names and shapes, which the port's modules also
use).

The weights reach it on their own path: `superpoint_weights` and
`cosplace_weights` read the shipped Flax files (`superpoint_synth.npz`,
`cosplace_synth.npz`) with this module's own key mapping, and
`lightglue_shapes` lists the published LightGlue's keys and shapes for
a caller that draws random weights and hands the same arrays to the
program under test and to this module.

Everything is float32 with both TF32 switches off (`full_precision`):
no kernels, no caches, no batching, no padding. This module imports
nothing but `math`, `numpy` (to read the files) and `torch`, so it can
judge a program that runs the networks in another precision or with
other kernels.

Departures from the published models, each the port's rule:
- SuperPoint: keypoints are not removed within 4 pixels of the border;
  a keypoint's descriptor is the descriptor map's cell under it
  (nearest cell, renormalized), not bilinearly interpolated; the
  heatmap covers the image's floored multiple of 8 in each axis.
- LightGlue: no adaptive depth or width (no early exit, no point
  pruning): every layer runs, as the fork's ONNX/TensorRT path runs
  them; only the last layer's assignment head exists. Padded keypoint
  slots are left out: the network runs on the valid keypoints alone and
  the scores of a pair with a padded side are -inf. The dustbin row and
  column of the assignment (log sigmoid(-z)) are not returned.
- CosPlace: the image is center-cropped to a square and resized by
  picking pixel floor(i (side - 1) / (crop - 1)), grey broadcast to
  three channels, ImageNet-normalized; BatchNorm uses its running
  statistics with epsilon 1e-5.

`conv_round` / `product_round` put a rounding of every product's inputs
in (e.g. `round_e4m3`, `round_tf32`), for a control that computes one
precision below the program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

SUPERPOINT_ENCODER = (("conv1a", "conv1b"), ("conv2a", "conv2b"),
                      ("conv3a", "conv3b"), ("conv4a", "conv4b"))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- weights ------------------------------------------------------------------

def _flat(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32))
                for k in z.files}


def _oihw(kernel):
    """A Flax convolution kernel (kh, kw, in, out) in torch's layout
    (out, in, kh, kw)."""
    return kernel.permute(3, 2, 0, 1).contiguous()


def superpoint_weights(path):
    """The state of `superpoint` from a Flax SuperPoint file: its twelve
    convolutions `params/Conv_i` in the order the network makes them,
    the encoder's eight, then the detector head's two, then the
    descriptor head's two."""
    flat = _flat(path)
    names = [n for pair in SUPERPOINT_ENCODER for n in pair] + [
        "convPa", "convPb", "convDa", "convDb"]
    state = {}
    for i, name in enumerate(names):
        state[name + ".weight"] = _oihw(flat[f"params/Conv_{i}/kernel"])
        state[name + ".bias"] = flat[f"params/Conv_{i}/bias"]
    return state


def cosplace_weights(path):
    """The state of `cosplace` from a Flax CosPlace file: the ResNet-18
    stem (`Conv_0`, `BatchNorm_0`), its eight `BasicBlock_i` (two a stage;
    in each `Conv_0`/`BatchNorm_0` then `Conv_1`/`BatchNorm_1` on the main
    path and `Conv_2`/`BatchNorm_2` on a strided shortcut), running
    statistics under `batch_stats`, GeM's p and the dense head."""
    flat = _flat(path)
    par, stats = "params/ResNet18Backbone_0", "batch_stats/ResNet18Backbone_0"
    state = {}

    def conv(src, dst):
        state[dst + ".weight"] = _oihw(flat[f"{par}/{src}/kernel"])

    def norm(src, dst):
        state[dst + ".weight"] = flat[f"{par}/{src}/scale"]
        state[dst + ".bias"] = flat[f"{par}/{src}/bias"]
        state[dst + ".running_mean"] = flat[f"{stats}/{src}/mean"]
        state[dst + ".running_var"] = flat[f"{stats}/{src}/var"]

    conv("Conv_0", "backbone.conv1")
    norm("BatchNorm_0", "backbone.bn1")
    for i in range(8):
        src, dst = f"BasicBlock_{i}", f"backbone.layer{i // 2 + 1}.{i % 2}"
        conv(src + "/Conv_0", dst + ".conv1")
        norm(src + "/BatchNorm_0", dst + ".bn1")
        conv(src + "/Conv_1", dst + ".conv2")
        norm(src + "/BatchNorm_1", dst + ".bn2")
        if f"{par}/{src}/Conv_2/kernel" in flat:
            conv(src + "/Conv_2", dst + ".downsample.0")
            norm(src + "/BatchNorm_2", dst + ".downsample.1")
    state["aggregation.1.p"] = flat["params/GeM_0/p"]
    state["aggregation.3.weight"] = flat["params/Dense_0/kernel"].T
    state["aggregation.3.bias"] = flat["params/Dense_0/bias"]
    return state


def lightglue_shapes(dim, num_layers, num_heads):
    """{key: shape} of the published superpoint_lightglue model's state
    (descriptors already `dim` wide, so no input projection; only the
    last layer's assignment head), in torch's (out, in) layout."""
    shapes = {"posenc.Wr.weight": (dim // num_heads // 2, 2)}

    def linear(name, n_out, n_in):
        shapes[name + ".weight"] = (n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    def ffn(name):
        linear(name + ".0", 2 * dim, 2 * dim)
        shapes[name + ".1.weight"] = (2 * dim,)     # LayerNorm
        shapes[name + ".1.bias"] = (2 * dim,)
        linear(name + ".3", dim, 2 * dim)

    for i in range(num_layers):
        layer = f"transformers.{i}"
        linear(layer + ".self_attn.Wqkv", 3 * dim, dim)
        linear(layer + ".self_attn.out_proj", dim, dim)
        ffn(layer + ".self_attn.ffn")
        for name in ("to_qk", "to_v", "to_out"):
            linear(f"{layer}.cross_attn.{name}", dim, dim)
        ffn(layer + ".cross_attn.ffn")
    head = f"log_assignment.{num_layers - 1}"
    linear(head + ".matchability", 1, dim)
    linear(head + ".final_proj", dim, dim)
    return shapes


def full_precision():
    """Float32 products and convolutions at full precision on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _same(x):
    return x


def round_tf32(x):
    """x rounded to TF32's 10 mantissa bits (nearest, ties to even), as
    float32: what a TF32 product reads of its inputs."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_e4m3(x):
    """x rounded to fp8 e4m3 (saturated at +-448), as float32."""
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).to(
        torch.float32)


def _conv(x, state, name, padding, stride=1, rnd=_same):
    w = state[name + ".weight"]
    b = state.get(name + ".bias")
    return F.conv2d(rnd(x), rnd(w), b, stride=stride, padding=padding)


def _linear(x, state, name, rnd=_same):
    return F.linear(rnd(x), rnd(state[name + ".weight"]),
                    state.get(name + ".bias"))


# -- SuperPoint ---------------------------------------------------------------

def superpoint(state, image, conv_round=None):
    """(heat (8 floor(H/8), 8 floor(W/8)) keypoint probabilities, desc
    (floor(H/8), floor(W/8), D) unit descriptors) of one (H, W) grey
    image in [0, 1]. `conv_round` rounds the inputs of the 3x3
    convolutions; the two 1x1 heads stay float32."""
    rnd = conv_round or _same
    x = image.to(torch.float32)[None, None]
    for i, (a, b) in enumerate(SUPERPOINT_ENCODER):
        x = F.relu(_conv(x, state, a, 1, rnd=rnd))
        x = F.relu(_conv(x, state, b, 1, rnd=rnd))
        if i < len(SUPERPOINT_ENCODER) - 1:
            x = F.max_pool2d(x, 2, 2)
    semi = _conv(F.relu(_conv(x, state, "convPa", 1, rnd=rnd)), state,
                 "convPb", 0)
    prob = torch.softmax(semi[0], dim=0)[:64]        # dustbin dropped
    hc, wc = prob.shape[1:]
    heat = prob.reshape(8, 8, hc, wc).permute(2, 0, 3, 1).reshape(
        hc * 8, wc * 8)
    desc = _conv(F.relu(_conv(x, state, "convDa", 1, rnd=rnd)), state,
                 "convDb", 0)[0]
    desc = desc / torch.linalg.vector_norm(desc, dim=0, keepdim=True)
    return heat, desc.permute(1, 2, 0)


def nms_pool(heat, radius):
    """The largest heat within `radius` pixels (a square window)."""
    return F.max_pool2d(heat[None, None], 2 * radius + 1, stride=1,
                        padding=radius)[0, 0]


def keypoints(heat, desc, max_keypoints, radius=4, threshold=0.005):
    """(xy (n, 2) pixels, scores (n,), descriptors (n, D)) of the
    heatmap's local maxima above `threshold`, at most `max_keypoints`,
    the highest first; each descriptor from the cell under it."""
    keep = (heat >= nms_pool(heat, radius)) & (heat > threshold)
    ys, xs = torch.nonzero(keep, as_tuple=True)
    scores = heat[ys, xs]
    order = torch.argsort(scores, descending=True)[:max_keypoints]
    ys, xs, scores = ys[order], xs[order], scores[order]
    d = desc[ys // 8, xs // 8]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return torch.stack([xs, ys], dim=1).to(torch.float32), scores, d


# -- LightGlue ----------------------------------------------------------------

def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _ffn(state, name, x, msg, rnd):
    h = _linear(torch.cat([x, msg], dim=-1), state, name + ".0", rnd)
    h = F.layer_norm(h, h.shape[-1:], state[name + ".1.weight"],
                     state[name + ".1.bias"], eps=1e-5)
    return x + _linear(F.gelu(h), state, name + ".3", rnd)


def _self_block(state, name, x, cos, sin, heads, rnd):
    k, d = x.shape
    qkv = _linear(x, state, name + ".Wqkv", rnd).reshape(k, heads,
                                                         d // heads, 3)
    q, kk, v = (qkv[..., i].transpose(0, 1) for i in range(3))
    q = q * cos + _rotate_half(q) * sin              # (heads, k, hd)
    kk = kk * cos + _rotate_half(kk) * sin
    attn = torch.softmax(rnd(q) @ rnd(kk).transpose(1, 2)
                         / math.sqrt(d // heads), dim=-1)
    ctx = (rnd(attn) @ rnd(v)).transpose(0, 1).reshape(k, d)
    return _ffn(state, name + ".ffn", x,
                _linear(ctx, state, name + ".out_proj", rnd), rnd)


def _cross_block(state, name, x0, x1, heads, rnd):
    d = x0.shape[1]
    hd = d // heads

    def split(t):
        return t.reshape(t.shape[0], heads, hd).transpose(0, 1)

    qk0 = split(_linear(x0, state, name + ".to_qk", rnd))
    qk1 = split(_linear(x1, state, name + ".to_qk", rnd))
    v0 = split(_linear(x0, state, name + ".to_v", rnd))
    v1 = split(_linear(x1, state, name + ".to_v", rnd))
    sim = rnd(qk0) @ rnd(qk1).transpose(1, 2) / math.sqrt(hd)
    m0 = rnd(torch.softmax(sim, dim=-1)) @ rnd(v1)
    m1 = rnd(torch.softmax(sim.transpose(1, 2), dim=-1)) @ rnd(v0)
    m0 = _linear(m0.transpose(0, 1).reshape(-1, d), state, name + ".to_out",
                 rnd)
    m1 = _linear(m1.transpose(0, 1).reshape(-1, d), state, name + ".to_out",
                 rnd)
    return (_ffn(state, name + ".ffn", x0, m0, rnd),
            _ffn(state, name + ".ffn", x1, m1, rnd))


def lightglue(state, desc0, xy0, m0, desc1, xy1, m1, size, num_layers,
              num_heads=4, product_round=None):
    """Log-assignment scores (K0, K1) of two keypoint sets: descriptors
    (K, D), pixel coordinates (K, 2), validity (K,) and the image size
    (W, H) that normalizes the coordinates. -inf where either side is
    not valid. `product_round` rounds the inputs of every product."""
    rnd = product_round or _same
    size = torch.as_tensor(size, dtype=torch.float32, device=desc0.device)
    v0, v1 = m0 > 0, m1 > 0
    x0, x1 = desc0[v0].float(), desc1[v1].float()
    enc = []
    for xy in (xy0[v0], xy1[v1]):
        xy = (xy.float() - size / 2) / (torch.max(size) / 2)
        proj = F.linear(rnd(xy), rnd(state["posenc.Wr.weight"]))
        enc.append((torch.cos(proj).repeat_interleave(2, dim=-1)[None],
                    torch.sin(proj).repeat_interleave(2, dim=-1)[None]))
    for i in range(num_layers):
        name = f"transformers.{i}"
        x0 = _self_block(state, name + ".self_attn", x0, *enc[0],
                         num_heads, rnd)
        x1 = _self_block(state, name + ".self_attn", x1, *enc[1],
                         num_heads, rnd)
        x0, x1 = _cross_block(state, name + ".cross_attn", x0, x1,
                              num_heads, rnd)
    head = f"log_assignment.{num_layers - 1}"
    scale = x0.shape[1] ** 0.25
    md0 = _linear(x0, state, head + ".final_proj", rnd) / scale
    md1 = _linear(x1, state, head + ".final_proj", rnd) / scale
    sim = rnd(md0) @ rnd(md1).T
    z0 = _linear(x0, state, head + ".matchability", rnd)[:, 0]
    z1 = _linear(x1, state, head + ".matchability", rnd)[:, 0]
    valid_scores = (torch.log_softmax(sim, dim=1)
                    + torch.log_softmax(sim, dim=0)
                    + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None])
    out = torch.full((len(m0), len(m1)), -torch.inf, device=desc0.device)
    idx0 = torch.nonzero(v0)[:, 0]
    idx1 = torch.nonzero(v1)[:, 0]
    out[idx0[:, None], idx1[None, :]] = valid_scores
    return out


# -- CosPlace -----------------------------------------------------------------

def cosplace_input(images, crop):
    """(B, crop, crop, 3) float32 network input of (B, H, W) or
    (B, H, W, C) uint8 images."""
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
    return (x - mean) / std


def _batch_norm(x, state, name):
    scale = state[name + ".weight"] * torch.rsqrt(
        state[name + ".running_var"] + 1e-5)
    return (x - state[name + ".running_mean"][:, None, None]) * \
        scale[:, None, None] + state[name + ".bias"][:, None, None]


def _basic_block(x, state, name, stride, rnd):
    y = F.relu(_batch_norm(_conv(x, state, name + ".conv1", 1, stride, rnd),
                           state, name + ".bn1"))
    y = _batch_norm(_conv(y, state, name + ".conv2", 1, 1, rnd), state,
                    name + ".bn2")
    if name + ".downsample.0.weight" in state:
        x = _batch_norm(_conv(x, state, name + ".downsample.0", 0, stride,
                              rnd), state, name + ".downsample.1")
    return F.relu(y + x)


def cosplace(state, images, crop, conv_round=None):
    """(B, D) unit descriptors of (B, H, W[, C]) uint8 images.
    `conv_round` rounds the inputs of every convolution."""
    rnd = conv_round or _same
    x = cosplace_input(images, crop).permute(0, 3, 1, 2)
    x = F.relu(_batch_norm(_conv(x, state, "backbone.conv1", 3, 2, rnd),
                           state, "backbone.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in range(1, 5):
        for block in range(2):
            stride = 2 if (stage > 1 and block == 0) else 1
            x = _basic_block(x, state, f"backbone.layer{stage}.{block}",
                             stride, rnd)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    p = state["aggregation.1.p"]
    x = torch.mean(torch.clamp(x, min=1e-6) ** p, dim=(2, 3)) ** (1.0 / p)
    x = _linear(x, state, "aggregation.3")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
