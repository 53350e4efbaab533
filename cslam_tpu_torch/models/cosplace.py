"""CosPlace-style global-descriptor CNN — the flagship visual
place-recognition model.

Port of cslam_tpu/models/cosplace.py: a ResNet-18 backbone -> L2Norm ->
GeM pooling -> Linear(fc_output_dim) -> L2Norm, written out as
`nn.Module`s (no torchvision), with the reference CosPlace's
state_dict names (`backbone.*`, `aggregation.{1,3}.*`) so that
`models/convert.py` maps the shipped weights both ways.

Precision follows the reference's Flax modules, cast for cast:
`nn.Conv(dtype=bfloat16)` casts its input and its f32 kernel to bf16
and returns bf16; `nn.BatchNorm(dtype=float32)` promotes back to f32,
so BatchNorm, ReLU, the residual add and the max pool run in f32, and
the head (L2Norm, GeM, Dense) is f32. `dtype=torch.float32` runs the
convs in f32 as well. Public functions keep the reference's NHWC
layout; inside, the NCHW view of an NHWC tensor is channels_last in
memory, which is what cuDNN's tensor-core convolutions want on the
card. Every forward on a CUDA tensor checks that no fp32 product or
convolution may run in TF32 (`device.require_full_fp32`).
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cslam_tpu_torch.device import DeviceLike, require_full_fp32, \
    resolve_device
from cslam_tpu_torch.models import convert, zoo
from cslam_tpu_torch.runtime.tracing import span, tracer

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def at_least_f32(x):
    """x in f32, or in f64 when it is f64: the reference's casts to f32
    promote bf16 and keep wider types (a float64 copy of a network, as
    chip_smoke's gradient check builds, stays float64)."""
    return x if x.dtype == torch.float64 else x.float()


class Conv(nn.Conv2d):
    """`nn.Conv2d` that computes in `dtype` like Flax's
    `nn.Conv(dtype=...)` with f32 params: input, kernel and bias are
    cast to `dtype`, the bias is added to the rounded product, and the
    output stays in `dtype`."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=False, dtype=torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.to(dt), w, None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) in f32 with Flax's formula
    and epsilon: (x - mean) * (scale * rsqrt(var + 1e-5)) + bias. Keys as
    torch's BatchNorm2d (weight, bias, running_mean, running_var).

    In eval mode mean and var are the running statistics. In train mode
    they are the batch's, as Flax's `nn.BatchNorm(use_running_average=
    False)` computes them: in f32, var = max(E[x^2] - E[x]^2, 0) (biased),
    and the running statistics move as `ra = momentum * ra + (1 -
    momentum) * batch` with Flax's momentum convention (0.9 keeps 90% of
    the old value; torch's BatchNorm2d keeps the unbiased variance with
    momentum 0.1 instead). Gradients flow through the batch statistics."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = at_least_f32(x)
        if self.training:
            mean = torch.mean(x, dim=(0, 2, 3))
            mean2 = torch.mean(x * x, dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class GeM(nn.Module):
    """Generalized-mean pooling with learnable exponent p over H, W of an
    (B, C, H, W) map; returns (B, C)."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.ones(1) * 3.0)

    def forward(self, x):
        x = torch.clamp(at_least_f32(x), min=self.eps) ** self.p
        x = torch.mean(x, dim=(2, 3))
        return x ** (1.0 / self.p)


class L2Norm(nn.Module):
    """x / max(||x||, 1e-12) over dim 1 (the channel axis)."""

    def forward(self, x):
        return l2_normalize(x, dim=1)


def l2_normalize(x, dim=-1, eps=1e-12):
    return F.normalize(x, p=2.0, dim=dim, eps=eps)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, strides: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(in_channels, channels, 3, strides, 1, dtype=dtype)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv(channels, channels, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(channels)
        self.downsample = None
        if in_channels != channels or strides != 1:
            # Flax's 'SAME' padding of a 1x1 kernel pads nothing
            self.downsample = nn.Sequential(
                Conv(in_channels, channels, 1, strides, 0, dtype=dtype),
                BatchNorm(channels))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18Backbone(nn.Module):
    """ResNet-18 feature extractor through conv5_x (512 channels)."""

    def __init__(self, dtype=torch.bfloat16,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes, widths)):
            layer = []
            for b in range(blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                layer.append(BasicBlock(in_ch, width, strides, dtype=dtype))
                in_ch = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.n_stages = len(widths)

    def forward(self, x):  # (B, 3, H, W)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as Flax
        for stage in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        return x


class GeoLocalizationNet(nn.Module):
    """backbone -> L2Norm -> GeM -> Linear(fc_output_dim) -> L2Norm.

    forward takes (B, H, W, 3) float images (NHWC, as the reference) and
    returns (B, fc_output_dim) f32 unit descriptors."""

    def __init__(self, fc_output_dim: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.backbone = ResNet18Backbone(dtype=dtype)
        self.aggregation = nn.Sequential(
            L2Norm(), GeM(), nn.Flatten(),
            nn.Linear(512, fc_output_dim), L2Norm())

    def forward(self, image):
        if image.is_cuda:
            require_full_fp32(image.device)
        x = self.backbone(image.permute(0, 3, 1, 2))
        return self.aggregation(at_least_f32(x))


def flax_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random init with Flax's default distributions (what the reference
    wrapper builds when its checkpoint is disabled): conv and dense
    kernels lecun-normal (truncated at 2 sigma, variance 1 / fan_in),
    biases 0, BatchNorm scale 1 / bias 0 / stats (0, 1), GeM p = 3,
    NetVLAD centroids uniform in [0, 1). Same seed, same weights on any
    device; the values differ from JAX's (another generator)."""
    gen = torch.Generator().manual_seed(int(seed))
    std_of_truncated = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / std_of_truncated
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GeM):
                m.p.fill_(3.0)
            elif hasattr(m, "centroids"):
                m.centroids.copy_(torch.rand(m.centroids.shape,
                                             generator=gen))
    return model


def load_flat_weights(model: nn.Module, state: dict) -> nn.Module:
    """Load a numpy state_dict (models/convert.py) into `model`, strictly:
    every key present, no key left over, shapes equal."""
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()}, strict=True)
    return model


def preprocess(images: np.ndarray, crop_size: int = 224) -> np.ndarray:
    """Center-crop to square, resize to crop_size, ImageNet-normalize.
    images: (B, H, W, 3) uint8 or float in [0, 255]. The resize picks
    pixels with the reference's host index map, np.linspace(...) cast
    to int32 (F.interpolate would pick others)."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    b, h, w, _ = images.shape
    side = min(h, w)
    y0 = (h - side) // 2
    x0 = (w - side) // 2
    images = images[:, y0:y0 + side, x0:x0 + side, :].astype(np.float32)
    idx_y = np.linspace(0, side - 1, crop_size).astype(np.int32)
    idx_x = np.linspace(0, side - 1, crop_size).astype(np.int32)
    images = images[:, idx_y][:, :, idx_x]
    images = images / 255.0
    return (images - IMAGENET_MEAN) / IMAGENET_STD


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A preprocessed batch as an f32 tensor on `device`. preprocess's
    output is dense but not C-ordered (numpy keeps the fancy-indexed
    layout); the tensor keeps those strides, so the host-to-device copy
    moves the block as it lies, with no strided copy on the host."""
    return torch.from_numpy(np.asarray(batch, np.float32)).to(device)


def embed(model: nn.Module, batch: np.ndarray,
          device: torch.device) -> np.ndarray:
    """One forward of `model` over a preprocessed (B, H, W, 3) batch on
    `device`; the descriptors as f32 numpy."""
    with torch.no_grad():
        return model(to_device(batch, device)).float().cpu().numpy()


class CosPlace:
    """Runtime wrapper with the reference's interface:
    compute_embedding(image) -> np.ndarray descriptor.

    device: where the network's weights live and every forward runs
    (None = the CUDA card, which raises without one; no fall-back)."""

    def __init__(self, params: dict, node=None, rng_seed: int = 0,
                 device: DeviceLike = None):
        self.params_dict = params
        self.node = node
        self.fc_output_dim = params.get("frontend.global_descriptor_dim", 64)
        self.crop_size = params.get("frontend.image_crop_size", 224)
        self.checkpoint = params.get("frontend.nn_checkpoint", "disable")
        if self.checkpoint == "shipped":
            # resolves to "" (-> disabled) when the file is absent
            self.checkpoint = zoo.shipped_checkpoint("cosplace_synth.npz")
        self.enabled = self.checkpoint not in ("", "disable", None)
        self._rng = np.random.default_rng(rng_seed)
        self.device = resolve_device(device)
        self.model = GeoLocalizationNet(fc_output_dim=self.fc_output_dim)
        if self.enabled:
            load_flat_weights(self.model, convert.cosplace_state_dict(
                convert.load_flat(self.checkpoint)))
        else:
            # random-weight init still allows shape-correct inference
            flax_init_(self.model, rng_seed)
        self.model.eval().to(self.device)

    def compute_embedding(self, image: np.ndarray) -> np.ndarray:
        """Single-image descriptor. Random unit vector when disabled
        (the reference's testing mode)."""
        if not self.enabled:
            v = self._rng.standard_normal(self.fc_output_dim)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return embed(self.model, preprocess(image, self.crop_size),
                     self.device)[0]

    def compute_embeddings_batch(self, images: np.ndarray) -> np.ndarray:
        """Batched descriptors: one forward over all pending keyframes.
        Counter `visual.cosplace_images` adds the images of each batch
        the network embeds."""
        if not self.enabled:
            v = self._rng.standard_normal(
                (len(images), self.fc_output_dim))
            return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
                np.float32)
        tracer.counter("visual", cosplace_images=len(images))
        with span("descriptor_preprocess", images=len(images)):
            batch = preprocess(images, self.crop_size)
        with span("descriptor_forward", images=len(batch)):
            return embed(self.model, batch, self.device)
