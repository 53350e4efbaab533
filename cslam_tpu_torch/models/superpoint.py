"""SuperPoint keypoint detector + descriptor.

Port of cslam_tpu/models/superpoint.py: the VGG-style shared encoder
(widths 64/64/128/128, three 2x2 max pools), the detector head (65-way
cell softmax with dustbin) and the 256-d descriptor head, with the
MagicLeap state_dict names (conv1a ... convDb) so that
`models/convert.py` maps the shipped weights both ways and an official
`.pth` loads as it is.

Precision follows the reference's Flax modules: the 3x3 convs compute
in `dtype` (bf16 by default: input, kernel and bias cast, output in
bf16, as `models/cosplace.Conv`), ReLU and max pooling stay in that
dtype, and the two 1x1 heads run in f32. `SuperPointNet.forward` takes
and returns the reference's NHWC layout.

`extract` keeps the reference's contract (xy, desc, scores, mask) and
its tie rule: the keypoints are the top-k of the NMS'd heatmap with the
lower pixel index first among equal scores (`ops/features.top_k`).
The heatmap covers the image's floored multiple of 8 in each axis (the
network pools by 8), and keypoints are decoded with that width, so they
stay inside it, as the official extractor keeps them; the JAX package
decodes with the image's width, which shifts a keypoint of row y by y
pixels wherever the width is not a multiple of 8. Host spans
`superpoint_forward` and `keypoint_select` time the two stages.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cslam_tpu_torch.device import DeviceLike, require_full_fp32, \
    resolve_device
from cslam_tpu_torch.models import convert
from cslam_tpu_torch.models.cosplace import Conv, flax_init_, \
    load_flat_weights
from cslam_tpu_torch.ops.features import nms_max_pool, top_k
from cslam_tpu_torch.runtime.tracing import span

ENCODER = (("conv1a", "conv1b"), ("conv2a", "conv2b"),
           ("conv3a", "conv3b"), ("conv4a", "conv4b"))


class SuperPointNet(nn.Module):
    """forward: (B, H, W, 1) images in [0, 1] -> (det (B, H/8, W/8, 65)
    f32 logits, desc (B, H/8, W/8, D) f32 unit descriptors)."""

    def __init__(self, dtype=torch.bfloat16, descriptor_dim: int = 256):
        super().__init__()
        self.dtype = dtype
        self.descriptor_dim = descriptor_dim
        c_in = 1
        for (a, b), w in zip(ENCODER, (64, 64, 128, 128)):
            setattr(self, a, Conv(c_in, w, 3, padding=1, bias=True,
                                  dtype=dtype))
            setattr(self, b, Conv(w, w, 3, padding=1, bias=True,
                                  dtype=dtype))
            c_in = w
        self.convPa = Conv(c_in, 256, 3, padding=1, bias=True, dtype=dtype)
        self.convPb = Conv(256, 65, 1, bias=True, dtype=torch.float32)
        self.convDa = Conv(c_in, 256, 3, padding=1, bias=True, dtype=dtype)
        self.convDb = Conv(256, descriptor_dim, 1, bias=True,
                           dtype=torch.float32)

    def forward(self, image):
        if image.is_cuda:
            require_full_fp32(image.device)
        x = image.permute(0, 3, 1, 2).to(self.dtype)
        for i, (a, b) in enumerate(ENCODER):
            x = F.relu(getattr(self, a)(x))
            x = F.relu(getattr(self, b)(x))
            if i < len(ENCODER) - 1:
                x = F.max_pool2d(x, 2, 2)
        det = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc / torch.clamp(torch.linalg.vector_norm(
            desc, dim=1, keepdim=True), min=1e-12)
        return det.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def _cell_scores_to_heatmap(det):
    """(B, Hc, Wc, 65) logits -> (B, Hc*8, Wc*8) keypoint probabilities."""
    probs = torch.softmax(det, dim=-1)[..., :64]
    B, Hc, Wc, _ = probs.shape
    probs = probs.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4)
    return probs.reshape(B, Hc * 8, Wc * 8)


def extract(model: SuperPointNet, image, max_keypoints=256, nms_radius=4,
            score_threshold=0.005):
    """Keypoints + descriptors of one (H, W) grayscale image tensor.

    Returns (xy (K, 2), desc (K, D), scores (K,), mask (K,)), the
    contract of ops/features.extract_features."""
    H, W = image.shape
    with span("superpoint_forward", height=H, width=W):
        with torch.no_grad():
            det, desc_map = model(image[None, :, :, None])
    with span("keypoint_select", k=max_keypoints):
        heat = _cell_scores_to_heatmap(det)[0, :H, :W]
        width = heat.shape[1]
        pooled = nms_max_pool(heat, nms_radius)
        is_max = (heat >= pooled) & (heat > score_threshold)
        scores_flat = torch.where(is_max, heat, torch.full_like(
            heat, -torch.inf)).reshape(-1)
        top_scores, top_idx = top_k(scores_flat, max_keypoints)
        yy = top_idx // width
        xx = top_idx % width
        mask = (top_scores > -torch.inf).to(torch.float32)
        xy = torch.stack([xx, yy], dim=-1).to(torch.float32)
        cy = torch.clamp(yy // 8, 0, desc_map.shape[1] - 1)
        cx = torch.clamp(xx // 8, 0, desc_map.shape[2] - 1)
        desc = desc_map[0, cy, cx]
        desc = desc / torch.clamp(torch.linalg.vector_norm(
            desc, dim=-1, keepdim=True), min=1e-12)
    return xy, desc * mask[:, None], torch.where(
        mask > 0, top_scores, torch.zeros_like(top_scores)), mask


def torch_checkpoint_state(path: str) -> dict:
    """A .pth/.pt/.tar checkpoint's state_dict as numpy arrays (the
    'state_dict' / 'model_state_dict' entry when the file wraps one)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict):
        blob = blob.get("state_dict", blob.get("model_state_dict", blob))
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in blob.items()}


def superpoint_state(checkpoint: str) -> dict:
    """The state_dict of a SuperPoint checkpoint: the JAX package's flat
    .npz, an ONNX export, or a MagicLeap-layout torch file."""
    if checkpoint.endswith(".onnx"):
        from cslam_tpu_torch.models.onnx_import import \
            convert_superpoint_onnx
        return convert.superpoint_state_dict(
            convert_superpoint_onnx(checkpoint))
    if checkpoint.endswith((".pth", ".pt", ".tar")):
        return torch_checkpoint_state(checkpoint)
    return convert.superpoint_state_dict(convert.load_flat(checkpoint))


class SuperPoint:
    """Runtime wrapper mirroring the classical extractor interface.

    device: where the network runs (None = the CUDA card; raises
    without one)."""

    def __init__(self, checkpoint: str = "", max_keypoints: int = 256,
                 rng_seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = SuperPointNet()
        self.max_keypoints = max_keypoints
        if checkpoint and checkpoint != "disable":
            load_flat_weights(self.model, superpoint_state(checkpoint))
        else:
            flax_init_(self.model, rng_seed)
        self.model.eval().to(self.device)

    def image_tensor(self, image):
        """(H, W) f32 tensor on the device from a uint8 or float image
        (H, W) or (H, W, C) (channels averaged), as the reference."""
        if torch.is_tensor(image):
            img = image.to(self.device, torch.float32)
        else:
            a = np.asarray(image)
            a = a.astype(np.float32) / 255.0 if a.dtype == np.uint8 \
                else a.astype(np.float32)
            img = torch.from_numpy(a).to(self.device)
        if img.ndim == 3:
            img = torch.mean(img, dim=-1)
        return img

    def extract_features(self, image, max_keypoints: Optional[int] = None):
        return extract(self.model, self.image_tensor(image),
                       max_keypoints=max_keypoints or self.max_keypoints)
