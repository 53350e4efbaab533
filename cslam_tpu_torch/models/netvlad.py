"""NetVLAD visual place recognition.

Port of cslam_tpu/models/netvlad.py: VGG16-conv5 features -> NetVLAD
soft-assignment pooling (intra-normalized cluster residuals) ->
optional PCA projection -> L2 norm; random descriptor when the
checkpoint is "disable" (testing only). The reference's per-cluster
loop is one batched product of the soft assignment with the features.

Precision as the reference: the VGG convs compute in `dtype` (bf16:
input, kernel and bias cast, ReLU and the 2x2 max pools in bf16); the
NetVLAD layer is f32 throughout (its 1x1 assignment conv, softmax,
pooling product and normalizations), and so is the PCA projection,
which runs on the model's device (`torch.matmul` in full f32: every
forward on a CUDA tensor checks that no fp32 product or convolution
may run in TF32).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cslam_tpu_torch.device import DeviceLike, require_full_fp32, \
    resolve_device
from cslam_tpu_torch.models import convert, zoo
from cslam_tpu_torch.models.cosplace import Conv, embed, flax_init_, \
    l2_normalize, load_flat_weights, preprocess, to_device
from cslam_tpu_torch.runtime.tracing import span

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]


class VGG16Conv5(nn.Sequential):
    """VGG16 feature extractor through conv5_3, no final ReLU (the
    reference's encoder crop). Laid out as torchvision's `features`, so
    the convs sit at `convert.VGG16_CONV_INDICES`."""

    def __init__(self, dtype=torch.bfloat16):
        layers, in_ch = [], 3
        n_convs = len([c for c in VGG16_CFG if c != "M"])
        conv_idx = 0
        for c in VGG16_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))  # VALID: floor
            else:
                layers.append(Conv(in_ch, c, 3, 1, 1, bias=True,
                                   dtype=dtype))
                conv_idx += 1
                if conv_idx != n_convs:
                    layers.append(nn.ReLU())
                in_ch = c
        super().__init__(*layers)


class NetVLADLayer(nn.Module):
    """Soft-assignment VLAD pooling of a (B, C, H, W) map in f32; returns
    (B, K * C) with cluster-major order, as the reference's (B, K, C)
    reshape."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 normalize_input: bool = True):
        super().__init__()
        self.num_clusters = num_clusters
        self.normalize_input = normalize_input
        self.centroids = nn.Parameter(torch.rand(num_clusters, dim))
        self.conv = nn.Conv2d(dim, num_clusters, 1, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        x = x.float()
        if self.normalize_input:
            x = l2_normalize(x, dim=1)
        logits = F.conv2d(x, self.conv.weight)  # (B, K, H, W)
        soft_assign = torch.softmax(
            logits.reshape(B, self.num_clusters, H * W), dim=1)
        feats = x.reshape(B, C, H * W)
        # vlad[b, k, c] = sum_p a[b,k,p] * (f[b,c,p] - centroid[k,c])
        weighted = torch.einsum("bkp,bcp->bkc", soft_assign, feats)
        mass = torch.sum(soft_assign, dim=2)  # (B, K)
        vlad = weighted - mass[..., None] * self.centroids[None]
        vlad = l2_normalize(vlad, dim=-1)  # intra-normalization
        return l2_normalize(vlad.reshape(B, -1), dim=-1)


class NetVLADNet(nn.Module):
    """forward takes (B, H, W, 3) float images (NHWC, as the reference)
    and returns (B, num_clusters * 512) f32 unit descriptors."""

    def __init__(self, num_clusters: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.encoder = VGG16Conv5(dtype=dtype)
        self.pool = NetVLADLayer(num_clusters=num_clusters, dim=512)

    def forward(self, image):
        if image.is_cuda:
            require_full_fp32(image.device)
        return self.pool(self.encoder(image.permute(0, 3, 1, 2)))


class NetVLAD:
    """Runtime wrapper: compute_embedding(image) with optional PCA.

    device: where the weights and the PCA projection live and every
    forward runs (None = the CUDA card; no fall-back)."""

    def __init__(self, params: dict, node=None, rng_seed: int = 0,
                 device: DeviceLike = None):
        self.params_dict = params
        self.node = node
        self.checkpoint = params.get("frontend.nn_checkpoint", "disable")
        self.pca_checkpoint = params.get("frontend.netvlad.pca_checkpoint",
                                         "")
        if self.checkpoint == "shipped":
            # resolves to "" (-> disabled) when the file is absent
            self.checkpoint = zoo.shipped_checkpoint("netvlad_synth.npz")
            if self.checkpoint and not self.pca_checkpoint:
                self.pca_checkpoint = zoo.shipped_checkpoint(
                    "netvlad_pca_synth.npz")
        self.enabled = self.checkpoint not in ("", "disable", None)
        self.descriptor_dim = params.get("frontend.global_descriptor_dim",
                                         128)
        # inference runs at the checkpoint's training resolution: the
        # shipped weights are trained at 128
        self.crop_size = params.get(
            "frontend.image_crop_size",
            128 if self.checkpoint.endswith("netvlad_synth.npz") else 224)
        self._rng = np.random.default_rng(rng_seed)
        self.device = resolve_device(device)
        self.model = NetVLADNet()
        self.pca_mean = None
        self.pca_components = None
        if self.enabled:
            load_flat_weights(self.model, convert.netvlad_state_dict(
                convert.load_flat(self.checkpoint)))
            if self.pca_checkpoint:
                with np.load(self.pca_checkpoint) as data:
                    self.pca_mean = torch.from_numpy(
                        np.asarray(data["mean"])).to(self.device)
                    self.pca_components = torch.from_numpy(
                        np.asarray(data["components"])).to(self.device)
        else:
            flax_init_(self.model, rng_seed)
        self.model.eval().to(self.device)

    def compute_embedding(self, image: np.ndarray) -> np.ndarray:
        if not self.enabled:
            v = self._rng.standard_normal(self.descriptor_dim)
            return (v / np.linalg.norm(v)).astype(np.float32)
        return self.compute_embeddings_batch(np.asarray(image)[None])[0]

    def compute_embeddings_batch(self, images: np.ndarray) -> np.ndarray:
        """Batched descriptors: one forward over all pending keyframes,
        then the PCA projection and L2 norm on the same device."""
        if not self.enabled:
            v = self._rng.standard_normal(
                (len(images), self.descriptor_dim))
            return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
                np.float32)
        with span("descriptor_preprocess", images=len(images)):
            batch = preprocess(images, self.crop_size)
        with span("descriptor_forward", images=len(batch)), \
                torch.no_grad():
            if self.pca_components is None:
                return embed(self.model, batch, self.device)
            out = self.model(to_device(batch, self.device))
            out = (out - self.pca_mean) @ self.pca_components.T
            return l2_normalize(out, dim=-1).cpu().numpy()
