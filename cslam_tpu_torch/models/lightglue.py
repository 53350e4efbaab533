"""LightGlue learned feature matcher.

Port of cslam_tpu/models/lightglue.py, the LightGlue architecture
(Lindenberger et al. 2023) with the official cvg/LightGlue module names,
so an official state_dict loads strictly once its early-exit heads
(`token_confidence.*` and every `log_assignment.i` but the last, which
run only with dynamic pruning) are left out, as the reference's
converter leaves them out:

- learnable Fourier positional encoding (`posenc.Wr`) applied as an
  interleaved rotary embedding to q and k in self-attention;
- per layer one SelfBlock and one CrossBlock shared by both images
  (`transformers.i.self_attn` / `.cross_attn`): fused `Wqkv` with the
  official (heads, head_dim, 3) unflatten, shared `to_qk` in
  cross-attention, ffn = Linear -> LayerNorm(eps 1e-5) -> exact GELU ->
  Linear;
- assignment (`log_assignment.<last>`): final_proj similarity / d^0.25
  plus matchability, combined by the sigmoid-log-double-softmax.

Padded keypoint slots are masked with -1e9 logits in every softmax and
-inf in the scores, so fixed budgets match the unpadded model. Every
module takes leading batch dimensions. Matrix products are f32 at full
precision (TF32 off on the card, checked per forward).
"""

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cslam_tpu_torch.device import DeviceLike, require_full_fp32, \
    resolve_device
from cslam_tpu_torch.models import convert
from cslam_tpu_torch.models.cosplace import flax_init_, load_flat_weights

_NEG = -1e9


def normalize_keypoints(kpts, size):
    """Center at size/2, scale by max-extent/2 -> roughly [-1, 1]."""
    size = torch.as_tensor(size, dtype=torch.float32, device=kpts.device)
    return (kpts - size / 2.0) / (torch.max(size) / 2.0)


def _rotate_half(x):
    """Interleaved-pair rotation: (x0, x1) -> (-x1, x0)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _apply_rotary(t, cos_rep, sin_rep):
    """t (..., K, h, hd) with cos/sin (..., K, hd) over the heads."""
    return t * cos_rep[..., None, :] + _rotate_half(t) * \
        sin_rep[..., None, :]


def _ffn(dim):
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim),
                         nn.LayerNorm(2 * dim, eps=1e-5), nn.GELU(),
                         nn.Linear(2 * dim, dim))


class SelfBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x, cos_rep, sin_rep, mask):
        d, h = x.shape[-1], self.num_heads
        hd = d // h
        qkv = self.Wqkv(x).unflatten(-1, (h, hd, 3))
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]   # (..., K, h, hd)
        q = _apply_rotary(q, cos_rep, sin_rep)
        k = _apply_rotary(k, cos_rep, sin_rep)
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(hd)
        logits = torch.where(mask[..., None, None, :] > 0, logits,
                             torch.full_like(logits, _NEG))
        attn = torch.softmax(logits, dim=-1)
        context = torch.einsum("...hqk,...khd->...qhd", attn, v).flatten(-2)
        message = self.out_proj(context)
        y = self.ffn(torch.cat([x, message], dim=-1))
        return x + y * mask[..., None]


class CrossBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x0, x1, m0, m1):
        d, h = x0.shape[-1], self.num_heads
        hd = d // h

        def heads(t):
            return t.unflatten(-1, (h, hd))

        qk0, qk1 = heads(self.to_qk(x0)), heads(self.to_qk(x1))
        v0, v1 = heads(self.to_v(x0)), heads(self.to_v(x1))
        sim = torch.einsum("...ihd,...jhd->...hij", qk0, qk1) / \
            math.sqrt(hd)
        neg = torch.full_like(sim, _NEG)
        sim01 = torch.where(m1[..., None, None, :] > 0, sim, neg)
        sim10 = torch.where(m0[..., None, :, None] > 0, sim, neg)
        attn01 = torch.softmax(sim01, dim=-1)
        attn10 = torch.softmax(sim10, dim=-2)            # over K0
        msg0 = torch.einsum("...hij,...jhd->...ihd", attn01, v1).flatten(-2)
        msg1 = torch.einsum("...hij,...ihd->...jhd", attn10, v0).flatten(-2)
        msg0, msg1 = self.to_out(msg0), self.to_out(msg1)

        def ffn(x, msg, m):
            return x + self.ffn(torch.cat([x, msg], dim=-1)) * m[..., None]

        return ffn(x0, msg0, m0), ffn(x1, msg1, m1)


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, num_heads)
        self.cross_attn = CrossBlock(dim, num_heads)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.matchability = nn.Linear(dim, 1)
        self.final_proj = nn.Linear(dim, dim)

    def forward(self, x0, x1, m0, m1):
        scale = self.dim ** 0.25
        mdesc0 = self.final_proj(x0) / scale
        mdesc1 = self.final_proj(x1) / scale
        sim = torch.einsum("...id,...jd->...ij", mdesc0, mdesc1)
        z0 = self.matchability(x0)[..., 0]
        z1 = self.matchability(x1)[..., 0]
        valid = (m0[..., :, None] > 0) & (m1[..., None, :] > 0)
        sim = torch.where(valid, sim, torch.full_like(sim, _NEG))
        certainties = F.logsigmoid(z0)[..., :, None] + \
            F.logsigmoid(z1)[..., None, :]
        scores = torch.log_softmax(sim, dim=-1) + \
            torch.log_softmax(sim, dim=-2) + certainties
        return torch.where(valid, scores, torch.full_like(scores, -torch.inf))


class Posenc(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, xy):
        proj = self.Wr(xy)
        return (torch.cos(proj).repeat_interleave(2, dim=-1),
                torch.sin(proj).repeat_interleave(2, dim=-1))


class LightGlueNet(nn.Module):
    """Official-topology LightGlue (input_dim == dim: no input_proj, as
    in the superpoint_lightglue checkpoint). forward(desc0 (..., K0, D),
    xy0 (..., K0, 2) normalized, m0 (..., K0), desc1, xy1, m1) -> log
    assignment scores (..., K0, K1)."""

    def __init__(self, dim: int = 256, num_layers: int = 9,
                 num_heads: int = 4, input_dim: int = 256):
        super().__init__()
        self.dim, self.num_layers, self.num_heads = dim, num_layers, \
            num_heads
        if input_dim != dim:
            self.input_proj = nn.Linear(input_dim, dim)
        self.posenc = Posenc(dim // num_heads)
        self.transformers = nn.ModuleList(
            [TransformerLayer(dim, num_heads) for _ in range(num_layers)])
        self.log_assignment = nn.ModuleDict(
            {str(num_layers - 1): MatchAssignment(dim)})

    def forward(self, desc0, xy0, m0, desc1, xy1, m1):
        if desc0.is_cuda:
            require_full_fp32(desc0.device)
        if hasattr(self, "input_proj"):
            desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)
        x0, x1 = desc0, desc1
        cos0, sin0 = self.posenc(xy0)
        cos1, sin1 = self.posenc(xy1)
        for layer in self.transformers:
            x0 = layer.self_attn(x0, cos0, sin0, m0)
            x1 = layer.self_attn(x1, cos1, sin1, m1)
            x0, x1 = layer.cross_attn(x0, x1, m0, m1)
        return self.log_assignment[str(self.num_layers - 1)](x0, x1, m0, m1)


def official_state(state: dict, num_layers: int) -> dict:
    """An official cvg/LightGlue state_dict without the early-exit heads
    (token_confidence, log_assignment.i for i < num_layers - 1)."""
    last = f"log_assignment.{num_layers - 1}."
    return {k: v for k, v in state.items()
            if not k.startswith("token_confidence.")
            and (not k.startswith("log_assignment.") or k.startswith(last))}


def mutual_matches(scores, m0, threshold):
    """(idx1_for_0, valid) from log-assignment scores (K0, K1): mutual
    argmax of the match probabilities above `threshold` (the official
    filter)."""
    p = torch.exp(scores)
    best1 = torch.argmax(p, dim=-1)
    best0 = torch.argmax(p, dim=-2)
    mutual = torch.gather(best0, -1, best1) == torch.arange(
        p.shape[-2], device=p.device)
    top = torch.amax(p, dim=-1)
    valid = mutual & (top > threshold) & (m0 > 0)
    return best1, valid


class LightGlue:
    """Runtime wrapper exposing mutual_match-compatible matching.

    device: where the network runs (None = the CUDA card; raises
    without one)."""

    def __init__(self, checkpoint: str = "", dim: int = 256,
                 num_layers: int = 9, score_threshold: float = 0.1,
                 input_dim: int = 256, rng_seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = LightGlueNet(dim=dim, num_layers=num_layers,
                                  input_dim=input_dim)
        self.score_threshold = score_threshold
        if checkpoint and checkpoint != "disable":
            if checkpoint.endswith((".pth", ".pt", ".tar")):
                from cslam_tpu_torch.models.superpoint import \
                    torch_checkpoint_state
                state = official_state(torch_checkpoint_state(checkpoint),
                                       num_layers)
            else:
                state = convert.lightglue_state_dict(
                    convert.load_flat(checkpoint), num_layers)
            load_flat_weights(self.model, state)
        else:
            flax_init_(self.model, rng_seed)
        self.model.eval().to(self.device)

    def _tensor(self, x, dtype=torch.float32):
        if torch.is_tensor(x):
            return x.to(self.device, dtype)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device,
                                                              dtype)

    def scores(self, desc0, xy0, m0, desc1, xy1, m1,
               size: Optional[Any] = None):
        """Log-assignment scores (K0, K1) on the device; xy in pixels,
        normalized by `size` (W, H) or else by the keypoints' bounds."""
        xy0, xy1 = self._tensor(xy0), self._tensor(xy1)
        if size is None:
            size = torch.clamp(torch.amax(torch.cat([xy0, xy1]), dim=0),
                               min=1.0)
        with torch.no_grad():
            return self.model(
                self._tensor(desc0), normalize_keypoints(xy0, size),
                self._tensor(m0), self._tensor(desc1),
                normalize_keypoints(xy1, size), self._tensor(m1))

    def match(self, desc0, xy0, m0, desc1, xy1, m1,
              size: Optional[Any] = None):
        """(idx1_for_0 int32, valid float32) as numpy, like
        ops.matching2d.mutual_match."""
        scores = self.scores(desc0, xy0, m0, desc1, xy1, m1, size=size)
        best1, valid = mutual_matches(scores, self._tensor(m0),
                                      self.score_threshold)
        out = torch.stack([best1.to(torch.float32),
                           valid.to(torch.float32)]).cpu().numpy()
        return out[0].astype(np.int32), out[1]
