"""Weights between torch `state_dict`s and the JAX package's flat
"params/..." layout.

Port of cslam_tpu/models/convert.py (numpy only): the converters from
torch state_dicts (torchvision ResNet18 / CosPlace GeoLocalizationNet /
NetVLAD / SuperPoint / LightGlue) to flat "a/b/c"-keyed dicts as the
shipped `.npz` files hold them, and their inverses for the port's own
models: `cosplace_state_dict`, `netvlad_state_dict`,
`superpoint_state_dict` and `lightglue_state_dict` carry the shipped
weights into `models/cosplace.py`, `models/netvlad.py`,
`models/superpoint.py` and `models/lightglue.py`; `convert_netvlad`
maps a whole NetVLADNet back. The port's trainers save through these
maps (models/training.py), so either package loads what they write.

Layout mapping: torch conv weights (O, I, H, W) <-> flat (H, W, I, O);
Dense kernels are transposed; BatchNorm running statistics live under
`batch_stats/`.
"""

from typing import Dict

import numpy as np


def _conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _dense(w):
    return np.transpose(np.asarray(w), (1, 0))


def _bn(state, prefix, out, flax_path):
    out[f"params/{flax_path}/scale"] = np.asarray(state[f"{prefix}.weight"])
    out[f"params/{flax_path}/bias"] = np.asarray(state[f"{prefix}.bias"])
    out[f"batch_stats/{flax_path}/mean"] = np.asarray(
        state[f"{prefix}.running_mean"])
    out[f"batch_stats/{flax_path}/var"] = np.asarray(
        state[f"{prefix}.running_var"])


def convert_resnet18_backbone(state: Dict, out: Dict, torch_prefix: str = "",
                              flax_prefix: str = "ResNet18Backbone_0"):
    """torchvision resnet18 conv stack -> ResNet18Backbone params."""
    p = torch_prefix
    out[f"params/{flax_prefix}/Conv_0/kernel"] = _conv(state[f"{p}conv1.weight"])
    _bn(state, f"{p}bn1", out, f"{flax_prefix}/BatchNorm_0")
    block = 0
    for stage in range(1, 5):
        for b in range(2):
            tp = f"{p}layer{stage}.{b}"
            fp = f"{flax_prefix}/BasicBlock_{block}"
            out[f"params/{fp}/Conv_0/kernel"] = _conv(
                state[f"{tp}.conv1.weight"])
            _bn(state, f"{tp}.bn1", out, f"{fp}/BatchNorm_0")
            out[f"params/{fp}/Conv_1/kernel"] = _conv(
                state[f"{tp}.conv2.weight"])
            _bn(state, f"{tp}.bn2", out, f"{fp}/BatchNorm_1")
            if f"{tp}.downsample.0.weight" in state:
                out[f"params/{fp}/Conv_2/kernel"] = _conv(
                    state[f"{tp}.downsample.0.weight"])
                _bn(state, f"{tp}.downsample.1", out, f"{fp}/BatchNorm_2")
            block += 1
    return out


def convert_cosplace(state: Dict) -> Dict[str, np.ndarray]:
    """CosPlace/EigenPlaces GeoLocalizationNet state_dict -> flat npz
    dict for models.cosplace.GeoLocalizationNet.

    Expects torchvision-resnet18-style backbone keys (optionally prefixed
    'backbone.') and an aggregation with GeM p and a Linear layer
    (aggregation.1.p / aggregation.3.{weight,bias} in the reference's
    Sequential: L2Norm, GeM, Flatten, Linear, L2Norm)."""
    out: Dict[str, np.ndarray] = {}
    prefix = "backbone." if any(k.startswith("backbone.") for k in state) \
        else ""
    convert_resnet18_backbone(state, out, prefix)
    # GeM exponent
    for key in ("aggregation.1.p", "gem.p", "aggregation.gem.p"):
        if key in state:
            out["params/GeM_0/p"] = np.asarray(state[key]).reshape(1)
            break
    else:
        out["params/GeM_0/p"] = np.ones(1, np.float32) * 3.0
    # final Linear
    for wkey, bkey in (("aggregation.3.weight", "aggregation.3.bias"),
                       ("fc.weight", "fc.bias")):
        if wkey in state:
            out["params/Dense_0/kernel"] = _dense(state[wkey])
            out["params/Dense_0/bias"] = np.asarray(state[bkey])
            break
    return out


def convert_superpoint(state: Dict) -> Dict[str, np.ndarray]:
    """MagicLeap SuperPoint state_dict -> models.superpoint.SuperPointNet.

    torch layout: conv1a/1b ... conv4a/4b shared encoder, convPa/convPb
    detector head, convDa/convDb descriptor head."""
    out: Dict[str, np.ndarray] = {}
    order = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
             "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb"]
    for i, name in enumerate(order):
        out[f"params/Conv_{i}/kernel"] = _conv(state[f"{name}.weight"])
        out[f"params/Conv_{i}/bias"] = np.asarray(state[f"{name}.bias"])
    return out


def convert_lightglue(state: Dict, num_layers: int = 9) -> Dict:
    """Official cvg/LightGlue state_dict -> models.lightglue.LightGlueNet.

    torch names: posenc.Wr.weight; transformers.{i}.self_attn.{Wqkv,
    out_proj,ffn.0,ffn.1,ffn.3}; transformers.{i}.cross_attn.{to_qk,to_v,
    to_out,ffn.*}; log_assignment.{i}.{final_proj,matchability}. Only the
    last assignment head is used at full depth (early-exit heads are a
    dynamic-shape GPU optimization); token_confidence is skipped.
    input_proj exists only when input_dim != descriptor_dim."""
    out: Dict[str, np.ndarray] = {}

    def dense(torch_key, flax_path, bias=True):
        out[f"params/{flax_path}/kernel"] = _dense(state[f"{torch_key}.weight"])
        if bias:
            out[f"params/{flax_path}/bias"] = np.asarray(
                state[f"{torch_key}.bias"])

    def layernorm(torch_key, flax_path):
        out[f"params/{flax_path}/scale"] = np.asarray(
            state[f"{torch_key}.weight"])
        out[f"params/{flax_path}/bias"] = np.asarray(state[f"{torch_key}.bias"])

    dense("posenc.Wr", "posenc_Wr", bias=False)
    if "input_proj.weight" in state:
        dense("input_proj", "input_proj")
    for i in range(num_layers):
        tp = f"transformers.{i}.self_attn"
        fp = f"transformers_{i}_self_attn"
        dense(f"{tp}.Wqkv", f"{fp}/Wqkv")
        dense(f"{tp}.out_proj", f"{fp}/out_proj")
        dense(f"{tp}.ffn.0", f"{fp}/ffn_0")
        layernorm(f"{tp}.ffn.1", f"{fp}/ffn_1")
        dense(f"{tp}.ffn.3", f"{fp}/ffn_3")
        tp = f"transformers.{i}.cross_attn"
        fp = f"transformers_{i}_cross_attn"
        dense(f"{tp}.to_qk", f"{fp}/to_qk")
        dense(f"{tp}.to_v", f"{fp}/to_v")
        dense(f"{tp}.to_out", f"{fp}/to_out")
        dense(f"{tp}.ffn.0", f"{fp}/ffn_0")
        layernorm(f"{tp}.ffn.1", f"{fp}/ffn_1")
        dense(f"{tp}.ffn.3", f"{fp}/ffn_3")
    last = num_layers - 1
    dense(f"log_assignment.{last}.final_proj", "log_assignment/final_proj")
    dense(f"log_assignment.{last}.matchability",
          "log_assignment/matchability")
    return out


def convert_netvlad_layer(state: Dict, prefix: str = "pool.") -> Dict:
    """NetVLAD layer (centroids + 1x1 assignment conv) ->
    models.netvlad.NetVLADLayer params."""
    out: Dict[str, np.ndarray] = {}
    out["params/NetVLADLayer_0/centroids"] = np.asarray(
        state[f"{prefix}centroids"])
    out["params/NetVLADLayer_0/assign_conv/kernel"] = _conv(
        state[f"{prefix}conv.weight"])
    return out


def convert_netvlad(state: Dict) -> Dict[str, np.ndarray]:
    """NetVLADNet state_dict (torchvision VGG16 `features` indices under
    `encoder.`, the NetVLAD layer under `pool.`) -> the flat variables of
    models.netvlad.NetVLADNet, as netvlad_synth.npz holds them: the
    inverse of `netvlad_state_dict`."""
    out: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(VGG16_CONV_INDICES):
        fp = f"params/VGG16Conv5_0/Conv_{i}"
        out[f"{fp}/kernel"] = _conv(state[f"encoder.{idx}.weight"])
        out[f"{fp}/bias"] = np.asarray(state[f"encoder.{idx}.bias"])
    out.update(convert_netvlad_layer(state))
    return out


def save_npz(flat: Dict[str, np.ndarray], path: str):
    np.savez(path, **flat)


def convert_torch_checkpoint(torch_path: str, out_path: str,
                             model: str = "cosplace"):
    """Load a .pth/.tar torch checkpoint and write the flat npz."""
    import torch

    blob = torch.load(torch_path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob.get("model_state_dict", blob)) \
        if isinstance(blob, dict) else blob
    state = {k: v.numpy() if hasattr(v, "numpy") else v
             for k, v in state.items()}
    converters = {
        "cosplace": convert_cosplace,
        "superpoint": convert_superpoint,
        "lightglue": convert_lightglue,
        "netvlad": convert_netvlad_layer,
    }
    flat = converters[model](state)
    save_npz(flat, out_path)
    return flat


# ----------------------------------------------------------------------
# Inverse: flat "params/..." arrays -> the port's state_dicts
# ----------------------------------------------------------------------

# torchvision's VGG16 `features` indices of the 13 convs through conv5_3
VGG16_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _conv_inv(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense_inv(k):
    return np.ascontiguousarray(np.transpose(np.asarray(k), (1, 0)))


def _bn_inv(flat, flax_path, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(flat[f"params/{flax_path}/scale"])
    out[f"{prefix}.bias"] = np.asarray(flat[f"params/{flax_path}/bias"])
    out[f"{prefix}.running_mean"] = np.asarray(
        flat[f"batch_stats/{flax_path}/mean"])
    out[f"{prefix}.running_var"] = np.asarray(
        flat[f"batch_stats/{flax_path}/var"])


def resnet18_backbone_state_dict(flat: Dict, out: Dict,
                                 torch_prefix: str = "backbone.",
                                 flax_prefix: str = "ResNet18Backbone_0"):
    """Inverse of `convert_resnet18_backbone`: ResNet18Backbone params ->
    torchvision resnet18 conv-stack keys."""
    p = torch_prefix
    out[f"{p}conv1.weight"] = _conv_inv(
        flat[f"params/{flax_prefix}/Conv_0/kernel"])
    _bn_inv(flat, f"{flax_prefix}/BatchNorm_0", f"{p}bn1", out)
    block = 0
    for stage in range(1, 5):
        for b in range(2):
            tp = f"{p}layer{stage}.{b}"
            fp = f"{flax_prefix}/BasicBlock_{block}"
            out[f"{tp}.conv1.weight"] = _conv_inv(
                flat[f"params/{fp}/Conv_0/kernel"])
            _bn_inv(flat, f"{fp}/BatchNorm_0", f"{tp}.bn1", out)
            out[f"{tp}.conv2.weight"] = _conv_inv(
                flat[f"params/{fp}/Conv_1/kernel"])
            _bn_inv(flat, f"{fp}/BatchNorm_1", f"{tp}.bn2", out)
            if f"params/{fp}/Conv_2/kernel" in flat:
                out[f"{tp}.downsample.0.weight"] = _conv_inv(
                    flat[f"params/{fp}/Conv_2/kernel"])
                _bn_inv(flat, f"{fp}/BatchNorm_2", f"{tp}.downsample.1",
                        out)
            block += 1
    return out


def cosplace_state_dict(flat: Dict) -> Dict[str, np.ndarray]:
    """Flat GeoLocalizationNet variables (as in cosplace_synth.npz) ->
    the state_dict of models.cosplace.GeoLocalizationNet, whose keys are
    the reference CosPlace's (backbone.*, aggregation.1.p,
    aggregation.3.*): `convert_cosplace` maps it back exactly."""
    out: Dict[str, np.ndarray] = {}
    resnet18_backbone_state_dict(flat, out)
    out["aggregation.1.p"] = np.asarray(flat["params/GeM_0/p"]).reshape(1)
    out["aggregation.3.weight"] = _dense_inv(flat["params/Dense_0/kernel"])
    out["aggregation.3.bias"] = np.asarray(flat["params/Dense_0/bias"])
    return out


def netvlad_state_dict(flat: Dict) -> Dict[str, np.ndarray]:
    """Flat NetVLADNet variables (as in netvlad_synth.npz) -> the
    state_dict of models.netvlad.NetVLADNet: torchvision VGG16 `features`
    indices under `encoder.`, the NetVLAD layer under `pool.` (the
    reference NetVLAD's names; `convert_netvlad_layer` maps `pool.`
    back exactly)."""
    out: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(VGG16_CONV_INDICES):
        fp = f"params/VGG16Conv5_0/Conv_{i}"
        out[f"encoder.{idx}.weight"] = _conv_inv(flat[f"{fp}/kernel"])
        out[f"encoder.{idx}.bias"] = np.asarray(flat[f"{fp}/bias"])
    out["pool.centroids"] = np.asarray(
        flat["params/NetVLADLayer_0/centroids"])
    out["pool.conv.weight"] = _conv_inv(
        flat["params/NetVLADLayer_0/assign_conv/kernel"])
    return out


SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a",
                    "conv3b", "conv4a", "conv4b", "convPa", "convPb",
                    "convDa", "convDb")


def superpoint_state_dict(flat: Dict) -> Dict[str, np.ndarray]:
    """Flat SuperPointNet variables (as in superpoint_synth.npz) -> the
    state_dict of models.superpoint.SuperPointNet, whose keys are the
    MagicLeap names: `convert_superpoint` maps it back exactly."""
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(SUPERPOINT_CONVS):
        out[f"{name}.weight"] = _conv_inv(flat[f"params/Conv_{i}/kernel"])
        out[f"{name}.bias"] = np.asarray(flat[f"params/Conv_{i}/bias"])
    return out


def lightglue_state_dict(flat: Dict, num_layers: int
                         ) -> Dict[str, np.ndarray]:
    """Flat LightGlueNet variables (as in lightglue_synth.npz) -> the
    state_dict of models.lightglue.LightGlueNet, in the official
    cvg/LightGlue names with the one assignment head at
    `log_assignment.<num_layers - 1>`: `convert_lightglue` maps it back
    exactly."""
    out: Dict[str, np.ndarray] = {}

    def dense(flax_path, torch_key, bias=True):
        out[f"{torch_key}.weight"] = _dense_inv(
            flat[f"params/{flax_path}/kernel"])
        if bias:
            out[f"{torch_key}.bias"] = np.asarray(
                flat[f"params/{flax_path}/bias"])

    def layernorm(flax_path, torch_key):
        out[f"{torch_key}.weight"] = np.asarray(
            flat[f"params/{flax_path}/scale"])
        out[f"{torch_key}.bias"] = np.asarray(flat[f"params/{flax_path}/bias"])

    dense("posenc_Wr", "posenc.Wr", bias=False)
    if "params/input_proj/kernel" in flat:
        dense("input_proj", "input_proj")
    for i in range(num_layers):
        fp = f"transformers_{i}_self_attn"
        tp = f"transformers.{i}.self_attn"
        for name in ("Wqkv", "out_proj"):
            dense(f"{fp}/{name}", f"{tp}.{name}")
        fp = f"transformers_{i}_cross_attn"
        tp2 = f"transformers.{i}.cross_attn"
        for name in ("to_qk", "to_v", "to_out"):
            dense(f"{fp}/{name}", f"{tp2}.{name}")
        for f_, t_ in ((f"transformers_{i}_self_attn", tp),
                       (fp, tp2)):
            dense(f"{f_}/ffn_0", f"{t_}.ffn.0")
            layernorm(f"{f_}/ffn_1", f"{t_}.ffn.1")
            dense(f"{f_}/ffn_3", f"{t_}.ffn.3")
    last = f"log_assignment.{num_layers - 1}"
    dense("log_assignment/final_proj", f"{last}.final_proj")
    dense("log_assignment/matchability", f"{last}.matchability")
    return out


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A flat "a/b/c"-keyed .npz as a dict of numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        return {k: np.asarray(v) for k, v in data.items()}
