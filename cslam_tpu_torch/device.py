"""Device selection: CUDA unless the caller asks for the CPU.

Every entry point of the port takes a `device` argument. The default is
the CUDA card, and a missing card is an error, never a quiet fall-back
to the CPU: a run that claims to be on the card is on the card.

Full fp32 on the card: the reference's Fiedler gate dots are HIGHEST
precision (cslam_tpu/ops/fiedler.py), reduced-precision dots cost MAC
selection quality, and the place-recognition models' f32 layers
(NetVLAD's assignment conv and pooling, the descriptor heads, every
conv at dtype=float32) are f32 in the reference. On Hopper the reduced
mode is TF32, for matrix products (`torch.backends.cuda.matmul.
allow_tf32`, off by default) and for cuDNN convolutions
(`torch.backends.cudnn.allow_tf32`, ON by default), so the port turns
both off and checks both where the precision matters.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Raises RuntimeError for a CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def require_full_fp32(device: DeviceLike = None):
    """Raise if fp32 matrix products or convolutions may run in TF32 on
    `device`. A CPU device has no TF32 mode and passes; None checks the
    flags whatever the device."""
    if device is not None and torch.device(device).type != "cuda":
        return
    for name, on in (
            ("torch.backends.cuda.matmul.allow_tf32",
             torch.backends.cuda.matmul.allow_tf32),
            ("torch.backends.cudnn.allow_tf32",
             torch.backends.cudnn.allow_tf32)):
        if on:
            raise RuntimeError(
                f"{name} is on: the port's fp32 products and convolutions "
                f"(Fiedler, PGO, the descriptor models) need full fp32")

