"""Device selection: CUDA unless the caller asks for the CPU.

Every entry point of the port takes a `device` argument. The default is
the CUDA card, and a missing card is an error, never a quiet fall-back
to the CPU: a run that claims to be on the card is on the card.

Full fp32 matrix products: the reference's Fiedler gate dots are
HIGHEST precision (cslam_tpu/ops/fiedler.py), and reduced-precision
dots cost MAC selection quality. On Hopper the reduced mode is TF32, so
the port keeps `torch.backends.cuda.matmul.allow_tf32` off and checks it
where the precision matters.
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
    return dev


def require_full_fp32():
    """Raise if fp32 matrix products may run in TF32 on the card."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the Fiedler and "
            "PGO solvers need full fp32 products")

