"""Shipped model checkpoints.

The weights are the JAX package's self-trained `.npz` files
(`cslam_tpu/models/weights/`), read by path and never copied: the port
loads the same flat "params/..." arrays and maps them to its
`state_dict`s (`models/convert.py`). Externally trained checkpoints
take precedence when configured explicitly.
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(_REPO, "cslam_tpu", "models", "weights")

# the shipped lightglue_synth.npz is trained at this depth; configs that
# point at an external checkpoint use their own frontend.lightglue_layers
SHIPPED_LIGHTGLUE_LAYERS = 3


def shipped_checkpoint(name: str) -> str:
    """Absolute path of a shipped weights file, or "" when absent."""
    path = os.path.join(WEIGHTS_DIR, name)
    return path if os.path.exists(path) else ""
