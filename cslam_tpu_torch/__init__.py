"""cslam_tpu_torch — the PyTorch/CUDA port of cslam_tpu for NVIDIA Hopper.

The JAX package `cslam_tpu` is the reference; this package mirrors its
layout and public names (`ops/knn.py`, `sparsification/mac.py`,
`backend/pgo.py`, ...) so each module's counterpart is easy to find. It
imports `torch`, never `jax`, and nothing of `cslam_tpu`.

The one TPU kernel of the reference (the fused cosine top-k of
`cslam_tpu/ops/knn_pallas.py`) is a hand-written CUDA kernel here
(`csrc/cosine_topk.cu`, built with nvcc at first use by `_build.py`);
everything else is plain torch on device tensors.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a card they raise (see `device.py`).
"""

__version__ = "0.1.0"

from cslam_tpu_torch.utils.edges import Edge, EdgeInterRobot  # noqa: F401
