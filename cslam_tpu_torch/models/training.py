"""Shared machinery of the port's trainers (train_superpoint,
train_lightglue, train_cosplace, train_netvlad).

The reference trainers each repeat three pieces inline; this module is
their one counterpart:

- the optimizer, `optax.adam(optax.cosine_decay_schedule(lr, steps,
  alpha))`: `CosineAdam` is `torch.optim.Adam` (Adam's update with the
  same b1, b2, eps and bias correction) under a closed-form `LambdaLR`
  whose factor at update t (the count before the update, from 0) is
  optax's `(1 - alpha) * 0.5 * (1 + cos(pi * min(t, T) / T)) + alpha`.
  The recursive `CosineAnnealingLR` would drift from it;
- saving: the reference's flat "/"-joined keys ("params/...",
  "batch_stats/...") written by `np.savez_compressed`, through
  `models/convert.py`'s torch -> Flax maps, so either package loads the
  file (`flat_variables`, `save_flat`);
- the default output directory, under the port's gitignored `_build/`
  (`default_out`): nothing a trainer writes lands in the reference's
  weights directory.

BatchNorm's train mode (Flax's batch statistics and running-stat
update) lives in `models/cosplace.BatchNorm`.
"""

import math
import os
import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch
from torch import nn

from cslam_tpu_torch.models import convert

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS_OUT = os.path.join(_PKG, "_build", "weights")


def default_out(name: str) -> str:
    """A trainer's default output path: `_build/weights/<name>`."""
    return os.path.join(WEIGHTS_OUT, name)


def cosine_decay_factor(steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule's multiplier of the initial rate at
    update count t."""
    def factor(t: int) -> float:
        t = min(t, steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / steps))
        return (1.0 - alpha) * cosine + alpha
    return factor


class CosineAdam:
    """Adam with optax's cosine-decay schedule over `steps` updates.

    `step()` applies one update at the current rate and then advances
    the schedule; `lr` is the rate the next update will use."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 steps: int, alpha: float):
        self.optimizer = torch.optim.Adam(list(params), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, cosine_decay_factor(steps, alpha))

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        self.optimizer.step()
        self.schedule.step()


def state_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """A module's state_dict as f32 numpy arrays on the host."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def flat_variables(model: nn.Module, kind: str,
                   num_layers: int = None) -> Dict[str, np.ndarray]:
    """A port model's weights in the reference's flat layout: `kind` is
    "superpoint", "lightglue" (with its `num_layers`), "cosplace"
    (params and batch_stats) or "netvlad"."""
    state = state_numpy(model)
    if kind == "superpoint":
        return convert.convert_superpoint(state)
    if kind == "lightglue":
        return convert.convert_lightglue(state, num_layers)
    if kind == "cosplace":
        return convert.convert_cosplace(state)
    if kind == "netvlad":
        return convert.convert_netvlad(state)
    raise ValueError(f"unknown model kind {kind!r}")


def save_flat(flat: Dict[str, np.ndarray], path: str):
    """Write flat "/"-keyed arrays as the reference trainers do."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def parameters_on(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def batch_to(batch, device: torch.device):
    """Host numpy arrays as tensors on `device` (float arrays as f32,
    integer arrays as int64 indices)."""
    out = []
    for a in batch:
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.to(torch.float32) if a.dtype.kind == "f" else t.to(torch.int64)
        out.append(t.to(device))
    return tuple(out)


class StepTimer:
    """Appends one step's milliseconds to `out`: CUDA events around the
    step on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device, out: list):
        self.device, self.out = device, out

    def __enter__(self):
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.end.record()
            self.end.synchronize()
            self.out.append(self.start.elapsed_time(self.end))
        else:
            self.out.append((time.perf_counter() - self.t) * 1e3)
        return False
