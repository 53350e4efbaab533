"""How far f32 training gradients are from float64 ones, per setting.

    python -m cslam_tpu_torch.tools.grad_precision [superpoint,netvlad,...]
        [--cpu-only]

For each trainer, one step's gradients on chip_smoke.py's parity batch
(`chip_smoke._parity_case`: the reference CLI's shapes, Flax-default
random weights) are computed at f32 under several settings (the CPU
with oneDNN off and on; the card with cuDNN's default, deterministic,
benchmark-chosen algorithms and with cuDNN off) and held against the
float64 gradient of the same step on the card (`chip_smoke.
_float64_gradient`; on the CPU with --cpu-only). Prints one JSON line
per trainer: each setting's four worst tensors (relative norm of the
difference) and the card-vs-CPU worst tensors. TF32 stays off in every
card setting. chip_smoke's PARITY_F32_SPREAD comes from this spread.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _grads(chip_smoke, name, model, batch, device, lr):
    model = copy.deepcopy(model).to(device)
    _, step = chip_smoke._trainer(name).build_train_step(model, lr, 10)
    step(*batch)
    return {k: p.grad.detach().cpu().numpy()
            for k, p in model.named_parameters()}


def settings_of(chip_smoke, name, model, batch, lr, cpu_only):
    """{setting: {tensor: f32 gradient}}."""
    out = {}
    with torch.backends.mkldnn.flags(enabled=False):
        out["cpu_onednn_off"] = _grads(chip_smoke, name, model, batch,
                                       "cpu", lr)
    with torch.backends.mkldnn.flags(enabled=True):
        out["cpu_onednn_on"] = _grads(chip_smoke, name, model, batch,
                                      "cpu", lr)
    if cpu_only:
        return out
    flags = torch.backends.cudnn.flags
    for setting, kw in (("cuda_default", None),
                        ("cuda_deterministic", dict(deterministic=True)),
                        ("cuda_benchmark", dict(benchmark=True)),
                        ("cuda_no_cudnn", dict(enabled=False))):
        if kw is None:
            out[setting] = _grads(chip_smoke, name, model, batch, "cuda",
                                  lr)
            continue
        kw = dict(dict(enabled=True, benchmark=False, deterministic=False,
                       allow_tf32=False), **kw)
        with flags(**kw):
            out[setting] = _grads(chip_smoke, name, model, batch, "cuda",
                                  lr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trainers", nargs="?",
                    default="superpoint,lightglue,cosplace,netvlad")
    ap.add_argument("--cpu-only", action="store_true",
                    help="no card: the CPU settings, float64 on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke
    from cslam_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu_only else None)
    for name in args.trainers.split(","):
        model, batch, lr = chip_smoke._parity_case(
            name, np.random.default_rng(chip_smoke.SEED))
        g64 = chip_smoke._float64_gradient(name, model, batch, device)
        grads = settings_of(chip_smoke, name, model, batch, lr,
                            args.cpu_only)
        res = {}
        for setting, g in grads.items():
            errs = sorted(((k, _rel(g[k], g64[k])) for k in g64),
                          key=lambda kv: -kv[1])
            res[setting] = errs[:4]
        if not args.cpu_only:
            card, cpu = grads["cuda_default"], grads["cpu_onednn_off"]
            res["card_vs_cpu"] = sorted(
                ((k, _rel(card[k], cpu[k])) for k in cpu),
                key=lambda kv: -kv[1])[:4]
        print(json.dumps({"trainer": name, "worst_vs_float64": res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
