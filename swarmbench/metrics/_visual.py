"""Shared arithmetic of the stereo cells' readers: the work of the
window's network calls, from the program's counter `visual` and the
args of its `lightglue_match` spans."""

import json
import os
import tempfile

from swarmbench.roofline_visual import cosplace_layers, superpoint_layers


def counter(ctx, key):
    """The summed `visual.key` of the traced window; None where the
    program keeps no such counter."""
    if ctx.spans is None:
        return None
    from cslam_tpu_torch.runtime.tracing import tracer
    totals = getattr(tracer, "counter_totals", None)
    if totals is None:
        return None
    return totals().get("visual", {}).get(key)


def span_args(ctx, name):
    """[args dict] of every recorded span `name` of the traced window;
    [] where nothing was traced. The tracer's events are read once per
    run (dumped to a file under TMPDIR): its totals keep only counts and
    seconds."""
    if ctx.spans is None:
        return []
    cache = ctx.__dict__.setdefault("_span_events", [])
    if not cache:
        from cslam_tpu_torch.runtime.tracing import tracer
        fd, path = tempfile.mkstemp(suffix=".json", prefix="swarmbench_args_")
        os.close(fd)
        try:
            tracer.dump(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        cache.append([e for e in events if e.get("ph") == "X"])
    return [e.get("args", {}) for e in cache[0] if e["name"] == name]


def lightglue_pairs(ctx):
    """[(valid0, valid1, layers)] of the window's LightGlue calls; None
    where the spans carry no keypoint counts."""
    pairs = [(a["valid0"], a["valid1"], a["layers"])
             for a in span_args(ctx, "lightglue_match")
             if {"valid0", "valid1", "layers"} <= set(a)]
    return pairs or None


def superpoint_frame(ctx):
    cam = ctx.cell.config["camera"]
    return superpoint_layers(int(cam["height"]), int(cam["width"]))


def cosplace_image(ctx):
    s = ctx.cell.config["settings"]
    return cosplace_layers(int(s["frontend.image_crop_size"]),
                           int(s["frontend.global_descriptor_dim"]))
