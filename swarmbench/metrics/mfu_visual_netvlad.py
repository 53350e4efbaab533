"""mfu_visual_netvlad: the share of the card's peak that the NetVLAD
cell's network work would take: SuperPoint on every frame
(`roofline_visual.py`), NetVLAD with its projection on every image at
the shape its `descriptor_forward` spans carry (`roofline_netvlad.py`)
and LightGlue on every pair at its valid keypoint counts, each operation
over its precision's peak (bfloat16 989 TFLOP/s for the bfloat16
convolutions, float32 67 TFLOP/s for the rest), summed, over the traced
window's seconds, in percent."""

from swarmbench.metrics import _visual as v
from swarmbench.roofline_netvlad import image_layers
from swarmbench.roofline_visual import lightglue_layers, peak_seconds


def read(ctx):
    frames = v.counter(ctx, "frames")
    images = v.counter(ctx, "netvlad_images")
    shapes = [a for a in v.span_args(ctx, "descriptor_forward")
              if {"crop", "clusters", "pca_dim"} <= set(a)]
    if not frames or not images or not shapes or ctx.window_s <= 0:
        return None
    a = shapes[0]
    image = image_layers(int(a["crop"]), int(a["clusters"]),
                         int(a["pca_dim"]))
    s = frames * peak_seconds(v.superpoint_frame(ctx)) + \
        images * peak_seconds(image) + \
        sum(peak_seconds(lightglue_layers(*p))
            for p in v.lightglue_pairs(ctx) or [])
    return 100.0 * s / ctx.window_s
