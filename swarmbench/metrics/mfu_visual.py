"""mfu_visual: the share of the card's peak that the window's network
work would take: SuperPoint on every frame, CosPlace on every image and
LightGlue on every pair at its valid keypoint counts
(`roofline_visual.py`), each operation over its precision's peak
(bfloat16 989 TFLOP/s for the bfloat16 convolutions, float32 67 TFLOP/s
for the rest), summed, over the traced window's seconds, in percent."""

from swarmbench.metrics import _visual as v
from swarmbench.roofline_visual import lightglue_layers, peak_seconds


def read(ctx):
    frames = v.counter(ctx, "frames")
    images = v.counter(ctx, "cosplace_images") or 0
    pairs = v.lightglue_pairs(ctx)
    if not frames or pairs is None or ctx.window_s <= 0:
        return None
    s = frames * peak_seconds(v.superpoint_frame(ctx)) + \
        images * peak_seconds(v.cosplace_image(ctx)) + \
        sum(peak_seconds(lightglue_layers(*p)) for p in pairs)
    return 100.0 * s / ctx.window_s
