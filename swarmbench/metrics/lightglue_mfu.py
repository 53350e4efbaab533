"""lightglue_mfu: LightGlue's operations in the window at the pairs'
valid keypoint counts (`roofline_visual.lightglue_macs`) over the
float32 peak (67 TFLOP/s), over the summed seconds of the
`lightglue_match` spans (each ends in a host copy, so it holds the
device time), in percent."""

from swarmbench.metrics import _visual as v
from swarmbench.roofline_visual import lightglue_layers, peak_seconds


def read(ctx):
    pairs = v.lightglue_pairs(ctx)
    spent = (ctx.spans or {}).get("lightglue_match", {}).get("seconds", 0.0)
    if pairs is None or spent <= 0:
        return None
    return 100.0 * sum(peak_seconds(lightglue_layers(*p))
                       for p in pairs) / spent
