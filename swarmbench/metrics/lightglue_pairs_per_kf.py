"""lightglue_pairs_per_kf: LightGlue pairs (keyframe gating and loop
verification), the program's counter `visual.lightglue_pairs`, per frame
fed to a handler (`visual.frames`) in the traced window."""

from swarmbench.metrics._visual import counter


def read(ctx):
    pairs, frames = counter(ctx, "lightglue_pairs"), counter(ctx, "frames")
    if pairs is None or not frames:
        return None
    return pairs / frames
