"""stereo_depth_ms: host ms per frame of the stereo handler's
`stereo_depth` span (scan-line ZNCC of every keypoint and its depth,
ending in the copy to the host)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["stereo_depth"])
