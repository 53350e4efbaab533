"""feature_extract_ms: host ms per frame of the handler's
`feature_extract` span (SuperPoint's forward and keypoint selection,
ending in the copy of the keypoints to the host)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["feature_extract"])
