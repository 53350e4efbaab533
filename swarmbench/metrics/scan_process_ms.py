"""scan_process_ms: host ms per lidar keyframe of the per-scan path: the
handler's `voxel_downsample` and the place model's
`scancontext_embedding` spans."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["voxel_downsample", "scancontext_embedding"])
