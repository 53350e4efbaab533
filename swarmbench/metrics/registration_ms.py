"""registration_ms: host ms per loop-closure registration in the lidar
handler: its `scancontext` (the yaw seed), `fpfh`, `ransac_3d3d` and
`gnc_icp` spans, per `fpfh` span (one per registration)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["fpfh", "ransac_3d3d", "gnc_icp", "scancontext"],
                       count_of="fpfh")
