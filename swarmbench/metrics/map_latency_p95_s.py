"""map_latency_p95_s: 95th percentile, over every keyframe fed in the
window, of the wall seconds from its feed until the robot that took it
adopts a shared optimized estimate that contains it (keyframes never
covered are the run's `failed`)."""

import numpy as np


def read(ctx):
    if not ctx.run.latency or not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies, np.float64), 95))
