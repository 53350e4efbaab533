"""detection_round_ms: host ms of one inter-robot detection round, all
robots' `inter_robot_detection` spans (node.py) summed per round."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    ms = per_call_ms(ctx, ["inter_robot_detection"])
    if ms is None:
        return None
    return ms * ctx.run.rec.n_robots
