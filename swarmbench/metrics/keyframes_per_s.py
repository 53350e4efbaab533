"""keyframes_per_s: every robot's keyframes the swarm took in the window,
over the window's wall seconds (all stalls included)."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.keyframes:
        return None
    return ctx.keyframes / ctx.window_s
