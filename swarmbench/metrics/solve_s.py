"""solve_s: wall seconds per pose-graph solve in the window, the
back-end's `pgo_solve` span around each solve on its worker thread."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    ms = per_call_ms(ctx, ["pgo_solve"])
    return None if ms is None else ms / 1e3
