"""cg_iters_per_solve: conjugate-gradient iterations per pose-graph
solve, the port's counter `pgo.cg_iters` (backend/pgo.py
`gnc_optimize`, every LM step's PCG iterations; 0 on the dense path)
per `pgo_solve` span."""

from swarmbench.metrics._counters import per_span


def read(ctx):
    return per_span(ctx, "pgo", "cg_iters", "pgo_solve")
