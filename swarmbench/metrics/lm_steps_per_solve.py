"""lm_steps_per_solve: Levenberg-Marquardt steps per pose-graph solve,
the port's counter `pgo.lm_steps` (backend/pgo.py `gnc_optimize`: initial,
GNC and polishing steps) per `pgo_solve` span."""

from swarmbench.metrics._counters import per_span


def read(ctx):
    return per_span(ctx, "pgo", "lm_steps", "pgo_solve")
