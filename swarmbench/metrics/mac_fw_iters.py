"""mac_fw_iters: Frank-Wolfe iterations per selection round, the port's
counter `mac.fw_iters` (sparsification/mac.py, each `MAC.fw_subset`
call's iterations) per `sparsification_select` span."""

from swarmbench.metrics._counters import per_span


def read(ctx):
    return per_span(ctx, "mac", "fw_iters", "sparsification_select")
