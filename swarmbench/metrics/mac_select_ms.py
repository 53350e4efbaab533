"""mac_select_ms: host ms per MAC selection round, the
`sparsification_select` span (frontend/loop_closure_detection.py)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["sparsification_select"])
