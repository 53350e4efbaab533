"""lightglue_ms: host ms per pair of the handler's `lightglue_match`
span (LightGlue's forward and mutual matching, ending in the copy of the
matches to the host)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, ["lightglue_match"])
