"""mac_fw_ms: host ms of MAC's Frank-Wolfe solves per selection round:
the port's `mac_fw` spans (sparsification/mac.py, one per
`MAC.fw_subset` call) per `sparsification_select` span; None where the
program records no `mac_fw` span."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    if not (ctx.spans or {}).get("mac_fw"):
        return None
    return per_call_ms(ctx, ["mac_fw"], count_of="sparsification_select")
