"""device_idle_share: the share of the traced window in which no
operation ran on the device (the union of the trace's device intervals),
in percent."""


def read(ctx):
    prof = ctx.profile
    if not prof or prof["window_s"] <= 0 or ctx.device.type != "cuda":
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
