"""cosine_topk_roofline: the least time of every descriptor search of the
traced window on an H100 (`roofline.knn_bound_s` of its shape: valid
rows, D, B = 1, k = 1, float32), over the device time of the port's
`topk_*` kernels in the trace, in percent."""

from swarmbench.profiling import TOPK_KERNEL
from swarmbench.roofline import knn_bound_s


def read(ctx):
    prof = ctx.profile
    if not prof or ctx.device.type != "cuda":
        return None
    device_s = sum(s for name, (_, s) in prof["kernels"].items()
                   if TOPK_KERNEL.search(name))
    lo, hi = ctx.records.search_window
    searches = ctx.records.searches[lo:hi]
    if device_s <= 0 or not searches:
        return None
    dim = int(ctx.cell.config["descriptor_dim"])
    bound = sum(knn_bound_s(s[3], dim, 1, 1, "float32") for s in searches)
    return 100.0 * bound / device_s
