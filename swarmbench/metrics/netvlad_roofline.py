"""netvlad_roofline: the least time of every NetVLAD batch of the traced
window on an H100 (`roofline_netvlad.batch_bound_s` at the shape its
`descriptor_forward` span carries: images, crop, clusters, pca_dim),
over the summed seconds of those spans (each ends in the descriptors'
host copy, so it holds the device time), in percent. None where a span
carries no shape."""

from swarmbench.metrics._visual import span_args
from swarmbench.roofline_netvlad import batch_bound_s

SHAPE = ("images", "crop", "clusters", "pca_dim")


def read(ctx):
    spent = (ctx.spans or {}).get("descriptor_forward", {}).get("seconds",
                                                                0.0)
    batches = span_args(ctx, "descriptor_forward")
    if spent <= 0 or not batches or \
            not all(set(SHAPE) <= set(a) for a in batches):
        return None
    bound = sum(batch_bound_s(*(int(a[k]) for k in SHAPE)) for a in batches)
    return 100.0 * bound / spent
