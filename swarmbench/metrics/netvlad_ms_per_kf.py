"""netvlad_ms_per_kf: host ms per image of NetVLAD's
`descriptor_preprocess` and `descriptor_forward` spans (host crop and
normalization, then the forward and projection ending in the copy of
the descriptors to the host), over the images the program's counter
`visual.netvlad_images` counts."""

from swarmbench.metrics._visual import counter


def read(ctx):
    spans = ctx.spans or {}
    images = counter(ctx, "netvlad_images")
    if not images:
        return None
    return 1e3 * sum(spans.get(n, {}).get("seconds", 0.0) for n in
                     ("descriptor_preprocess", "descriptor_forward")) / images
