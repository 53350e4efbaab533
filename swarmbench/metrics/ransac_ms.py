"""ransac_ms: host ms per RANSAC call of the handler's `ransac_3d3d` and
`ransac_pnp` spans (each ending in the copy of its result to the
host)."""


def read(ctx):
    spans = ctx.spans or {}
    names = ("ransac_3d3d", "ransac_pnp")
    calls = sum(spans.get(n, {}).get("count", 0) for n in names)
    if not calls:
        return None
    return 1e3 * sum(spans.get(n, {}).get("seconds", 0.0)
                     for n in names) / calls
