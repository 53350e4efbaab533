"""Shared arithmetic of the readers of host spans."""


def per_call_ms(ctx, names, count_of=None):
    """Summed host seconds of the spans `names`, in ms per call of the
    span `count_of` (the first name by default); None without calls."""
    spans = ctx.spans or {}
    calls = spans.get(count_of or names[0], {}).get("count", 0)
    if not calls:
        return None
    total = sum(spans.get(n, {}).get("seconds", 0.0) for n in names)
    return 1e3 * total / calls
