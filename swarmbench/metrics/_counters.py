"""Shared arithmetic of the readers of the port's counters."""


def per_span(ctx, counter, key, span):
    """The summed `counter.key` of the tracer's counter events, per
    recorded `span`; None without either (also where the program keeps
    no counters)."""
    if ctx.spans is None:
        return None
    from cslam_tpu_torch.runtime.tracing import tracer
    totals = getattr(tracer, "counter_totals", None)
    if totals is None:
        return None
    value = totals().get(counter, {}).get(key)
    calls = ctx.spans.get(span, {}).get("count", 0)
    if value is None or not calls:
        return None
    return value / calls
