"""knn_search_us: host us per descriptor search, the port's `knn_search`
span (matching/descriptor_db.py) from the query's upload to the host
copy of its top-k."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    ms = per_call_ms(ctx, ["knn_search"])
    return None if ms is None else ms * 1e3
