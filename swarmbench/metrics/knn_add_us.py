"""knn_add_us: host us per descriptor added to a database, the port's
`knn_add` span (matching/descriptor_db.py: the row and its norm written
to the device)."""

from swarmbench.metrics._spans import per_call_ms


def read(ctx):
    ms = per_call_ms(ctx, ["knn_add"])
    return None if ms is None else ms * 1e3
