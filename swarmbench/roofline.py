"""Peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W) and the
least time of a cosine top-k search: a frozen copy of chip_smoke.py's
knn_bound_ms, in seconds."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def knn_bound_s(n_valid, dim, batch, k, dtype="float32"):
    """Least seconds of one search: the bytes it must move (valid rows,
    raw f32 queries, f32 row norms, the k (index, similarity) outputs)
    over HBM bandwidth against its 2 B n D operations over the dtype's
    peak; the larger bounds."""
    nbytes = (n_valid * dim * ELEMENT_BYTES[dtype] + batch * dim * 4
              + n_valid * 4 + batch * k * 8)
    flops = 2.0 * batch * n_valid * dim
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])

