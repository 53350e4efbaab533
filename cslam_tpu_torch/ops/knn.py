"""Batched cosine-similarity k-nearest-neighbor search ops.

Port of cslam_tpu/ops/knn.py. Similarities are one matrix product with
float32 accumulation (bf16 databases are widened first: a bf16 x bf16
product is exact in float32), invalid (padded) rows are masked to -inf,
and top-k keeps `lax.top_k`'s order: descending, ties to the lower row.

All functions are plain functions on tensors; the device is the data's.
"""

import torch

NEG_INF = float("-inf")


def topk_desc(x: torch.Tensor, k: int):
    """Top-k along the last axis, descending, equal values in index order
    (the tie rule of `lax.top_k`, which `torch.topk` does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _row_norms(data):
    return torch.linalg.vector_norm(data.float(), dim=-1)


def _masked_sims(data, n_valid, queries, data_norms):
    queries = queries.to(data.dtype)
    if data_norms is None:
        data_norms = _row_norms(data)
    q_norm = torch.linalg.vector_norm(queries.float(), dim=-1)
    dots = queries.float() @ data.float().T
    denom = torch.clamp(q_norm[:, None] * data_norms.float()[None, :],
                        min=1e-12)
    sims = dots / denom
    rows = torch.arange(data.shape[0], device=data.device)
    return torch.where(rows[None, :] < int(n_valid), sims,
                       torch.full_like(sims, NEG_INF))


def cosine_topk(data, n_valid, queries, k: int, data_norms=None):
    """Top-k cosine similarity of each query against data[:n_valid].

    Args:
      data: (N_cap, D) float32 or bfloat16 database; rows >= n_valid are
        padding and never returned.
      n_valid: number of valid rows.
      queries: (B, D) queries (cast to the database dtype, as the
        reference does).
      k: number of neighbors (k <= N_cap).
      data_norms: optional (N_cap,) row norms of the stored values.

    Returns (indices, sims): (B, k) int32 and (B, k) float32, sorted
    descending; entries past min(k, n_valid) have sims == -inf.
    """
    sims = _masked_sims(data, n_valid, queries, data_norms)
    top_sims, top_idx = topk_desc(sims, k)
    return top_idx.to(torch.int32), top_sims


def cosine_topk_blocked(data, n_valid, queries, k: int, data_norms=None,
                        block: int = 8192):
    """Exact top-k via two-stage blocked selection (top-k within N/block
    column blocks, then over the survivors)."""
    N = data.shape[0]
    B = queries.shape[0]
    if N % block != 0 or N <= block:
        return cosine_topk(data, n_valid, queries, k, data_norms=data_norms)
    sims = _masked_sims(data, n_valid, queries, data_norms)
    G = N // block
    blk_sims, blk_idx = topk_desc(sims.reshape(B * G, block), k)
    offs = (torch.arange(G, device=data.device) * block).repeat_interleave(k)
    cand_idx = blk_idx.reshape(B, G * k) + offs[None, :]
    cand_sims = blk_sims.reshape(B, G * k)
    top_sims, pos = topk_desc(cand_sims, k)
    top_idx = torch.gather(cand_idx, 1, pos)
    return top_idx.to(torch.int32), top_sims


def cosine_topk_streamed(data, n_valid, queries, k: int, data_norms=None,
                         block: int = 16384):
    """Exact top-k that walks the database in (block, D) slabs and keeps
    a running (B, k) merge, never holding the full (B, N) matrix."""
    N, D = data.shape
    if N % block != 0 or N <= block:
        return cosine_topk(data, n_valid, queries, k, data_norms=data_norms)
    B = queries.shape[0]
    queries = queries.to(data.dtype)
    if data_norms is None:
        data_norms = _row_norms(data)
    q_norm = torch.linalg.vector_norm(queries.float(), dim=-1)
    qf = queries.float()
    col = torch.arange(block, device=data.device)
    best_s = torch.full((B, k), NEG_INF, device=data.device)
    best_i = torch.zeros((B, k), dtype=torch.int64, device=data.device)
    for g in range(N // block):
        off = g * block
        blk = data[off:off + block].float()
        nb = data_norms[off:off + block].float()
        sims = (qf @ blk.T) / torch.clamp(q_norm[:, None] * nb[None, :],
                                          min=1e-12)
        ids = off + col
        sims = torch.where(ids[None, :] < int(n_valid), sims,
                           torch.full_like(sims, NEG_INF))
        s, i = topk_desc(sims, k)
        gi = ids[i]
        cs = torch.cat([best_s, s], dim=1)
        ci = torch.cat([best_i, gi], dim=1)
        best_s, pos = topk_desc(cs, k)
        best_i = torch.gather(ci, 1, pos)
    return best_i.to(torch.int32), best_s


def cosine_topk_approx(data, n_valid, queries, k: int, data_norms=None,
                       recall_target: float = 0.95):
    """The reference's approximate top-k (`lax.approx_max_k`, recall
    ~0.95) has no PyTorch counterpart; this port returns the EXACT
    top-k, whose recall 1.0 meets any `recall_target`."""
    del recall_target
    return cosine_topk(data, n_valid, queries, k, data_norms=data_norms)


def grow(data, new_capacity: int):
    """Copy into a larger zero-padded buffer (capacity doubling)."""
    pad = new_capacity - data.shape[0]
    return torch.cat([data, torch.zeros((pad, data.shape[1]),
                                        dtype=data.dtype,
                                        device=data.device)], dim=0)


def cross_similarity(data_a, n_a, data_b, n_b):
    """Full (N_a, N_b) cosine-similarity matrix, padding masked to -inf."""
    a = data_a.float()
    b = data_b.float()
    an = torch.linalg.vector_norm(a, dim=-1)
    bn = torch.linalg.vector_norm(b, dim=-1)
    sims = (a @ b.T) / torch.clamp(an[:, None] * bn[None, :], min=1e-12)
    rows = torch.arange(a.shape[0], device=a.device)
    cols = torch.arange(b.shape[0], device=a.device)
    mask = (rows[:, None] < int(n_a)) & (cols[None, :] < int(n_b))
    return torch.where(mask, sims, torch.full_like(sims, NEG_INF))
