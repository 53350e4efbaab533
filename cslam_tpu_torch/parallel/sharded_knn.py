"""Descriptor kNN sharded over a mesh.

Port of cslam_tpu/parallel/sharded_knn.py. The database rows are
sharded across the ranks and the queries replicated. Each rank computes
the cosine top-k of its shard (rows valid in global order, so a shard
holds `clip(n_valid - row0, 0, shard_rows)` valid rows), offsets the
indices by the shard's first row, and the per-shard winners are
all-gathered, (B, d, k), and reduced to the global top-k with
`lax.top_k`'s order (descending, equal values in position order:
`ops/knn.topk_desc`).

On the card every rank searches its shard with the hand-written kernel
(`ops/knn_pallas.cosine_topk_pallas`, one launch per search of
k <= 64, counted per process); on the CPU with `ops/knn.cosine_topk`,
the exact path the reference's shard body runs. The kernel marks a
missing slot (past the shard's valid rows) with -3e38 and row 0; the
reference's path has -inf there and, since equal -inf values keep row
order, row = slot. Such slots are rewritten to that convention before
the merge, so a shard with fewer than k valid rows can never put a
-3e38 ahead of another shard's -inf.
"""

import torch

from cslam_tpu_torch.ops import knn
from cslam_tpu_torch.parallel.mesh import Collectives, ShardedRows, \
    SwarmMesh


def kernel_slots_to_reference(idx, sims, local_valid: int):
    """The kernel's (B, k) result with its missing slots (slot >=
    local_valid: -3e38, row 0) in the reference's convention (-inf,
    row = slot)."""
    slot = torch.arange(idx.shape[1], device=idx.device, dtype=idx.dtype)
    missing = (slot >= local_valid)[None, :]
    return (torch.where(missing, slot[None, :], idx),
            torch.where(missing, float("-inf"), sims))


def shard_topk(shard, norms, local_valid: int, queries, k: int):
    """(B, k) shard-local (indices, sims) in the reference's convention;
    the kernel on the card, the exact path on the CPU."""
    if not shard.is_cuda:
        return knn.cosine_topk(shard, local_valid, queries, k)
    B = queries.shape[0]
    if local_valid == 0:  # nothing to search on this shard
        return kernel_slots_to_reference(
            torch.zeros((B, k), dtype=torch.int32, device=shard.device),
            torch.zeros((B, k), device=shard.device), 0)
    from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
    idx, sims = cosine_topk_pallas(shard, local_valid, queries, k,
                                   data_norms=norms)
    return kernel_slots_to_reference(idx, sims, local_valid)


def _search(col: Collectives, handle, n_valid, k, q_shape, queries=None):
    shard, norms = col.objects[handle]
    rows = shard.shape[0]
    q = col.broadcast(queries, q_shape, torch.float32)
    row0 = col.rank * rows
    local_valid = min(max(n_valid - row0, 0), rows)
    idx, sims = shard_topk(shard, norms, local_valid, q, k)
    all_idx = col.all_gather(idx + row0)  # (d, B, k)
    all_sims = col.all_gather(sims)
    if col.rank:
        return None
    B = q_shape[0]
    all_idx = all_idx.permute(1, 0, 2).reshape(B, col.size * k)
    all_sims = all_sims.permute(1, 0, 2).reshape(B, col.size * k)
    top_sims, pos = knn.topk_desc(all_sims, k)
    return torch.gather(all_idx, 1, pos), top_sims


def sharded_cosine_topk(mesh: SwarmMesh, data, n_valid, queries, k: int,
                        axis_name: str = "shard"):
    """Top-k cosine similarity over a row-sharded database.

    Args:
      mesh: 1-D mesh (`make_swarm_mesh`).
      data: (N_cap, D) database, N_cap divisible by the mesh size: a
        whole tensor (sharded for this call) or a `mesh.place_rows`
        handle (placed once, not sent again).
      n_valid: valid rows in [0, N_cap), counted globally.
      queries: (B, D) queries, replicated.
      k: neighbours per query, k <= N_cap / d.

    Returns (indices, sims): (B, k) int32 global rows and float32
    similarities on rank 0's device.
    """
    shard_rows = data.shape[0] // mesh.shape[axis_name]
    if k > shard_rows:
        raise ValueError(f"k={k} exceeds the {shard_rows} rows of a shard")
    placed = data if isinstance(data, ShardedRows) else \
        mesh.place_rows(data)
    queries = torch.as_tensor(queries).to(mesh.device, torch.float32)
    out, _ = mesh.run(_search, placed.handle, int(n_valid), int(k),
                      tuple(queries.shape), local={"queries": queries})
    if placed is not data:  # placed for this call only
        placed.free()
    return out
