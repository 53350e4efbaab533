"""Device-resident global-descriptor database with cosine kNN search.

Port of cslam_tpu/matching/descriptor_db.py: add_item / search /
search_best / batch_search with the same return semantics (items sorted
by descending cosine similarity; min(k, n) results), a fixed-capacity
device buffer whose capacity doubles, and row norms kept in f32 from the
values as stored.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.ops import knn

_INITIAL_CAPACITY = 1024
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_host(idx, sims, k_eff: int):
    """The first k_eff columns of (B, k) int32 indices and float32 sims
    as numpy, in one device-to-host copy (sims travel as int32 bits)."""
    both = torch.cat([idx[:, :k_eff], sims[:, :k_eff].view(torch.int32)],
                     dim=1).cpu().numpy()
    return both[:, :k_eff], both[:, k_eff:].view(np.float32)


class DescriptorDatabase:
    """Append-only descriptor store with brute-force cosine kNN."""

    def __init__(self, dim=None, capacity: int = _INITIAL_CAPACITY,
                 method: str = "auto", storage: str = "float32",
                 device: DeviceLike = None):
        """method: "exact" (stable top-k over the full similarity row),
        "approx" (the reference's approximate search; exact here, see
        ops/knn.cosine_topk_approx), "pallas" (the hand-written CUDA
        kernel of ops/knn_pallas.py; its plain version on the CPU), or
        "auto" ("pallas" on a CUDA device, else "exact").

        storage: "float32" or "bfloat16"; norms stay f32, computed from
        the rounded values actually stored.

        device: where the database lives; None means the CUDA card (and
        raises without one)."""
        if method not in ("auto", "exact", "approx", "pallas"):
            raise ValueError(f"unknown search method: {method!r}")
        if storage not in _DTYPES:
            raise ValueError(f"unknown storage dtype: {storage!r}")
        self.device = resolve_device(device)
        if method == "auto":
            method = "pallas" if self.device.type == "cuda" else "exact"
        self.n = 0
        self.dim = dim
        self.method = method
        self._dtype = _DTYPES[storage]
        self.items: Dict[int, Any] = {}
        self._capacity = capacity
        self._data = None
        self._norms = None
        if dim is not None:
            self._alloc(dim)

    def _topk(self, queries, k):
        if self.method == "pallas":
            from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
            return cosine_topk_pallas(self._data, self.n, queries, k,
                                      data_norms=self._norms)
        fn = (knn.cosine_topk if self.method == "exact"
              else knn.cosine_topk_approx)
        return fn(self._data, self.n, queries, k, data_norms=self._norms)

    def _alloc(self, dim: int):
        self.dim = dim
        self._data = torch.zeros((self._capacity, dim), dtype=self._dtype,
                                 device=self.device)
        self._norms = torch.zeros((self._capacity,), dtype=torch.float32,
                                  device=self.device)

    def __len__(self):
        return self.n

    @property
    def data(self):
        """Device tensor view (including padding rows)."""
        return self._data

    def add_item(self, vector, item):
        """Add a descriptor with its identification info (e.g. keyframe id)."""
        vector = np.asarray(vector, dtype=np.float32).reshape(-1)
        if self._data is None:
            self._alloc(vector.shape[0])
        if vector.shape[0] != self.dim:
            raise ValueError(
                f"descriptor dim {vector.shape[0]} != database dim {self.dim}")
        if self.n >= self._capacity:
            self._capacity *= 2
            self._data = knn.grow(self._data, self._capacity)
            self._norms = torch.cat(
                [self._norms, torch.zeros((self._capacity // 2,),
                                          dtype=torch.float32,
                                          device=self.device)])
        row = torch.from_numpy(vector).to(self._dtype)
        # norm of the values as stored (bf16-rounded when applicable)
        norm = float(np.linalg.norm(row.float().numpy()))
        knn.set_row(self._data, self.n, row)
        self._norms[self.n] = norm
        self.items[self.n] = item
        self.n += 1

    def _query_tensor(self, queries):
        q = np.asarray(queries, dtype=np.float32).reshape(-1, self.dim)
        return torch.from_numpy(q).to(self.device)

    def search(self, query, k: int) -> Tuple[List[Any], np.ndarray]:
        """k nearest items by cosine similarity, descending.

        Returns ([], []) when empty, otherwise (items, similarities) of
        length min(k, n)."""
        if self.n == 0:
            return [], np.array([])
        idx, sims = _to_host(*self._topk(self._query_tensor(query),
                                         min(k, self._capacity)),
                             min(k, self.n))
        return [self.items[int(i)] for i in idx[0]], sims[0]

    def search_best(self, query):
        """Single nearest item; (None, None) when empty."""
        if self.n == 0:
            return None, None
        items, sims = self.search(query, 1)
        return items[0], sims[0]

    def batch_search(self, queries, k: int):
        """Batched search: (B, dim) queries -> (B, k') items and sims."""
        if self.n == 0:
            return [], np.zeros((0, 0))
        idx, sims = _to_host(*self._topk(self._query_tensor(queries),
                                         min(k, self._capacity)),
                             min(k, self.n))
        items = [[self.items[int(i)] for i in row] for row in idx]
        return items, sims
