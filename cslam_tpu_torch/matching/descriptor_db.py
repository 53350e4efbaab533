"""Device-resident global-descriptor database with cosine kNN search.

Port of cslam_tpu/matching/descriptor_db.py: add_item / search /
search_best / batch_search with the same return semantics (items sorted
by descending cosine similarity; min(k, n) results), a fixed-capacity
device buffer whose capacity doubles, and row norms kept in f32 from the
values as stored.

Adds are staged: `add_item` writes the row, rounded to the storage
dtype, and its norm into host staging buffers (pinned on a CUDA card)
and issues no device work. The stage holds 64 rows up to 128 KiB of
them (512-d float32), and at least 16 at any width (a gossip message
carries up to 10 descriptors): 16 rows, 256 KiB, at 4,096-d float32. The next read of the device buffer (a
search, `data`, capacity growth, or a full stage) uploads every
pending row in one copy. On a CUDA database searched by the kernel
("pallas"), a search of k <= KMAX is one native call on the database's
own non-blocking stream (`knn_pallas.CardSearch`): the pending rows, the
query, one pass of the kernel, the results back to the host, and a
synchronize of that stream alone. Every other search (a CPU database,
"exact" or "approx", k > KMAX) uploads the pending rows, then runs
torch ops on the current stream. The answers of the two paths are the
same bits: the same kernel, grid, inputs and norms.

A database is used by one thread at a time: its staging buffers,
workspaces and stream are not locked.

Host spans (`runtime/tracing.span`): `knn_add` per add, `knn_search` per
search from the query's upload (with the pending rows' before it) to
the host copy of its results. Counter `knn`: `native_searches` (served
by the single call), `fallback_searches` (torch ops), `flushes` and
`flushed_rows` (uploads of pending rows, and their rows).
"""

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.ops import knn
from cslam_tpu_torch.ops.knn_pallas import KMAX, CardSearch
from cslam_tpu_torch.runtime.tracing import span, tracer

_INITIAL_CAPACITY = 1024
# pending rows a database holds before it uploads them: the most, the
# fewest, and the bytes that bound them between the two
_STAGE_ROWS = 64
_STAGE_ROWS_MIN = 16
_STAGE_BYTES = 1 << 17
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bf16_bits(v: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even
    as torch rounds; NaN becomes a quiet NaN."""
    u = v.view(np.uint32)
    bits = ((u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16).astype(
        np.uint16)
    bits[np.isnan(v)] = 0x7FC0
    return bits


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
        self._flushed = 0  # rows on the device; n - _flushed are staged
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._card = None  # the single-call search, on the card
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

    def _on_stream(self):
        """Device work of the database's own goes on its stream."""
        return (contextlib.nullcontext() if self._stream is None
                else torch.cuda.stream(self._stream))

    def _sync(self):
        """Wait for the database's stream: every device write it issued
        has landed and its staging buffers are free again."""
        if self._stream is not None:
            self._stream.synchronize()

    def _alloc(self, dim: int):
        self.dim = dim
        row = dim * torch.finfo(self._dtype).bits // 8
        self._stage_rows = min(_STAGE_ROWS,
                               max(_STAGE_ROWS_MIN, _STAGE_BYTES // row))
        with self._on_stream():
            self._data = torch.zeros((self._capacity, dim),
                                     dtype=self._dtype, device=self.device)
            self._norms = torch.zeros((self._capacity,), dtype=torch.float32,
                                      device=self.device)
        pin = self._stream is not None
        self._stage = torch.empty((self._stage_rows, dim), dtype=self._dtype,
                                  pin_memory=pin)
        self._stage_norms = torch.empty((self._stage_rows,),
                                        dtype=torch.float32,
                                        pin_memory=pin)
        self._stage_np = (self._stage.numpy()
                          if self._dtype == torch.float32 else
                          self._stage.view(torch.int16).numpy().view(
                              np.uint16))
        self._stage_norms_np = self._stage_norms.numpy()
        if pin and self.method == "pallas":
            self._card = CardSearch(self._stream, self._dtype, dim)
        self._sync()
        self._bind()

    def _bind(self):
        if self._card is not None:
            self._card.bind(self._data, self._norms, self._stage,
                            self._stage_norms)

    def _adopt(self, data: np.ndarray, norms: np.ndarray, n: int,
               items: Dict[int, Any]):
        """Take a padded (capacity, dim) buffer of float32 values, its
        (capacity,) norms, n valid rows and their items, all uploaded."""
        with self._on_stream():
            self._data = torch.from_numpy(data).to(self.device).to(
                self._dtype)
            self._norms = torch.from_numpy(norms).to(self.device)
        self._sync()
        self._capacity = self._data.shape[0]
        self.n = self._flushed = int(n)
        self.items = dict(items)
        self._bind()

    def _flush(self):
        """Upload the staged rows and norms (one copy each) and wait."""
        rows = self.n - self._flushed
        if not rows:
            return
        f = self._flushed
        with self._on_stream():
            self._data[f:self.n].copy_(self._stage[:rows], non_blocking=True)
            self._norms[f:self.n].copy_(self._stage_norms[:rows],
                                        non_blocking=True)
        self._sync()
        self._flushed = self.n
        tracer.counter("knn", flushes=1, flushed_rows=rows)

    def _grow(self):
        """Double the capacity, pending rows uploaded first."""
        self._flush()
        self._capacity *= 2
        with self._on_stream():
            self._data = knn.grow(self._data, self._capacity)
            self._norms = torch.cat(
                [self._norms, torch.zeros((self._capacity // 2,),
                                          dtype=torch.float32,
                                          device=self.device)])
        self._sync()
        self._bind()

    def __len__(self):
        return self.n

    @property
    def data(self):
        """Device tensor view (including padding rows), every added row
        uploaded."""
        self._flush()
        return self._data

    def add_item(self, vector, item):
        """Add a descriptor with its identification info (e.g. keyframe id)."""
        with span("knn_add", rows=self.n):
            vector = np.asarray(vector, dtype=np.float32).reshape(-1)
            if self._data is None:
                self._alloc(vector.shape[0])
            if vector.shape[0] != self.dim:
                raise ValueError(f"descriptor dim {vector.shape[0]} != "
                                 f"database dim {self.dim}")
            if self.n >= self._capacity:
                self._grow()
            elif self.n - self._flushed == self._stage_rows:
                self._flush()
            j = self.n - self._flushed
            if self._dtype == torch.float32:
                self._stage_np[j] = stored = vector
            else:
                bits = bf16_bits(vector)
                self._stage_np[j] = bits
                stored = (bits.astype(np.uint32) << 16).view(np.float32)
            # norm of the values as stored (bf16-rounded when applicable)
            self._stage_norms_np[j] = np.linalg.norm(stored)
            self.items[self.n] = item
            self.n += 1

    def _search(self, queries, k: int):
        """Host (B, min(k, n)) indices and sims of a non-empty database."""
        q = np.ascontiguousarray(
            np.asarray(queries, dtype=np.float32).reshape(-1, self.dim))
        k_eff, kp = min(k, self.n), min(k, self._capacity)
        rows = self.n - self._flushed
        native = self._card is not None and kp <= KMAX
        with span("knn_search", rows=self.n, batch=q.shape[0], k=k):
            if native:
                idx, sims = self._card.search(q, self.n, kp, self._flushed,
                                              rows)
                self._flushed = self.n
                out = idx[:, :k_eff].copy(), sims[:, :k_eff].copy()
            else:
                out = self._search_torch(q, kp, k_eff)
        if native:
            tracer.counter("knn", native_searches=1, flushes=int(rows > 0),
                           flushed_rows=rows)
        else:
            tracer.counter("knn", fallback_searches=1)
        return out

    def _search_torch(self, q: np.ndarray, kp: int, k_eff: int):
        """The search in torch ops on the current stream."""
        self._flush()
        return _to_host(*self._topk(torch.from_numpy(q).to(self.device),
                                    kp), k_eff)

    def search(self, query, k: int) -> Tuple[List[Any], np.ndarray]:
        """k nearest items by cosine similarity, descending.

        Returns ([], []) when empty, otherwise (items, similarities) of
        length min(k, n)."""
        if self.n == 0:
            return [], np.array([])
        idx, sims = self._search(query, k)
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
        idx, sims = self._search(queries, k)
        items = [[self.items[int(i)] for i in row] for row in idx]
        return items, sims
