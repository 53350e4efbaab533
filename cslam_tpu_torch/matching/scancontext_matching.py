"""Scan Context database: two-stage rotation-invariant matching.

Port of cslam_tpu/matching/scancontext_matching.py (the Swarm-SLAM
reference's ScanContextMatching): add_item / search / search_best;
stage 1 = the ring keys' nearest neighbours (brute-force top-k), stage
2 = the full 60-shift circular cosine distance over the shortlist,
returning the single best item and similarity = 1 - distance. The Scan
Contexts and ring keys stay on `device` (None = the CUDA card) in
buffers that double when full; a search brings its shortlist and
distances back to the host in one copy.
"""

from typing import Any, Dict

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.ops import scancontext as sc_ops

_INITIAL_CAPACITY = 1024


class ScanContextMatching:

    def __init__(self, shape=(20, 60), num_candidates: int = 10,
                 threshold: float = 0.15,
                 capacity: int = _INITIAL_CAPACITY,
                 device: DeviceLike = None):
        self.shape = tuple(shape)
        self.num_candidates = num_candidates
        self.threshold = threshold
        self.device = resolve_device(device)
        self._capacity = capacity
        self.nb_items = 0
        self.items: Dict[int, Any] = {}
        self._scs = torch.zeros((capacity,) + self.shape,
                                dtype=torch.float32, device=self.device)
        self._ringkeys = torch.zeros((capacity, self.shape[0]),
                                     dtype=torch.float32, device=self.device)

    def __len__(self):
        return self.nb_items

    @property
    def data(self):
        """Flattened descriptor view (parity with DescriptorDatabase.data)."""
        return self._scs.reshape(self._capacity, -1)

    def _sc(self, descriptor):
        return torch.from_numpy(np.array(descriptor, dtype=np.float32).reshape(
            self.shape)).to(self.device)

    def add_item(self, descriptor, item):
        sc = self._sc(descriptor)
        if self.nb_items >= self._capacity:
            grow = self._capacity
            self._scs = torch.cat([self._scs, torch.zeros_like(
                self._scs[:grow])])
            self._ringkeys = torch.cat([self._ringkeys, torch.zeros_like(
                self._ringkeys[:grow])])
            self._capacity *= 2
        self._scs[self.nb_items] = sc
        self._ringkeys[self.nb_items] = sc_ops.ring_key(sc)
        self.items[self.nb_items] = item
        self.nb_items += 1

    def search(self, query, k):
        """Best match via the ring-key shortlist + full SC distance.

        Returns ([item], [similarity]) like the reference, which returns
        only the single best whatever k is."""
        if self.nb_items < 1:
            return [None], [None]
        query_sc = self._sc(query)
        n_cand = min(self.num_candidates, self.nb_items, self._capacity)
        idx, _ = sc_ops.ringkey_topk(
            self._ringkeys, self.nb_items, sc_ops.ring_key(query_sc),
            min(self.num_candidates, self._capacity))
        idx = idx[:n_cand]
        dists, _ = sc_ops.scancontext_distances(query_sc, self._scs[idx])
        host = torch.cat([idx.to(torch.float64), dists.to(torch.float64)]
                         ).cpu().numpy()
        idx, dists = host[:n_cand].astype(np.int64), \
            host[n_cand:].astype(np.float32)
        best = int(np.argmin(dists))
        nn_dist = float(dists[best])
        if nn_dist >= 1.0:  # the reference starts nn_dist at 1.0
            return [self.items[0]], [0.0]
        return [self.items[int(idx[best])]], [1.0 - nn_dist]

    def search_best(self, query):
        if self.nb_items < 1:
            return None, None
        idxs, sims = self.search(query, 1)
        return idxs[0], sims[0]
