"""Padded, static-shape factor-graph containers for PGO.

Port of cslam_tpu/backend/factor_graph.py. Nodes are (P, 3, 3)
rotations + (P, 3) translations + a validity mask; between factors are
endpoint indices, SE(3) measurements, 6x6 sqrt-information blocks, masks
and an is-loop flag; one gauge prior. P and E are padded to power-of-two
buckets, exactly as in the reference (the solver's dense/PCG choice and
the one-hot incidence path depend on them). Padded edges have endpoints
(0, 0), identity measurement and zero mask: they contribute nothing.

The reference caches the padded arrays incrementally to save host/device
round trips of its remote backend; this port rebuilds them per call.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device


class BetweenFactor(NamedTuple):
    """Host-side factor description: key_from/key_to are (robot_id, kf_id)."""
    key_from: Tuple[int, int]
    key_to: Tuple[int, int]
    R: np.ndarray  # (3, 3)
    t: np.ndarray  # (3,)
    sqrt_info: np.ndarray  # (6, 6), whitening, [omega, v] ordering
    is_loop: bool = False


class GraphArrays(NamedTuple):
    """Device tensors consumed by the optimizer."""
    R: torch.Tensor          # (P, 3, 3)
    t: torch.Tensor          # (P, 3)
    node_mask: torch.Tensor  # (P,)
    e_i: torch.Tensor        # (E,) int32
    e_j: torch.Tensor        # (E,) int32
    R_meas: torch.Tensor     # (E, 3, 3)
    t_meas: torch.Tensor     # (E, 3)
    sqrt_info: torch.Tensor  # (E, 6, 6)
    edge_mask: torch.Tensor  # (E,)
    is_loop: torch.Tensor    # (E,)
    prior_idx: torch.Tensor  # () int32
    prior_R: torch.Tensor    # (3, 3)
    prior_t: torch.Tensor    # (3,)
    prior_weight: torch.Tensor  # ()


def graph_arrays_from_numpy(arrays: Dict[str, np.ndarray],
                            device: DeviceLike = None) -> GraphArrays:
    """GraphArrays on `device` from numpy arrays keyed by field name."""
    dev = resolve_device(device)
    out = {}
    for name in GraphArrays._fields:
        a = np.asarray(arrays[name])
        if name in ("e_i", "e_j", "prior_idx"):
            a = a.astype(np.int32)
        else:
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return GraphArrays(**out)


def _next_pow2(n: int, minimum: int = 16) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def diag_sqrt_info(noise_std: Sequence[float]) -> np.ndarray:
    """sqrt-information from a 6-vector of noise sigmas ([omega, v])."""
    std = np.asarray(noise_std, dtype=np.float32)
    return np.diag(1.0 / np.maximum(std, 1e-12))


def noise_std_of(sqrt_info: np.ndarray) -> np.ndarray:
    """Per-axis sigmas from a sqrt-information matrix's diagonal."""
    d = np.abs(np.diag(np.asarray(sqrt_info, dtype=np.float32)))
    return (1.0 / np.maximum(d, 1e-12)).astype(np.float32)


class FactorGraph:
    """Host-side builder mapping (robot_id, keyframe_id) keys to padded
    arrays. Append-only; `to_arrays()` produces the solver input."""

    def __init__(self):
        self.key_to_index: Dict[Tuple[int, int], int] = {}
        self.keys: List[Tuple[int, int]] = []
        self.R: List[np.ndarray] = []
        self.t: List[np.ndarray] = []
        self.factors: List[BetweenFactor] = []
        self.prior_key: Optional[Tuple[int, int]] = None
        self.prior_R = np.eye(3, dtype=np.float32)
        self.prior_t = np.zeros(3, dtype=np.float32)
        self.prior_weight = 1e4

    def add_node(self, key: Tuple[int, int], R=None, t=None) -> int:
        if key in self.key_to_index:
            idx = self.key_to_index[key]
            if R is not None:
                self.R[idx] = np.asarray(R, dtype=np.float32)
                self.t[idx] = np.asarray(t, dtype=np.float32)
            return idx
        idx = len(self.keys)
        self.key_to_index[key] = idx
        self.keys.append(key)
        self.R.append(
            np.eye(3, dtype=np.float32) if R is None else np.asarray(
                R, dtype=np.float32))
        self.t.append(
            np.zeros(3, dtype=np.float32) if t is None else np.asarray(
                t, dtype=np.float32))
        return idx

    def add_between(self, factor: BetweenFactor):
        self.add_node(factor.key_from)
        self.add_node(factor.key_to)
        self.factors.append(factor)

    def set_prior(self, key: Tuple[int, int], R=None, t=None,
                  weight: float = 1e4):
        self.add_node(key)
        self.prior_key = key
        if R is not None:
            self.prior_R = np.asarray(R, dtype=np.float32)
            self.prior_t = np.asarray(t, dtype=np.float32)
        self.prior_weight = weight

    @property
    def num_nodes(self):
        return len(self.keys)

    @property
    def num_factors(self):
        return len(self.factors)

    @property
    def node_capacity(self):
        """The power-of-two node bucket of to_arrays (no minimum)."""
        return _next_pow2(max(self.num_nodes, 2))

    @property
    def edge_capacity(self):
        """The power-of-two edge bucket of to_arrays (no minimum)."""
        return _next_pow2(max(self.num_factors, 1))

    def to_numpy(self, edge_bucket_multiple: int = 1,
                 sort_by_robot: bool = False, min_node_capacity: int = 0,
                 min_edge_capacity: int = 0) -> Dict[str, np.ndarray]:
        """The padded arrays as numpy, keyed by GraphArrays field name.

        edge_bucket_multiple rounds the edge bucket up to a multiple;
        sort_by_robot stable-sorts factors by owning robot (min robot id
        of the endpoints); min_*_capacity force at least this padding."""
        P = max(self.node_capacity, min_node_capacity)
        E = max(self.edge_capacity, min_edge_capacity)
        if edge_bucket_multiple > 1 and E % edge_bucket_multiple:
            E = ((E + edge_bucket_multiple - 1) // edge_bucket_multiple
                 ) * edge_bucket_multiple
        factors = self.factors
        if sort_by_robot:
            factors = sorted(
                factors, key=lambda f: min(f.key_from[0], f.key_to[0]))
        R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        t = np.zeros((P, 3), dtype=np.float32)
        if self.R:
            R[:self.num_nodes] = np.stack(self.R)
            t[:self.num_nodes] = np.stack(self.t)
        node_mask = np.zeros(P, dtype=np.float32)
        node_mask[:self.num_nodes] = 1.0

        e_i = np.zeros(E, dtype=np.int32)
        e_j = np.zeros(E, dtype=np.int32)
        R_meas = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        t_meas = np.zeros((E, 3), dtype=np.float32)
        sqrt_info = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
        edge_mask = np.zeros(E, dtype=np.float32)
        is_loop = np.zeros(E, dtype=np.float32)
        for k, f in enumerate(factors):
            e_i[k] = self.key_to_index[f.key_from]
            e_j[k] = self.key_to_index[f.key_to]
            R_meas[k] = f.R
            t_meas[k] = f.t
            sqrt_info[k] = f.sqrt_info
            edge_mask[k] = 1.0
            is_loop[k] = 1.0 if f.is_loop else 0.0
        prior_idx = self.key_to_index.get(
            self.prior_key, 0) if self.prior_key is not None else 0
        return {"R": R, "t": t, "node_mask": node_mask, "e_i": e_i,
                "e_j": e_j, "R_meas": R_meas, "t_meas": t_meas,
                "sqrt_info": sqrt_info, "edge_mask": edge_mask,
                "is_loop": is_loop,
                "prior_idx": np.asarray(prior_idx, dtype=np.int32),
                "prior_R": self.prior_R, "prior_t": self.prior_t,
                "prior_weight": np.asarray(self.prior_weight,
                                           dtype=np.float32)}

    def to_arrays(self, edge_bucket_multiple: int = 1,
                  sort_by_robot: bool = False,
                  min_node_capacity: int = 0,
                  min_edge_capacity: int = 0,
                  device: DeviceLike = None) -> GraphArrays:
        """GraphArrays on `device` (None = the CUDA card); see to_numpy."""
        return graph_arrays_from_numpy(
            self.to_numpy(edge_bucket_multiple, sort_by_robot,
                          min_node_capacity, min_edge_capacity), device)

    def update_estimates(self, R, t):
        """Write optimized estimates back into the host-side store."""
        R = R.detach().cpu().numpy() if torch.is_tensor(R) else np.asarray(R)
        t = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        for idx in range(self.num_nodes):
            self.R[idx] = R[idx]
            self.t[idx] = t[idx]

    def estimates_for_robot(self, robot_id: int):
        """Per-robot extraction by key label."""
        out = {}
        for key, idx in self.key_to_index.items():
            if key[0] == robot_id:
                out[key] = (self.R[idx], self.t[idx])
        return out
