"""State carried across from the reference package, as numpy.

The port imports nothing of cslam_tpu; these functions take plain
numpy arrays, dicts, or duck-typed host objects (anything with the same
attribute names), so the same padded database, graph or solver settings
can be fed to both packages.
"""

from typing import Any, Mapping

import numpy as np
import torch

from cslam_tpu_torch.backend.factor_graph import (BetweenFactor, FactorGraph,
                                                  GraphArrays,
                                                  graph_arrays_from_numpy)
from cslam_tpu_torch.backend.pgo import PGOConfig
from cslam_tpu_torch.device import DeviceLike
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase


def descriptor_database_from_numpy(data, norms, n: int,
                                   items: Mapping[int, Any],
                                   method: str = "auto",
                                   device: DeviceLike = None
                                   ) -> DescriptorDatabase:
    """A DescriptorDatabase holding the padded (capacity, dim) `data`
    (float32 or bfloat16-as-float32 values; storage follows
    data.dtype's name when it is "bfloat16"), its (capacity,) f32 row
    `norms`, `n` valid rows and the row -> item map."""
    data = np.asarray(data)
    storage = "bfloat16" if data.dtype.name == "bfloat16" else "float32"
    db = DescriptorDatabase(dim=data.shape[1], capacity=data.shape[0],
                            method=method, storage=storage, device=device)
    db._data = torch.from_numpy(data.astype(np.float32)).to(
        db.device).to(db._dtype)
    db._norms = torch.from_numpy(np.asarray(norms, np.float32).copy()).to(
        db.device)
    db.n = int(n)
    db.items = dict(items)
    return db


def graph_arrays_from(fields, device: DeviceLike = None) -> GraphArrays:
    """GraphArrays from a mapping or NamedTuple of array-likes with the
    GraphArrays field names (e.g. the reference's GraphArrays)."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return graph_arrays_from_numpy(
        {k: np.asarray(v) for k, v in fields.items()}, device)


def pgo_config_from_dict(d: Mapping[str, Any]) -> PGOConfig:
    """PGOConfig from a dict (or NamedTuple) of its fields."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return PGOConfig(**{k: d[k] for k in PGOConfig._fields if k in d})


def factor_graph_from(src) -> FactorGraph:
    """Copy of a host factor graph (keys, estimates, factors, prior)."""
    fg = FactorGraph()
    for key, R, t in zip(src.keys, src.R, src.t):
        fg.add_node(tuple(key), np.asarray(R, np.float32),
                    np.asarray(t, np.float32))
    for f in src.factors:
        fg.factors.append(BetweenFactor(
            tuple(f.key_from), tuple(f.key_to), np.asarray(f.R, np.float32),
            np.asarray(f.t, np.float32), np.asarray(f.sqrt_info, np.float32),
            bool(f.is_loop)))
    fg.prior_key = None if src.prior_key is None else tuple(src.prior_key)
    fg.prior_R = np.asarray(src.prior_R, np.float32)
    fg.prior_t = np.asarray(src.prior_t, np.float32)
    fg.prior_weight = float(src.prior_weight)
    return fg

