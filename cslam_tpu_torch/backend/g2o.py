"""g2o pose-graph file I/O (VERTEX_SE3:QUAT / EDGE_SE3:QUAT).

Port of cslam_tpu/backend/g2o.py on the port's FactorGraph. The text
format is the reference's, line for line, so a file written by either
package reads back in the other. File I/O is host work: quaternions go
through the port's `ops/se3.quat_to_rot` / `rot_to_quat` on CPU tensors,
whatever device the graph is later solved on.

g2o orders tangent/information as (x, y, z, qx, qy, qz), translation
first; the internal convention is [omega, v], rotation first. The 6x6
information is permuted accordingly and factored into a whitening
sqrt-info via Cholesky.
"""

from typing import List

import numpy as np
import torch

from cslam_tpu_torch.backend.factor_graph import BetweenFactor, FactorGraph
from cslam_tpu_torch.ops import se3

# permutation taking our [omega, v] index -> g2o (t, r) index
_PERM = np.array([3, 4, 5, 0, 1, 2])


def _quat_to_rot(q) -> np.ndarray:
    return se3.quat_to_rot(torch.tensor(q, dtype=torch.float32)).numpy()


def _rot_to_quat(R) -> np.ndarray:
    return se3.rot_to_quat(torch.tensor(R, dtype=torch.float32)).numpy()


def _info_g2o_to_sqrt_info(info_tfirst: np.ndarray) -> np.ndarray:
    """6x6 g2o information (translation-first) -> whitening sqrt-info in
    [omega, v] ordering (Gamma with Gamma^T Gamma = Info)."""
    info_ours = info_tfirst[np.ix_(_PERM, _PERM)]
    # symmetrize and factor; fall back to diagonal on non-PSD input
    info_ours = 0.5 * (info_ours + info_ours.T)
    try:
        L = np.linalg.cholesky(info_ours)
        return L.T.astype(np.float32)
    except np.linalg.LinAlgError:
        d = np.sqrt(np.maximum(np.diag(info_ours), 1e-12))
        return np.diag(d).astype(np.float32)


def _sqrt_info_to_info_g2o(sqrt_info: np.ndarray) -> np.ndarray:
    info_ours = sqrt_info.T @ sqrt_info
    inv_perm = np.argsort(_PERM)
    return info_ours[np.ix_(inv_perm, inv_perm)]


def read_g2o(path: str, loop_is_nonconsecutive: bool = True) -> FactorGraph:
    """Parse a g2o file into a FactorGraph. Vertex ids map to keys
    (0, id); edges between non-consecutive ids are flagged as loop
    closures (candidates for GNC robustness)."""
    fg = FactorGraph()
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                vid = int(parts[1])
                vals = np.array(list(map(float, parts[2:9])),
                                dtype=np.float32)
                fg.add_node((0, vid), _quat_to_rot(vals[3:7]), vals[:3])
            elif parts[0] == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = list(map(float, parts[3:]))
                t = np.array(vals[:3], dtype=np.float32)
                R = _quat_to_rot(vals[3:7])
                info = np.zeros((6, 6))
                upper = vals[7:28]
                idx = 0
                for a in range(6):
                    for b in range(a, 6):
                        info[a, b] = upper[idx]
                        info[b, a] = upper[idx]
                        idx += 1
                sqrt_info = _info_g2o_to_sqrt_info(info)
                is_loop = loop_is_nonconsecutive and abs(i - j) != 1
                fg.add_between(
                    BetweenFactor((0, i), (0, j), R, t, sqrt_info,
                                  is_loop=is_loop))
    if fg.keys:
        first = min(fg.keys)
        idx = fg.key_to_index[first]
        fg.set_prior(first, fg.R[idx], fg.t[idx])
    return fg


def write_g2o(fg: FactorGraph, path: str, key_to_id=None):
    """Write vertices + edges. Multi-robot keys are flattened via
    key_to_id (default: dense enumeration in insertion order)."""
    if key_to_id is None:
        key_to_id = {k: i for i, k in enumerate(fg.keys)}
    lines: List[str] = []
    for key, idx in fg.key_to_index.items():
        q = _rot_to_quat(fg.R[idx])
        t = fg.t[idx]
        lines.append(
            "VERTEX_SE3:QUAT {} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g}"
            .format(key_to_id[key], t[0], t[1], t[2], q[0], q[1], q[2], q[3]))
    for f in fg.factors:
        q = _rot_to_quat(f.R)
        info = _sqrt_info_to_info_g2o(f.sqrt_info)
        upper = [info[a, b] for a in range(6) for b in range(a, 6)]
        lines.append(
            "EDGE_SE3:QUAT {} {} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} {:.9g} "
            .format(key_to_id[f.key_from], key_to_id[f.key_to], f.t[0],
                    f.t[1], f.t[2], q[0], q[1], q[2], q[3]) +
            " ".join("{:.9g}".format(u) for u in upper))
    with open(path, "w") as out:
        out.write("\n".join(lines) + "\n")
