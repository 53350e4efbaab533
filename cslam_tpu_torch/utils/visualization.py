"""Visualization utilities.

A copy of cslam_tpu/utils/visualization.py (numpy only; the port
imports nothing of the reference package): depth image -> colored point
cloud (uint16 depth in millimeters, float depth in meters), and
pose-graph export as a PLY for external viewers.
"""

from typing import Dict, Tuple

import numpy as np


def depth_to_colored_pointcloud(depth: np.ndarray, color: np.ndarray,
                                fx: float, fy: float, cx: float, cy: float,
                                depth_scale: float = None) -> np.ndarray:
    """(H, W) depth + (H, W, 3) color -> (N, 6) [x y z r g b] array.

    uint16 depth is interpreted as millimeters, float as meters;
    invalid (0/NaN) depths are dropped.
    """
    depth = np.asarray(depth)
    if depth_scale is None:
        depth_scale = 1e-3 if depth.dtype == np.uint16 else 1.0
    z = depth.astype(np.float32) * depth_scale
    H, W = z.shape
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    valid = (z > 0) & np.isfinite(z)
    z = z[valid]
    us = us[valid]
    vs = vs[valid]
    x = (us - cx) / fx * z
    y = (vs - cy) / fy * z
    rgb = np.asarray(color, dtype=np.float32)[valid]
    if rgb.ndim == 1:
        rgb = np.stack([rgb] * 3, axis=-1)
    return np.concatenate(
        [np.stack([x, y, z], axis=-1), rgb.reshape(-1, 3)], axis=1).astype(
            np.float32)


def pose_graph_to_ply(estimates: Dict[Tuple[int, int], tuple],
                      path: str):
    """Write optimized estimates as a PLY point cloud colored by robot."""
    palette = np.array([[228, 26, 28], [55, 126, 184], [77, 175, 74],
                        [152, 78, 163], [255, 127, 0], [255, 255, 51]],
                       dtype=np.uint8)
    keys = sorted(estimates.keys())
    lines = [
        "ply", "format ascii 1.0", f"element vertex {len(keys)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header"
    ]
    for key in keys:
        _, t = estimates[key]
        c = palette[key[0] % len(palette)]
        lines.append(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} "
                     f"{c[0]} {c[1]} {c[2]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
