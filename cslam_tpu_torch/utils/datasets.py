"""Dataset loaders: KITTI odometry and TUM trajectory formats.

Port of cslam_tpu/utils/datasets.py (the reference's ingestion side of
its multi-robot KITTI / GRACO evaluations):

- KITTI odometry poses: one 3x4 row-major [R|t] per line (cam frame).
- TUM trajectories: `timestamp tx ty tz qx qy qz qw` per line; the
  quaternions go through the port's `ops/se3.quat_to_rot` /
  `rot_to_quat` on CPU tensors (file I/O is host work).
- `split_trajectory`: partition one sequence into N contiguous robot
  segments (the standard multi-robot KITTI protocol).
- `to_keyframe_stream`: downsample a pose track into KeyframeOdom
  messages by travelled distance (the lidar keyframe gate).
"""

from typing import List, Tuple

import numpy as np
import torch

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.ops import se3


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3, 3) rotations + (N, 3) translations from a KITTI poses file."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    R = rows[:, :, :3].astype(np.float32)
    t = rows[:, :, 3].astype(np.float32)
    return R, t


def save_kitti_poses(path: str, R: np.ndarray, t: np.ndarray):
    flat = np.concatenate([R, t[:, :, None]], axis=2).reshape(-1, 12)
    np.savetxt(path, flat, fmt="%.9e")


def load_tum_trajectory(path: str):
    """(stamps, R, t) from a TUM-format file (skips '#' comments)."""
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    stamps = data[:, 0]
    t = data[:, 1:4].astype(np.float32)
    quat = data[:, 4:8].astype(np.float32)  # qx qy qz qw
    R = se3.quat_to_rot(torch.from_numpy(quat)).numpy()
    return stamps, R, t


def save_tum_trajectory(path: str, stamps, R, t):
    quat = se3.rot_to_quat(
        torch.from_numpy(np.asarray(R, np.float32))).numpy()
    rows = np.concatenate(
        [np.asarray(stamps)[:, None], t, quat], axis=1)
    np.savetxt(path, rows,
               fmt=["%.6f"] + ["%.9e"] * 7,
               header="timestamp tx ty tz qx qy qz qw")


def split_trajectory(R: np.ndarray, t: np.ndarray,
                     n_robots: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Contiguous per-robot segments of one sequence (multi-robot KITTI
    protocol). Each robot's poses are re-anchored to its own first pose,
    as in deployments where odometry starts at identity."""
    n = len(t)
    bounds = np.linspace(0, n, n_robots + 1).astype(int)
    out = []
    for r in range(n_robots):
        Rs = R[bounds[r]:bounds[r + 1]]
        ts = t[bounds[r]:bounds[r + 1]]
        R0_inv = Rs[0].T
        t0 = ts[0]
        out.append((np.einsum("ij,njk->nik", R0_inv, Rs).astype(np.float32),
                    ((ts - t0) @ Rs[0]).astype(np.float32)))
    return out


def to_keyframe_stream(R: np.ndarray, t: np.ndarray,
                       min_distance: float = 1.0) -> List[msgs.KeyframeOdom]:
    """Distance-gated keyframes as KeyframeOdom messages (the lidar
    handler's odometry-distance gate)."""
    out = []
    last = None
    kf_id = 0
    for k in range(len(t)):
        if last is None or np.linalg.norm(t[k] - last) >= min_distance:
            out.append(msgs.KeyframeOdom(id=kf_id, pose=(R[k], t[k])))
            last = t[k]
            kf_id += 1
    return out
