"""Trajectory evaluation: ATE RMSE with SE(3) (Umeyama) alignment.

The reference evaluates offline from logged g2o dumps + GPS CSV
(src/back_end/utils/logger.cpp:84-98, :155-172); this module provides the
equivalent metric machinery in-framework, matching the standard
evo/TUM ATE definition (rigid alignment, no scale by default).
"""

from typing import Optional, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid (optionally similarity) transform aligning
    src -> dst, both (N, 3). Returns (s, R, t) with dst ~ s R src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE between (N, 3) translation tracks."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
