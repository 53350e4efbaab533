"""FPFH (Fast Point Feature Histograms) over padded clouds.

Port of cslam_tpu/ops/fpfh.py (the Swarm-SLAM reference's open3d FPFH
stage and mutual-kNN correspondence filter, lidar_pr/icp_utils.py):

- neighbourhoods: one (N, N) expanded-form distance matrix
  (`ops/registration.squared_distances`), the diagonal at +inf (self
  excluded), then the k smallest per row, the lower index first among
  equal distances (`ops/features.top_k`, as `lax.top_k`). The
  reference writes the self-exclusion as `d2 + eye(N) * inf`; run
  eagerly that is NaN off the diagonal, but
  `fpfh` always runs compiled, where XLA folds it to +inf on the
  diagonal and +0 elsewhere. The port implements the compiled meaning;
- normals: per-point neighbourhood covariance, smallest eigenvector by
  matrix squaring (`ops/batched_linalg.smallest_eigvec_sym3x3`),
  oriented toward the sensor origin;
- SPFH: Darboux-frame angle triplets (alpha, phi, theta) of every
  (point, neighbour) pair in 3 x 11 histograms (the bin of a value is
  the integer part of `scaled_angles`);
- FPFH: SPFH(p) + the mean over neighbours of distance-weighted
  SPFH(q), L2-normalized.

`fpfh` computes the neighbourhoods once and uses them for the normals
and the histograms (the reference computes the same top-k twice).
`fpfh_correspondences` keeps mutual nearest neighbours in FPFH space
(the first minimum of each row and column).
"""

import numpy as np
import torch
import torch.nn.functional as F

from cslam_tpu_torch.ops.batched_linalg import smallest_eigvec_sym3x3
from cslam_tpu_torch.ops.features import top_k
from cslam_tpu_torch.ops.registration import squared_distances

N_BINS = 11  # per angle, 33-d descriptor (open3d default)


def knn_indices(points, mask, k):
    """(idx, d2) of each point's k nearest valid other points."""
    d2 = squared_distances(points, points, mask)
    d2.fill_diagonal_(torch.inf)  # exclude self
    neg, idx = top_k(-d2, k)
    return idx, -neg


def normals_from(points, idx, d2):
    """Neighbourhood-PCA normals oriented toward the origin."""
    neigh = points[idx]                       # (N, k, 3)
    valid = torch.isfinite(d2)[..., None]
    count = torch.clamp(torch.sum(valid[..., 0], dim=1, keepdim=True), min=1)
    zero = torch.zeros_like(neigh)
    mean = torch.sum(torch.where(valid, neigh, zero), dim=1) / count
    centered = torch.where(valid, neigh - mean[:, None], zero)
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    cov = cov + torch.eye(3, dtype=cov.dtype, device=cov.device) * 1e-9
    normals = smallest_eigvec_sym3x3(cov)
    flip = torch.sum(normals * points, dim=1, keepdim=True) > 0
    return torch.where(flip, -normals, normals)


def estimate_normals(points, mask, k=16):
    """Per-point normals from neighbourhood PCA, oriented toward the
    sensor origin (open3d convention)."""
    idx, d2 = knn_indices(points, mask, k)
    return normals_from(points, idx, d2)


def scaled_angles(values, lo, hi):
    """(v - lo) / (hi - lo) * N_BINS, whose integer part is the bin,
    rounded as the reference's compiled form: it folds the two constants
    into one f32 factor N_BINS / (hi - lo)."""
    return (values - lo) * float(np.float32(N_BINS) / np.float32(hi - lo))


def _soft_hist(values, lo, hi):
    """(N, k) values -> (N, N_BINS) histogram; one bin per value,
    clipped into range."""
    bins = torch.clamp(scaled_angles(values, lo, hi).to(torch.int32), 0,
                       N_BINS - 1)
    return torch.sum(F.one_hot(bins.to(torch.int64), N_BINS), dim=1).to(
        torch.float32)


# the (lo, hi) range of alpha, phi and theta
ANGLE_RANGES = ((-1.0, 1.0), (-1.0, 1.0), (-torch.pi, torch.pi))


def darboux_angles(points, normals, idx):
    """((alpha, phi, theta), dist): the angle triplet of every (point,
    neighbour) pair in the Darboux frame at the point (u = n_p,
    v = d x u, w = u x v), each (N, k), and the pair distances."""
    p = points[:, None, :]        # (N, 1, 3)
    q = points[idx]               # (N, k, 3)
    n_q = normals[idx]
    dvec = q - p
    dist = torch.clamp(torch.linalg.vector_norm(dvec, dim=-1), min=1e-9)
    d_unit = dvec / dist[..., None]
    u = normals[:, None, :].expand(d_unit.shape)
    v = torch.linalg.cross(d_unit, u, dim=-1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-9)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * n_q, dim=-1)                       # [-1, 1]
    phi = torch.sum(u * d_unit, dim=-1)                      # [-1, 1]
    theta = torch.atan2(torch.sum(w * n_q, dim=-1),
                        torch.sum(u * n_q, dim=-1))          # [-pi, pi]
    return (alpha, phi, theta), dist


def spfh(angles, valid):
    """(N, 33) histograms of the valid pairs' angle triplets."""
    n_invalid = torch.sum(~valid, dim=1).to(torch.float32)
    hists = []
    for vals, (lo, hi) in zip(angles, ANGLE_RANGES):
        # invalid pairs land in no bin: pushed out of range, they clip
        # into the top bin, whose count is then corrected
        h = _soft_hist(torch.where(valid, vals, torch.full_like(
            vals, hi + 1.0)), lo, hi)
        h[:, N_BINS - 1] -= n_invalid
        hists.append(torch.clamp(h, min=0.0))
    return torch.cat(hists, dim=1)


def fpfh(points, mask, k=16):
    """(N, 3) padded cloud -> (N, 33) L2-normalized FPFH descriptors."""
    idx, d2 = knn_indices(points, mask, k)
    normals = normals_from(points, idx, d2)
    valid = torch.isfinite(d2) & (mask[:, None] > 0)
    angles, dist = darboux_angles(points, normals, idx)
    hist = spfh(angles, valid)
    # FPFH(p) = SPFH(p) + (1/k) sum_j SPFH(j) / w_j, w_j = ||p - q_j||
    weights = torch.where(valid, 1.0 / dist, torch.zeros_like(dist))
    weighted = torch.einsum("nk,nkd->nd", weights, hist[idx])
    count = torch.clamp(torch.sum(valid, dim=1, keepdim=True), min=1)
    out = hist + weighted / count
    out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1,
                                                     keepdim=True), min=1e-9)
    return out * mask[:, None]


def fpfh_correspondences(feat_a, mask_a, feat_b, mask_b):
    """Mutual nearest neighbours in FPFH space. Returns (idx_b_for_a,
    valid): int64 indices and an f32 mask."""
    d2 = squared_distances(feat_a, feat_b)
    pair = (mask_a[:, None] > 0) & (mask_b[None, :] > 0)
    d2 = torch.where(pair, d2, torch.full_like(d2, torch.inf))
    best_d2, best_b = torch.min(d2, dim=1)
    best_a = torch.argmin(d2, dim=0)
    mutual = best_a[best_b] == torch.arange(feat_a.shape[0],
                                            device=feat_a.device)
    valid = mutual & (mask_a > 0) & torch.isfinite(best_d2)
    return best_b, valid.to(torch.float32)
