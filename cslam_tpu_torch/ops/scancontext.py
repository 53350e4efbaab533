"""Scan Context: polar descriptor extraction and rotation-invariant
matching.

Port of cslam_tpu/ops/scancontext.py (the Swarm-SLAM reference's
lidar_pr/scancontext_utils.py ptcloud2sc and distance_sc):

- `pointcloud_to_scancontext`: ring from planar radius, sector from
  azimuth in degrees, cell value max(z + 2, 0), empty cells 0; one
  `scatter_reduce("amax")` over the flattened (ring, sector) bins plus
  an overflow bin for the masked and non-finite points.
- `scancontext_distances`: per-column cosine similarity averaged over
  the columns engaged in both, maximized over all 60 cyclic sector
  shifts: a gather and one einsum over (candidates x shifts x rings x
  sectors).
- `ringkey_topk`: brute-force L2 nearest ring keys, the lower index
  first among equal distances (`ops/features.top_k`, as `lax.top_k`).

Divisions go through a full-shaped divisor (`_div`): on a CUDA tensor
PyTorch divides by a Python scalar through its reciprocal, which rounds
differently from the reference's division.
"""

import torch

from cslam_tpu_torch.ops.features import top_k

NUM_RING = 20
NUM_SECTOR = 60
MAX_LENGTH = 80.0


def _div(x, s: float, rounding_mode=None):
    """x / s elementwise, rounded as one IEEE division per element."""
    return torch.div(x, torch.full_like(x, s), rounding_mode=rounding_mode)


def polar_bins(points, mask, num_ring=NUM_RING, num_sector=NUM_SECTOR,
               max_length=MAX_LENGTH):
    """(bins, theta, radius) of (N, 3) padded points: each point's
    flattened ring * num_sector + sector bin (num_ring * num_sector, the
    overflow bin, for masked and non-finite points), its azimuth in
    degrees in [0, 360) and its planar radius. x or y exactly 0 counts
    as 1e-3, as the reference's."""
    pts = points.to(torch.float32)
    x = torch.where(pts[:, 0] == 0.0, torch.full_like(pts[:, 0], 1e-3),
                    pts[:, 0])
    y = torch.where(pts[:, 1] == 0.0, torch.full_like(pts[:, 1], 1e-3),
                    pts[:, 1])
    valid = (mask > 0) & torch.isfinite(x) & torch.isfinite(y) & \
        torch.isfinite(pts[:, 2])
    theta = torch.atan2(y, x) * (180.0 / torch.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    radius = torch.sqrt(x * x + y * y)
    ring = torch.clamp(_div(radius, max_length / num_ring, "floor").to(
        torch.int64), 0, num_ring - 1)
    sector = torch.clamp(_div(theta, 360.0 / num_sector, "floor").to(
        torch.int64), 0, num_sector - 1)
    bins = torch.where(valid, ring * num_sector + sector,
                       torch.full_like(ring, num_ring * num_sector))
    return bins, theta, radius


def pointcloud_to_scancontext(points, mask, num_ring=NUM_RING,
                              num_sector=NUM_SECTOR, max_length=MAX_LENGTH):
    """(N, 3) padded points + (N,) mask -> (num_ring, num_sector) SC.

    height = z + 2.0, ring = floor(r / gap_ring) clipped to the outermost
    ring, sector from azimuth degrees in [0, 360); cells with no points
    (or only negative heights) are 0."""
    bins, _, _ = polar_bins(points, mask, num_ring, num_sector, max_length)
    n_bins = num_ring * num_sector
    height = points[:, 2].to(torch.float32) + 2.0
    flat = torch.full((n_bins + 1,), -torch.inf, dtype=torch.float32,
                      device=points.device).scatter_reduce(
        0, bins, torch.where(bins < n_bins, height, torch.full_like(
            height, -torch.inf)), "amax", include_self=True)
    sc = torch.clamp(flat[:n_bins], min=0.0)  # empty / negative -> 0
    return sc.reshape(num_ring, num_sector)


def _sequential_sum(x):
    """Sum over the last axis, one element after the other."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def ring_key(sc):
    """Rotation-invariant ring key = row mean (sc2rk), summed in the
    reference's order: XLA's CPU backend sums a row of 33-64 elements as
    two sequential halves (the first ceil(n / 2) elements, then the
    rest) and adds the halves; a shorter row sequentially. The mean is
    that sum times the f32 reciprocal of n, as the reference's mean
    rounds it."""
    n = sc.shape[-1]
    if n > 64:
        raise ValueError(f"ring_key takes at most 64 sectors, got {n}")
    if n > 32:
        half = -(-n // 2)
        s = _sequential_sum(sc[..., :half]) + _sequential_sum(sc[..., half:])
    else:
        s = _sequential_sum(sc)
    return s * (1.0 / n)


def scancontext_distances(query_sc, candidate_scs):
    """Min-over-shifts SC distance of a query against a batch.

    query_sc: (R, S); candidate_scs: (N, R, S). Returns (dists, yaws):
    (N,) distance = 1 - best mean column cosine, and (N,) int64 yaw shift
    (argmax + 1, the first maximum)."""
    R, S = query_sc.shape
    dev = query_sc.device
    # rolled_q[i] = query rolled to compare against the candidate rolled
    # by i + 1 columns (the reference rolls the candidate cumulatively)
    shifts = torch.arange(1, S + 1, device=dev)
    cols = torch.arange(S, device=dev)
    gather_idx = (cols[None, :] + shifts[:, None]) % S  # (S_shift, S)
    rolled_q = query_sc[:, gather_idx].permute(1, 0, 2)  # (S_shift, R, S)
    dots = torch.einsum("irj,crj->cij", rolled_q, candidate_scs)
    q_norm = torch.linalg.vector_norm(rolled_q, dim=1)       # (S_shift, S)
    c_norm = torch.linalg.vector_norm(candidate_scs, dim=1)  # (N, S)
    engaged = (q_norm[None] > 0) & (c_norm[:, None] > 0)
    denom = torch.clamp(q_norm[None] * c_norm[:, None], min=1e-12)
    cossim = torch.where(engaged, dots / denom, torch.zeros_like(dots))
    counts = torch.sum(engaged, dim=-1)
    sims = torch.where(counts > 0, torch.sum(cossim, dim=-1) /
                       torch.clamp(counts, min=1), torch.zeros_like(
                           dots[..., 0]))
    best_sim, best = torch.max(sims, dim=-1)
    return 1.0 - best_sim, best + 1


def ringkey_topk(ringkeys, n_valid: int, query_rk, k: int):
    """(idx, d2) of the k nearest of the first n_valid ring keys (L2),
    the lower row first among equal distances."""
    diff = ringkeys - query_rk[None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    rows = torch.arange(ringkeys.shape[0], device=ringkeys.device)
    d2 = torch.where(rows < n_valid, d2, torch.full_like(d2, torch.inf))
    neg_top, idx = top_k(-d2, k)
    return idx, -neg_top
