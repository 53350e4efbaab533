"""The plain reference: NumPy (and SciPy's k-d tree) in float64.

It imports nothing of the port and takes nothing the port has made: it
reads the recording the harness generated and, only to judge them, the
answers the timed path produced. Each function has a control twin
(`control=True`): the same computation with its inputs rounded to TF32
(10 mantissa bits, the rounding of a TF32 matrix product) and carried
out in float32, the precision one step below the configuration's
float32 with TF32 off.
"""

import numpy as np


def tf32(x) -> np.ndarray:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


# ----------------------------------------------------------------------
# Descriptor search: the best match by cosine similarity
# ----------------------------------------------------------------------
def unit_rows(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def best_match(rows: np.ndarray, query: np.ndarray, control=False):
    """(index, similarity) of the row most similar to `query`; rows and
    query float32 as stored."""
    if not control:
        s = unit_rows(rows) @ unit_rows(query)
    else:
        inv = (np.float32(1.0) / np.linalg.norm(rows, axis=1)).astype(
            np.float32)
        q = (query / np.linalg.norm(query)).astype(np.float32)
        s = (tf32(rows) @ tf32(q)).astype(np.float32) * inv
    i = int(np.argmax(s))
    return i, float(s[i])


# ----------------------------------------------------------------------
# Pose graphs: SE(3) in float64, residuals ordered [omega, v]
# ----------------------------------------------------------------------
def _vee(M):
    return np.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _hat(w):
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_log(R):
    """(..., 3, 3) -> (..., 3) rotation vectors."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    c = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    s = np.sin(th)
    small = th < 1e-4
    k = np.where(small, 0.5 + th * th / 12.0,
                 th / (2.0 * np.where(small, 1.0, s)))
    w = k[..., None] * _vee(R - np.swapaxes(R, -1, -2))
    near_pi = th > np.pi - 1e-3
    if np.any(near_pi):
        for idx in zip(*np.nonzero(near_pi)):
            Rm = R[idx]
            vals, vecs = np.linalg.eigh((Rm + Rm.T) * 0.5)
            axis = vecs[:, np.argmax(vals)]
            if np.dot(axis, _vee(Rm - Rm.T)) < 0:
                axis = -axis
            w[idx] = axis * th[idx]
    return w


def se3_log(R, t):
    """(..., 6) [omega, v]: v = V(omega)^-1 t."""
    w = so3_log(R)
    th2 = np.sum(w * w, axis=-1)
    th = np.sqrt(th2)
    small = th2 < 1e-4
    ts = np.where(small, 1.0, th)
    coef = np.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - (ts / 2.0) / np.tan(ts / 2.0))
                    / np.where(small, 1.0, th2))
    W = _hat(w)
    Vinv = np.eye(3) - 0.5 * W + coef[..., None, None] * (W @ W)
    return np.concatenate([w, np.einsum("...ij,...j->...i", Vinv, t)], -1)


def so3_exp(w):
    """(..., 3) rotation vectors -> (..., 3, 3), Rodrigues in float64."""
    th = np.linalg.norm(w, axis=-1)
    small = th < 1e-8
    ts = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ts) / ts)
    b = np.where(small, 0.5, (1.0 - np.cos(ts)) / (ts * ts))
    K = _hat(w)
    return (np.eye(3) + a[..., None, None] * K
            + b[..., None, None] * (K @ K))


def _between_residuals(Ri, ti, Rj, tj, Rz, tz, S, dt=np.float64):
    """S Log(Z^-1 X_i^-1 X_j), batched over factors."""
    Rrel = np.swapaxes(Ri, -1, -2) @ Rj
    trel = np.einsum("eji,ej->ei", Ri, tj - ti)
    RE = np.swapaxes(Rz, -1, -2) @ Rrel
    tE = np.einsum("eji,ej->ei", Rz, trel - tz)
    return np.einsum("eij,ej->ei", S, se3_log(RE, tE).astype(dt))


def _factor_arrays(factors, index):
    i = np.array([index[f.key_from] for f in factors], dtype=np.int64)
    j = np.array([index[f.key_to] for f in factors], dtype=np.int64)
    Rz = np.stack([f.R for f in factors])
    tz = np.stack([f.t for f in factors])
    S = np.stack([f.sqrt_info for f in factors])
    return i, j, Rz, tz, S


def graph_cost(factors, index, R, t, weights, prior, control=False):
    """0.5 sum_e w_e |S_e Log(Z_e^-1 X_i^-1 X_j)|^2 + 0.5 |w_p Log(P^-1
    X_p)|^2 at poses (R, t) ((P, 3, 3), (P, 3))."""
    i, j, Rz, tz, S = _factor_arrays(factors, index)
    pR, pt, pkey, pw = prior
    pR, pt = np.asarray(pR), np.asarray(pt)
    if control:
        dt = np.float32
        R, t, Rz, tz, S = (tf32(a) for a in (R, t, Rz, tz, S))
        pR, pt = tf32(pR), tf32(pt)
    else:
        dt = np.float64
        R, t, Rz, tz, S = (np.asarray(a, np.float64)
                           for a in (R, t, Rz, tz, S))
        pR, pt = pR.astype(np.float64), pt.astype(np.float64)
    r = _between_residuals(R[i], t[i], R[j], t[j], Rz, tz, S, dt)
    u = 0.5 * np.sum(r * r, axis=-1)
    cost = np.sum(np.asarray(weights, dt) * u)
    k = index[pkey]
    Rp = pR.T @ R[k]
    tp = pR.T @ (t[k] - pt)
    rp = dt(pw) * se3_log(Rp[None], tp[None])[0].astype(dt)
    return float(cost + 0.5 * np.sum(rp * rp))


# step of the central differences of the cost's gradient (rad, m)
GRAD_STEP = 1e-6


def _perturbed(R, t, k, h):
    """Poses moved by h along tangent direction k on the right: rotation
    R exp(h e_k) for k < 3, translation t + h R e_(k-3) otherwise."""
    if k < 3:
        w = np.zeros(3)
        w[k] = h
        return R @ so3_exp(w), t
    return R, t + h * R[..., :, k - 3]


def graph_gradient(factors, index, R, t, weights, anchor) -> np.ndarray:
    """(P, 6) gradient (float64) of the factors' cost 0.5 sum_e w_e |r_e|^2
    along each pose's tangent directions [omega, v] on the right, by
    central differences of each factor's cost in its two endpoints. The
    row of the pose at index `anchor`, which the prior holds fixed (the
    gauge), is zero."""
    i, j, Rz, tz, S = _factor_arrays(factors, index)
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    Rz, tz, S = (np.asarray(a, np.float64) for a in (Rz, tz, S))
    w = np.asarray(weights, np.float64)
    Ri, ti, Rj, tj = R[i], t[i], R[j], t[j]
    g = np.zeros((len(R), 6))
    h = GRAD_STEP

    def u(*poses):
        r = _between_residuals(*poses, Rz, tz, S)
        return 0.5 * w * np.sum(r * r, axis=-1)
    for k in range(6):
        d_i = (u(*_perturbed(Ri, ti, k, h), Rj, tj)
               - u(*_perturbed(Ri, ti, k, -h), Rj, tj)) / (2 * h)
        d_j = (u(Ri, ti, *_perturbed(Rj, tj, k, h))
               - u(Ri, ti, *_perturbed(Rj, tj, k, -h))) / (2 * h)
        np.add.at(g[:, k], i, d_i)
        np.add.at(g[:, k], j, d_j)
    g[anchor] = 0.0
    return g


# ----------------------------------------------------------------------
# Lidar: the voxel grid and the fit of a registration
# ----------------------------------------------------------------------
ORIGIN_RANGE = 100.0


def voxel_grid(points, voxel_size: float, capacity: int, control=False):
    """Centroids of the occupied voxels of the first `capacity` points.

    The voxel of a point is floor((p + 100) / size) in float32, as the
    configuration states the grid; points outside +-100 m are dropped.
    Centroids in float64 (the control: float32 on TF32-rounded
    points)."""
    pts = np.asarray(points, dtype=np.float32)[:capacity]
    if control:
        pts = tf32(pts)
    vs = np.float32(voxel_size)
    vox = np.floor((pts + np.float32(ORIGIN_RANGE)) / vs).astype(np.int64)
    cells = int(np.ceil(np.float32(2 * ORIGIN_RANGE) / vs))
    ok = np.all((vox >= 0) & (vox < cells), axis=1)
    vox, pts = vox[ok], pts[ok]
    key = (vox[:, 0] * cells + vox[:, 1]) * cells + vox[:, 2]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    dt = np.float32 if control else np.float64
    sums = np.zeros((len(counts), 3), dtype=dt)
    np.add.at(sums, inv, pts.astype(dt))
    return sums / counts[:, None].astype(dt)


def cloud_distance(a, b) -> float:
    """Largest distance from a point of either cloud to the nearest
    point of the other (inf when exactly one is empty)."""
    from scipy.spatial import cKDTree
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")
    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return float(max(da.max(), db.max()))


# float32 rounding of the expanded squared distance |s|^2 + |d|^2 - 2 s.d,
# as a multiple of (|s| + |d|)^2 unit roundoffs (a bound with room: the
# sum, the product and the three-term dot each round once)
F32_DIST_ROUNDOFFS = 8 * 2.0 ** -24
# relative rounding of an inlier RMSE summed in float32
F32_SUM_REL = 2e-5


def fit_distances(src, dst, R, t, control=False):
    """(d2, slack) of every source point moved by (R, t): its exact
    squared distance to the nearest destination point, and how far a
    float32 evaluation of that distance may lie from it (the control:
    the distances of TF32-rounded inputs, float32, no slack)."""
    from scipy.spatial import cKDTree
    if control:
        moved = (tf32(src) @ tf32(R).T + tf32(t)).astype(np.float32)
        dst = tf32(dst)
    else:
        moved = np.asarray(src, np.float64) @ np.asarray(R, np.float64).T \
            + np.asarray(t, np.float64)
        dst = np.asarray(dst, np.float64)
    d, j = cKDTree(dst).query(moved)
    if control:
        return (d * d).astype(np.float32), np.zeros(len(d))
    scale = np.linalg.norm(moved, axis=1) + np.linalg.norm(dst[j], axis=1)
    return d * d, F32_DIST_ROUNDOFFS * scale * scale


def fit_of(d2, max_corr: float):
    """(inlier fraction, inlier RMSE): inliers closer than max_corr."""
    c_sq = float(np.float32(max_corr) * np.float32(max_corr))
    inl = d2 < c_sq
    return (float(inl.sum()) / max(len(d2), 1),
            float(np.sqrt(d2[inl].sum() / max(int(inl.sum()), 1))))


def fit_error(d2, slack, max_corr: float, frac: float, rmse: float):
    """How far a reported (inlier fraction, inlier RMSE) lies outside what
    float32 evaluation allows: points within `slack` of the inlier
    threshold may fall on either side, which bounds the fraction and
    the RMSE between all of them out and all in; the RMSE has a further
    relative float32 summation slack. Returns (fraction gap, RMSE gap
    relative to the reference's RMSE)."""
    c_sq = float(np.float32(max_corr) * np.float32(max_corr))
    lo_in = d2 < c_sq - slack
    hi_in = d2 < c_sq + slack
    n = max(len(d2), 1)
    f_lo, f_hi = lo_in.sum() / n, hi_in.sum() / n
    r_lo = np.sqrt(d2[lo_in].sum() / max(int(lo_in.sum()), 1))
    r_hi = np.sqrt(d2[hi_in].sum() / max(int(hi_in.sum()), 1))
    f_gap = max(0.0, f_lo - frac, frac - f_hi)
    r_gap = max(0.0, r_lo * (1 - F32_SUM_REL) - rmse,
                rmse - r_hi * (1 + F32_SUM_REL))
    return float(f_gap), float(r_gap / max(r_hi, 1e-9))


def relative_pose(src_pose, dst_pose):
    """(R, t) mapping points of the source sensor frame into the
    destination's, from the two frames' world poses (R, origin)."""
    Rs, os_ = (np.asarray(a, np.float64) for a in src_pose)
    Rd, od = (np.asarray(a, np.float64) for a in dst_pose)
    return Rd.T @ Rs, Rd.T @ (os_ - od)


def truth_error(points, R, t, R_true, t_true) -> float:
    """Largest distance between the points moved by (R, t) and by the
    true (R_true, t_true)."""
    p = np.asarray(points, np.float64)
    d = p @ (np.asarray(R, np.float64) - R_true).T + (
        np.asarray(t, np.float64) - t_true)
    return float(np.linalg.norm(d, axis=1).max()) if len(p) else 0.0
