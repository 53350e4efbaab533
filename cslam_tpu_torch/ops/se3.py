"""SO(3)/SE(3) Lie-group ops, batched.

Port of cslam_tpu/ops/se3.py with the same conventions (GTSAM Pose3):
a pose is (R, t) mapping local p to R p + t; tangents are [omega, v];
Exp/Log use the exact exponential with the SO(3) left Jacobian. The
small-angle series branches are the reference's, selected with
torch.where on guarded inputs, so forward-mode derivatives (PGO's
Jacobians, torch.func.jacfwd) stay finite through unselected branches.
"""

import math

import torch

_EPS = 1e-8


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def vee(W):
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3, with the
    reference's series below theta = 0.1 (theta_sq < 1e-2)."""
    small = theta_sq < 1e-2
    safe_t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_t = torch.sqrt(safe_t2)
    t2 = theta_sq
    t4 = theta_sq * theta_sq
    A = torch.where(small, 1.0 - t2 / 6.0 + t4 / 120.0,
                    torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - t2 / 24.0 + t4 / 720.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def so3_exp(w):
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """(..., 3, 3) -> (..., 3); series for theta/(2 sin theta) below
    theta ~ 0.32, symmetric-part axis extraction near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - torch.swapaxes(R, -1, -2))
    u = 1.0 - cos_theta
    small = cos_theta > 0.95
    near_pi = cos_theta < math.cos(math.pi - 1e-3)
    k_series = 0.5 * (1.0 + u / 3.0 + 2.0 * u * u / 15.0)
    c_safe = torch.where(small | near_pi, torch.zeros_like(cos_theta),
                         cos_theta)
    k_exact = torch.arccos(c_safe) / (2.0 * torch.sqrt(
        torch.clamp(1.0 - c_safe * c_safe, min=1e-12)))
    k = torch.where(small, k_series, k_exact)
    theta = torch.arccos(torch.where(near_pi, cos_theta,
                                     torch.zeros_like(cos_theta)))
    w_generic = k[..., None] * antisym
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    axis = torch.sqrt(axis_sq)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    imax = torch.argmax(axis_sq, dim=-1)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    ay0 = torch.where(s01 < 0, -ay, ay)
    az0 = torch.where(s02 < 0, -az, az)
    ax1 = torch.where(s01 < 0, -ax, ax)
    az1 = torch.where(s12 < 0, -az, az)
    ax2 = torch.where(s02 < 0, -ax, ax)
    ay2 = torch.where(s12 < 0, -ay, ay)
    axis_fixed = torch.where(
        (imax == 0)[..., None],
        torch.stack([ax, ay0, az0], dim=-1),
        torch.where((imax == 1)[..., None],
                    torch.stack([ax1, ay, az1], dim=-1),
                    torch.stack([ax2, ay2, az], dim=-1)))
    norm = torch.linalg.vector_norm(axis_fixed, dim=-1, keepdim=True)
    axis_fixed = axis_fixed / torch.clamp(norm, min=_EPS)
    sign_dot = torch.sum(axis_fixed * antisym, dim=-1, keepdim=True)
    axis_fixed = torch.where(sign_dot < 0, -axis_fixed, axis_fixed)
    w_pi = axis_fixed * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w):
    """V(w) with Exp([w,v]) translation = V(w) v."""
    theta_sq = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + B[..., None, None] * W + C[..., None, None] * W2


def so3_left_jacobian_inv(w):
    """V(w)^-1, exact with Taylor fallback."""
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-2
    one = torch.ones_like(theta_sq)
    safe_t = torch.sqrt(torch.where(small, one, theta_sq))
    half = 0.5 * safe_t
    cot_coeff = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half),
                                                    min=_EPS)) /
        torch.where(small, one, theta_sq))
    W = hat(w)
    W2 = W @ W
    return _eye3(w) - 0.5 * W + cot_coeff[..., None, None] * W2


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def se3_exp(xi):
    """(..., 6) [w, v] -> (R, t)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    return so3_exp(w), _mv(so3_left_jacobian(w), v)


def se3_log(R, t):
    """(R, t) -> (..., 6) [w, v]."""
    w = so3_log(R)
    v = _mv(so3_left_jacobian_inv(w), t)
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def inverse(R, t):
    Rinv = torch.swapaxes(R, -1, -2)
    return Rinv, -_mv(Rinv, t)


def between(Ra, ta, Rb, tb):
    """a^-1 * b — the relative pose."""
    Rinv, tinv = inverse(Ra, ta)
    return compose(Rinv, tinv, Rb, tb)


def adjoint(R, t):
    """Ad_T (6x6) for xi ordered [w, v]: [[R, 0], [t^ R, R]]."""
    tx = hat(t)
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bottom = torch.cat([tx @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_points(R, t, p):
    """(..., 3, 3), (..., 3), (..., N, 3) -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", R, p) + t[..., None, :]


def normalize_rotation(R):
    """Project a near-rotation onto SO(3) (Newton polar iteration)."""
    from cslam_tpu_torch.ops.batched_linalg import polar_rotation3x3
    return polar_rotation3x3(R)


def quat_to_rot(q):
    """(..., 4) quaternion [qx, qy, qz, qw] -> (..., 3, 3) rotation."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rot_to_quat(R):
    """(..., 3, 3) -> (..., 4) [qx, qy, qz, qw], w >= 0 (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = piv(1.0 + tr)
    c0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01),
                      4.0 * qw0 * qw0], dim=-1) / (4.0 * qw0[..., None])
    qx1 = piv(1.0 + m00 - m11 - m22)
    c1 = torch.stack([4.0 * qx1 * qx1, (m01 + m10), (m02 + m20),
                      (m21 - m12)], dim=-1) / (4.0 * qx1[..., None])
    qy2 = piv(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21),
                      (m02 - m20)], dim=-1) / (4.0 * qy2[..., None])
    qz3 = piv(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3,
                      (m10 - m01)], dim=-1) / (4.0 * qz3[..., None])
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def identity_poses(n, dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).clone()
    t = torch.zeros((n, 3), dtype=dtype, device=device)
    return R, t
