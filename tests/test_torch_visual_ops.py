"""Port parity, visual verification ops: cslam_tpu_torch against
cslam_tpu on the same seeded numpy inputs, on the CPU, at the shapes of
the reference's own tests (K <= 160 keypoints, 120x160 images).

Tolerances:
- RANSAC sample indices (`jax_random.choice_p` against
  `jax.random.choice` with p): identical. So are the cumulative sums
  they come from, the keypoint coordinates (padded slots included), the
  validity masks, the mutual matches and the inlier sets of every
  RANSAC case here.
- Descriptors, registration: max abs <= 1e-5 (f32; only the summation
  order differs).
- Corner responses: max abs <= 1e-4. The response is tr/2 -
  sqrt(tr^2/4 - det), and where the structure tensor is near isotropic
  the square root of a cancelling difference turns a last-place
  difference of the convolutions into ~1e-5 (measured 1.3e-5 on the
  checkerboard); the keypoints chosen from it are identical.
- RANSAC poses: <= 1e-4 (rotation entries, translation in scene
  units); covariance diagonals: relative 1e-3 (a 6x6 inverse of a
  sum over every inlier).
- P3P and PnP poses: <= 1e-4; PnP covariance relative 1e-3.
- Stereo disparities: <= 1e-4 px, validity identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import features as jfeat
from cslam_tpu.ops import matching2d as jm2d
from cslam_tpu.ops import pnp as jpnp
from cslam_tpu.ops import registration as jreg
from cslam_tpu.ops import se3 as jse3
from cslam_tpu.ops import stereo as jstereo
from cslam_tpu_torch.ops import features as tfeat
from cslam_tpu_torch.ops import matching2d as tm2d
from cslam_tpu_torch.ops import pnp as tpnp
from cslam_tpu_torch.ops import registration as treg
from cslam_tpu_torch.ops import stereo as tstereo
from cslam_tpu_torch.utils import jax_random

torch.set_num_threads(1)

F32_TOL = 1e-5
RESPONSE_TOL = 1e-4
POSE_TOL = 1e-4
COV_RTOL = 1e-3


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def n(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def assert_result_close(port, ref, cov_rtol=COV_RTOL):
    """Two RansacResults: identical inliers, count and success; pose
    within POSE_TOL; covariance diagonal within cov_rtol."""
    np.testing.assert_array_equal(n(port.inliers), np.asarray(ref.inliers))
    np.testing.assert_array_equal(n(port.num_inliers),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(n(port.success), np.asarray(ref.success))
    np.testing.assert_allclose(n(port.R), np.asarray(ref.R), atol=POSE_TOL)
    np.testing.assert_allclose(n(port.t), np.asarray(ref.t), atol=POSE_TOL)
    np.testing.assert_allclose(n(port.cov_diag), np.asarray(ref.cov_diag),
                               rtol=cov_rtol, atol=1e-12)


# -- trap 1: jax.random.choice with p ---------------------------------

@pytest.mark.parametrize("n_valid", [0, 3, 37, 128])
def test_choice_p_matches_jax_random_choice(n_valid):
    N, shape = 128, (256, 3)

    @jax.jit
    def ref(valid, seed):
        probs = valid / jnp.maximum(jnp.sum(valid), 1.0)
        return jax.random.choice(jax.random.PRNGKey(seed), N, shape=shape,
                                 replace=True, p=probs)

    for seed in (0, 1, 17, 9973, 2 * 9973 + 5):
        rng = np.random.default_rng(seed + n_valid)
        valid = np.zeros(N, np.float32)
        valid[rng.permutation(N)[:n_valid]] = 1.0
        probs = valid / np.float32(max(valid.sum(), 1.0))
        got = jax_random.choice_p(seed, N, shape, probs)
        np.testing.assert_array_equal(got, np.asarray(ref(valid, seed)))


@pytest.mark.parametrize("length", [5, 16, 17, 128, 300, 1024])
def test_cumsum_rounds_as_the_reference(length):
    x = np.random.default_rng(length).uniform(0, 1, length).astype(
        np.float32) / 7
    np.testing.assert_array_equal(jax_random.xla_cumsum_f32(x),
                                  np.asarray(jax.jit(jnp.cumsum)(x)))


def test_uniform_matches_jax():
    for seed in (0, 3, 99):
        np.testing.assert_array_equal(
            jax_random.uniform(seed, (7, 5)),
            np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                          (7, 5))))


# -- registration ------------------------------------------------------

def _rigid_scene(rng, N=64, noise=0.0):
    src = rng.standard_normal((N, 3)).astype(np.float32) * 2.0
    xi = rng.standard_normal(6).astype(np.float32) * 0.4
    R, tt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi)))
    dst = (src @ R.T + tt + noise * rng.standard_normal(
        (N, 3))).astype(np.float32)
    return src, dst, R, tt


def test_registration_subset_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(4):
        src, dst, _, _ = _rigid_scene(rng, noise=0.01 * trial)
        w = (rng.random(len(src)) < 0.8).astype(np.float32)
        R_j, t_j = jreg.weighted_kabsch(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(w))
        R_t, t_t = treg.weighted_kabsch(t(src), t(dst), t(w))
        np.testing.assert_allclose(n(R_t), np.asarray(R_j), atol=F32_TOL)
        np.testing.assert_allclose(n(t_t), np.asarray(t_j), atol=F32_TOL)
        cov = rng.standard_normal((3, 3)).astype(np.float32)
        np.testing.assert_allclose(
            n(treg.horn_rotation(t(cov))),
            np.asarray(jreg.horn_rotation(jnp.asarray(cov))), atol=F32_TOL)
        moved = src @ np.asarray(R_j).T + np.asarray(t_j)
        c_j = jreg.se3_estimate_covariance(jnp.asarray(moved),
                                           jnp.asarray(w), 0.01)
        c_t = treg.se3_estimate_covariance(t(moved), t(w),
                                           torch.tensor(0.01))
        np.testing.assert_allclose(n(c_t), np.asarray(c_j), rtol=COV_RTOL)
    # batched: a stack of fits in one call equals the fits one by one
    srcs = np.stack([_rigid_scene(rng)[0] for _ in range(3)])
    dsts = srcs[:, ::-1].copy()
    ws = np.ones(srcs.shape[:2], np.float32)
    Rb, tb = treg.weighted_kabsch(t(srcs), t(dsts), t(ws))
    for b in range(3):
        Rj, tj = jreg.weighted_kabsch(jnp.asarray(srcs[b]),
                                      jnp.asarray(dsts[b]),
                                      jnp.asarray(ws[b]))
        np.testing.assert_allclose(n(Rb[b]), np.asarray(Rj), atol=F32_TOL)
        np.testing.assert_allclose(n(tb[b]), np.asarray(tj), atol=F32_TOL)


# -- features ------------------------------------------------------------

def checkerboard_image(rng, H=120, W=160, n_squares=8):
    img = np.zeros((H, W), dtype=np.float32)
    sq_h, sq_w = H // n_squares, W // n_squares
    for i in range(n_squares):
        for j in range(n_squares):
            if (i + j) % 2 == 0:
                img[i * sq_h:(i + 1) * sq_h, j * sq_w:(j + 1) * sq_w] = 1.0
    img += rng.standard_normal((H, W)).astype(np.float32) * 0.02
    return img


def scene_image(kind, seed):
    """The reference tests' rendered frames, as float images: the
    textured blobs of tests/test_rgbd_handler.py (fewer NMS maxima than
    the budget, so padded slots carry pixel coordinates) and the
    corner-rich squares the shipped models were trained on."""
    from cslam_tpu.frontend.sim import render_corner_scene
    from test_rgbd_handler import INTR, make_pose, render_scene
    rng = np.random.default_rng(seed)
    pose = make_pose(rng.uniform(-1, 1), rng.uniform(-0.3, 0.3),
                     rng.uniform(-0.2, 0.2))
    img = (render_scene(pose, rng)[0] if kind == "blobs"
           else render_corner_scene(pose, INTR, rng)[0])
    return img.astype(np.float32) / 255.0


@pytest.mark.parametrize("kind,seed", [("blobs", 0), ("blobs", 1),
                                       ("corners", 0), ("corners", 1)])
def test_features_match_reference(kind, seed):
    img = scene_image(kind, seed)
    resp_j = np.asarray(jfeat.shi_tomasi_response(jnp.asarray(img)))
    resp_t = n(tfeat.shi_tomasi_response(t(img)))
    np.testing.assert_allclose(resp_t, resp_j, atol=RESPONSE_TOL)
    K = 128
    xy_j, d_j, s_j, m_j = jfeat.extract_features(jnp.asarray(img),
                                                 max_keypoints=K)
    xy_t, d_t, s_t, m_t = tfeat.extract_features(t(img), max_keypoints=K)
    np.testing.assert_array_equal(n(m_t), np.asarray(m_j))
    # every slot, padded ones included: the lower index first on ties
    np.testing.assert_array_equal(n(xy_t), np.asarray(xy_j))
    np.testing.assert_allclose(n(s_t), np.asarray(s_j), atol=RESPONSE_TOL)
    np.testing.assert_allclose(n(d_t), np.asarray(d_j), atol=F32_TOL)
    if kind == "blobs":
        assert 0 < np.asarray(m_j).sum() < K
    z = np.random.default_rng(seed).uniform(1, 5, K).astype(np.float32)
    np.testing.assert_allclose(
        n(tfeat.backproject(xy_t, t(z), 120.0, 121.0, 80.0, 60.0)),
        np.asarray(jfeat.backproject(xy_j, jnp.asarray(z), 120.0, 121.0,
                                     80.0, 60.0)), atol=F32_TOL)


def test_features_near_ties_may_order_differently():
    """Known divergence (ROADMAP queue 3): the port's convolutions round
    otherwise than XLA's, so two corners whose responses differ by less
    than that rounding can come out in the other order. On a noisy
    checkerboard (many near-equal corners) a few slots hold another
    corner, each with a response within RESPONSE_TOL of the reference's
    response in that slot (also at the budget's cut-off, where a corner
    can swap with the next one out)."""
    img = checkerboard_image(np.random.default_rng(0))
    xy_j, s_j, m_j = (np.asarray(a) for a in jfeat.detect_keypoints(
        jnp.asarray(img), max_keypoints=128))
    xy_t, s_t, m_t = (n(a) for a in tfeat.detect_keypoints(
        t(img), max_keypoints=128))
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(s_t, s_j, atol=RESPONSE_TOL)
    differ = np.any(xy_t != xy_j, axis=1)
    assert 0 < differ.sum() <= 8


def test_top_k_puts_the_lower_index_first_on_ties():
    x = torch.tensor([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf, -np.inf])
    vals, idx = tfeat.top_k(x, 7)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(n(x)), 7)
    np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
    np.testing.assert_array_equal(n(vals), np.asarray(ref_vals))


# -- mutual matching and 3D-3D RANSAC -------------------------------------

def _descriptor_pair(rng, K=96, D=64, noise=0.05, masked=10):
    desc0 = rng.standard_normal((K, D)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=1, keepdims=True)
    perm = rng.permutation(K)
    desc1 = desc0[perm] + noise * rng.standard_normal((K, D)).astype(
        np.float32)
    desc1 /= np.linalg.norm(desc1, axis=1, keepdims=True)
    m0 = np.ones(K, np.float32)
    m1 = np.ones(K, np.float32)
    m0[-masked:] = 0
    m1[:masked // 2] = 0
    return desc0, m0, desc1, m1, perm


def test_mutual_match_matches_reference():
    rng = np.random.default_rng(1)
    for noise, ratio in ((0.05, 0.9), (0.6, 0.9), (0.3, 1.0)):
        d0, m0, d1, m1, _ = _descriptor_pair(rng, noise=noise)
        i_j, v_j = jm2d.mutual_match(jnp.asarray(d0), jnp.asarray(m0),
                                     jnp.asarray(d1), jnp.asarray(m1),
                                     ratio)
        i_t, v_t = tm2d.mutual_match(t(d0), t(m0), t(d1), t(m1), ratio)
        np.testing.assert_array_equal(n(v_t), np.asarray(v_j))
        np.testing.assert_array_equal(n(i_t), np.asarray(i_j))
    # a fully masked query side: argmax over all -inf is index 0
    zero = np.zeros_like(m0)
    i_j, v_j = jm2d.mutual_match(jnp.asarray(d0), jnp.asarray(zero),
                                 jnp.asarray(d1), jnp.asarray(m1))
    i_t, v_t = tm2d.mutual_match(t(d0), t(zero), t(d1), t(m1))
    np.testing.assert_array_equal(n(i_t), np.asarray(i_j))
    np.testing.assert_array_equal(n(v_t), np.asarray(v_j))


def _ransac_case(rng, N=128, n_bad=38, n_invalid=10):
    src, dst, _, _ = _rigid_scene(rng, N=N, noise=0.01)
    dst[:n_bad] += rng.standard_normal((n_bad, 3)).astype(np.float32) * 5
    valid = np.ones(N, np.float32)
    valid[rng.permutation(N)[:n_invalid]] = 0
    return src, dst, valid


@pytest.mark.parametrize("case", ["outliers", "garbage", "few_valid"])
def test_ransac_rigid3d_matches_reference(case):
    rng = np.random.default_rng(2)
    src, dst, valid = _ransac_case(rng)
    thr, min_inl = 0.2, 6
    if case == "garbage":
        dst = rng.standard_normal(dst.shape).astype(np.float32) * 4
        thr, min_inl = 0.05, 10
    elif case == "few_valid":
        valid[:] = 0
        valid[rng.permutation(len(valid))[:5]] = 1
    for seed in (0, 5):
        ref = jm2d.ransac_rigid3d(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(valid), inlier_threshold=thr,
                                  min_inliers=min_inl, seed=seed)
        got = tm2d.ransac_rigid3d(t(src), t(dst), t(valid),
                                  inlier_threshold=thr, min_inliers=min_inl,
                                  seed=seed)
        assert_result_close(got, ref)


def _keyframe_pair(rng, K=96, D=64):
    scene = rng.standard_normal((K, 3)).astype(np.float32) * 2 + \
        np.array([0, 0, 5], np.float32)
    desc = rng.standard_normal((K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.02, 0.15, -0.05])))
    tt = np.array([0.3, -0.1, 0.2], np.float32)
    perm = rng.permutation(K)
    desc1 = desc[perm] + 0.03 * rng.standard_normal((K, D)).astype(
        np.float32)
    desc1 /= np.linalg.norm(desc1, axis=1, keepdims=True)
    pts1 = (scene @ R.T + tt)[perm].astype(np.float32)
    mask = np.ones(K, np.float32)
    mask[-6:] = 0
    return desc, scene, mask, desc1, pts1, mask.copy()


def test_verify_keyframe_pair_matches_reference():
    rng = np.random.default_rng(4)
    args = _keyframe_pair(rng)
    ref, cnt_j = jm2d.verify_keyframe_pair(*map(jnp.asarray, args), seed=3)
    got, cnt_t = tm2d.verify_keyframe_pair(*map(t, args), seed=3)
    assert float(cnt_t) == float(cnt_j) > 50
    assert bool(got.success)
    assert_result_close(got, ref)


def test_verify_keyframe_pairs_batched_seeds_match_reference():
    """The batched path: target b draws from seed + 9973 b, all targets
    in one pipeline; equal to the reference target by target."""
    rng = np.random.default_rng(5)
    pairs = [_keyframe_pair(rng) for _ in range(3)]
    d0 = np.stack([p[0] for p in pairs])
    p0 = np.stack([p[1] for p in pairs])
    m0 = np.stack([p[2] for p in pairs])
    # one received frame: target 0's other view
    d1, p1, m1 = pairs[0][3], pairs[0][4], pairs[0][5]
    ref, cnt_j = jm2d.verify_keyframe_pairs(
        *map(jnp.asarray, (d0, p0, m0, d1, p1, m1)), seed=11)
    got, cnt_t = tm2d.verify_keyframe_pairs(
        *map(t, (d0, p0, m0, d1, p1, m1)), seed=11)
    np.testing.assert_array_equal(n(cnt_t), np.asarray(cnt_j))
    assert_result_close(got, ref)
    assert bool(got.success[0]) and not bool(got.success[1])


# -- PnP -------------------------------------------------------------------

def make_pnp_scene(rng, N=96, planar=False, pose_scale=0.3):
    if planar:
        pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-3, 3, N),
                        np.full(N, 5.0)], 1).astype(np.float32)
    else:
        pts = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
        pts[:, 2] += 6
    xi = rng.standard_normal(6).astype(np.float32) * pose_scale
    R, tt = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi)))
    tt = tt + np.array([0, 0, 1], np.float32)
    X = pts @ R.T + tt
    rays = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    return pts, rays, R, tt


def test_p3p_recovers_a_known_pose():
    rng = np.random.default_rng(6)
    pts, rays, R, tt = make_pnp_scene(rng)
    W = pts[:3]
    f = np.concatenate([rays[:3], np.ones((3, 1), np.float32)], 1)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    R_j, t_j, ok_j = jpnp._p3p_poses(jnp.asarray(W), jnp.asarray(f))
    R_t, t_t, ok_t = tpnp._p3p_poses(t(W), t(f))
    np.testing.assert_array_equal(n(ok_t), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    np.testing.assert_allclose(n(R_t)[ok], np.asarray(R_j)[ok],
                               atol=POSE_TOL)
    np.testing.assert_allclose(n(t_t)[ok], np.asarray(t_j)[ok],
                               atol=POSE_TOL)
    err = [np.abs(n(R_t)[i] - R).max() + np.abs(n(t_t)[i] - tt).max()
           for i in np.flatnonzero(ok)]
    assert min(err) < 1e-3
    np.testing.assert_array_equal(tpnp.V_GRID, np.asarray(jnp.logspace(
        jnp.log10(0.125), jnp.log10(8.0), 129)))


@pytest.mark.parametrize("case", ["exact", "planar", "noisy", "garbage"])
def test_ransac_pnp_matches_reference(case):
    rng = np.random.default_rng(7)
    pts, rays, _, _ = make_pnp_scene(rng, planar=case == "planar")
    valid = np.ones(len(pts), np.float32)
    if case == "noisy":
        rays = rays + rng.standard_normal(rays.shape).astype(
            np.float32) * 1e-3
        bad = rng.choice(len(pts), 30, replace=False)
        rays[bad] += rng.uniform(0.1, 0.5, (30, 2)).astype(np.float32)
        valid[:7] = 0
    elif case == "garbage":
        rays = rng.uniform(-0.5, 0.5, rays.shape).astype(np.float32)
    ref = jpnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(rays),
                          jnp.asarray(valid), seed=2)
    got = tpnp.ransac_pnp(t(pts), t(rays), t(valid), seed=2)
    assert bool(got.success) == (case != "garbage")
    assert_result_close(got, ref)


def test_verify_keyframe_pairs_pnp_match_reference():
    rng = np.random.default_rng(8)
    pairs = [_keyframe_pair(rng) for _ in range(2)]
    d0 = np.stack([p[0] for p in pairs])
    p0 = np.stack([p[1] for p in pairs])
    m0 = np.stack([p[2] for p in pairs])
    d1, p1, m1 = pairs[0][3], pairs[0][4], pairs[0][5]
    rays1 = (p1[:, :2] / p1[:, 2:3]).astype(np.float32)
    ref, cnt_j = jpnp.verify_keyframe_pairs_pnp(
        *map(jnp.asarray, (d0, p0, m0, d1, rays1, m1)), seed=4)
    got, cnt_t = tpnp.verify_keyframe_pairs_pnp(
        *map(t, (d0, p0, m0, d1, rays1, m1)), seed=4)
    np.testing.assert_array_equal(n(cnt_t), np.asarray(cnt_j))
    assert_result_close(got, ref)
    ref1, _ = jpnp.verify_keyframe_pair_pnp(
        *map(jnp.asarray, (d0[0], p0[0], m0[0], d1, rays1, m1)), seed=4)
    got1, _ = tpnp.verify_keyframe_pair_pnp(
        *map(t, (d0[0], p0[0], m0[0], d1, rays1, m1)), seed=4)
    assert bool(got1.success)
    assert_result_close(got1, ref1)
    xy = rng.uniform(0, 160, (9, 2)).astype(np.float32)
    intr = (120.0, 118.0, 80.0, 60.0)
    np.testing.assert_array_equal(tpnp.normalize_keypoints(xy, intr),
                                  jpnp.normalize_keypoints(xy, intr))


# -- stereo ----------------------------------------------------------------

def _stereo_pair(seed=0, H=120, W=160, d=7.0):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 1, (H // 4 + 2, W // 4 + 2)).astype(np.float32)
    big = np.kron(tex, np.ones((4, 4), np.float32))
    xs = np.arange(W, dtype=np.float32)
    left = big[:H, :W]
    # right(x) = left(x + d), linear interpolation for fractional d
    x0 = np.clip(np.floor(xs + d).astype(int), 0, big.shape[1] - 2)
    fr = (xs + d) - np.floor(xs + d)
    right = (big[:H, x0] * (1 - fr) + big[:H, x0 + 1] * fr).astype(
        np.float32)
    ys, xs = np.meshgrid(np.arange(12, H - 12, 16),
                         np.arange(12, W - 12, 16), indexing="ij")
    xy = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    return left, right, xy


@pytest.mark.parametrize("d", [7.0, 4.4])
def test_stereo_matches_reference(d):
    left, right, xy = _stereo_pair(d=d)
    mask = np.ones(len(xy), np.float32)
    mask[::7] = 0
    disp_j, v_j = jstereo.stereo_correspondences(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy),
        jnp.asarray(mask), max_disparity=32)
    disp_t, v_t = tstereo.stereo_correspondences(
        t(left), t(right), t(xy), t(mask), max_disparity=32)
    np.testing.assert_array_equal(n(v_t), np.asarray(v_j))
    np.testing.assert_allclose(n(disp_t), np.asarray(disp_j), atol=1e-4)
    assert np.asarray(v_j).sum() > 10
    z_j = jstereo.depth_from_disparity(disp_j, v_j, 120.0, 0.1)
    z_t = tstereo.depth_from_disparity(disp_t, v_t, 120.0, 0.1)
    np.testing.assert_allclose(n(z_t), np.asarray(z_j), rtol=1e-5)
