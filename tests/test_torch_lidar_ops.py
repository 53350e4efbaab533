"""Port parity, the lidar ops: cslam_tpu_torch against cslam_tpu on the
same seeded numpy inputs, on the CPU (the reference's functions jitted,
as its own tests run them), at the shapes of the reference's tests
(clouds of 256-512 points, one 8192-point sample draw).

Tolerances:
- Point-cloud codec: bytes and arrays identical.
- Scan Context, ring keys: identical, NaN and padded rows included
  (the ring key sums as XLA's CPU backend does, `ring_key`).
- `scancontext_distances`: max abs <= 1e-6, the same yaw.
- `ringkey_topk`, `ScanContextMatching` search and capacity growth:
  identical indices and items; distances and similarities within 1e-6.
- `voxel_downsample`: keep mask and order identical, centroids within
  1e-6 (measured: identical).
- Squared norms (`registration.squared_norms`, D = 3 to 60): identical
  to the compiled reference's.
- FPFH at N = 256 and 512: neighbours and distances identical (the
  distance matrix is bit-identical with those norms; with torch's plain
  sum of squares one pair of near-equal neighbours of 8192 swapped at
  N = 512), descriptors and normals max abs <= 1e-5 (measured
  <= 4.2e-7).
- `fpfh_correspondences`, `nearest_neighbors`: identical indices and
  masks, distances identical.
- `gnc_icp` from the same seed: the same success flag, R and t within
  1e-4 (the weighted Kabsch sums in another order; measured 5.4e-5),
  inlier fraction within 1e-3.
- RANSAC samples at N = 8192 (`draw_samples` against
  `jax.random.choice` with p, 5% and 50% valid): identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import fpfh as jfpfh
from cslam_tpu.ops import registration as jreg
from cslam_tpu.ops import scancontext as jsc
from cslam_tpu.ops import se3 as jse3
from cslam_tpu.matching.scancontext_matching import \
    ScanContextMatching as JMatching
from cslam_tpu.utils import pointcloud as jpc
from cslam_tpu_torch.matching.scancontext_matching import \
    ScanContextMatching as TMatching
from cslam_tpu_torch.ops import fpfh as tfpfh
from cslam_tpu_torch.ops import matching2d as tm2d
from cslam_tpu_torch.ops import registration as treg
from cslam_tpu_torch.ops import scancontext as tsc
from cslam_tpu_torch.utils import pointcloud as tpc

from test_fpfh import structured_cloud

torch.set_num_threads(1)

SC_DIST_TOL = 1e-6
CENTROID_TOL = 1e-6
FPFH_TOL = 1e-5
POSE_TOL = 1e-4
FRAC_TOL = 1e-3


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def padded_cloud(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(cap, np.float32)
    mask[:len(pts)] = 1.0
    return out, mask


def scan_like(seed, n_pts=3000):
    """Points out to past the Scan Context's 80 m, some exactly on the
    axes, NaN and infinite rows, a 10% padded tail."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-95, 95, (n_pts, 2)),
                          rng.uniform(-3.5, 6, (n_pts, 1))], 1).astype(
        np.float32)
    pts[:6, 0] = 0.0
    pts[6:9, 1] = 0.0
    pts[9:12] = np.nan
    pts[12, 2] = np.inf
    pts[13, 0] = -np.inf
    mask = (rng.random(n_pts) < 0.9).astype(np.float32)
    return pts, mask


# -- point-cloud codec -------------------------------------------------------

def test_pointcloud_codec_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 5, (50, 4)).astype(np.float32)
    pts[3, 1] = np.nan
    fields = ("x", "y", "z", "intensity")
    blob = tpc.create_cloud(pts, fields)
    assert blob == jpc.create_cloud(pts, fields)
    for names, skip in ((("x", "y", "z"), True), (None, False),
                        (("intensity", "x"), True)):
        np.testing.assert_array_equal(
            tpc.read_points_numpy_filtered(blob, names, skip),
            jpc.read_points_numpy_filtered(blob, names, skip))
    with pytest.raises(ValueError):
        tpc.read_points_numpy_filtered(b"XXXX" + blob[4:])


# -- Scan Context -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scancontext_and_ring_key_match_reference(seed):
    pts, mask = scan_like(seed)
    ref = np.asarray(jsc.pointcloud_to_scancontext(jnp.asarray(pts),
                                                   jnp.asarray(mask)))
    got = n(tsc.pointcloud_to_scancontext(t(pts), t(mask)))
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 100 and (ref == 0).any()
    sc = ref.copy()
    sc[4] = 0.0                                  # an empty ring
    np.testing.assert_array_equal(n(tsc.ring_key(t(sc))),
                                  np.asarray(jsc.ring_key(jnp.asarray(sc))))


def test_scancontext_distances_match_reference():
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 5, (20, 60)).astype(np.float32)
    q[:, 10:14] = 0.0                            # unengaged columns
    c = rng.uniform(0, 5, (7, 20, 60)).astype(np.float32)
    c[2, :, :30] = 0.0
    c[3] = np.roll(q, 7, axis=1)                 # a rotated revisit
    c[4] = 0.0                                   # nothing engaged
    d_ref, y_ref = jsc.scancontext_distances(jnp.asarray(q), jnp.asarray(c))
    d_got, y_got = tsc.scancontext_distances(t(q), t(c))
    np.testing.assert_allclose(n(d_got), np.asarray(d_ref), rtol=0,
                               atol=SC_DIST_TOL)
    np.testing.assert_array_equal(n(y_got), np.asarray(y_ref))
    assert float(d_ref[3]) < 1e-6 and float(d_ref[4]) == 1.0


def test_ringkey_topk_matches_reference():
    rng = np.random.default_rng(6)
    rks = rng.uniform(0, 3, (16, 20)).astype(np.float32)
    rks[5] = rks[2]                              # an exact tie
    for n_valid, k in ((10, 8), (16, 16), (3, 8)):
        q = rks[2].copy()
        i_ref, d_ref = jsc.ringkey_topk(jnp.asarray(rks), n_valid,
                                        jnp.asarray(q), k)
        i_got, d_got = tsc.ringkey_topk(t(rks), n_valid, t(q), k)
        np.testing.assert_array_equal(n(i_got), np.asarray(i_ref))
        np.testing.assert_allclose(n(d_got), np.asarray(d_ref), rtol=1e-6,
                                   atol=0)


def test_scancontext_matching_search_and_growth_match_reference():
    """Capacity 4 grows twice over 11 items; every search returns the
    reference's item and similarity; an all-zero query (distance 1)
    returns item 0 with similarity 0, as the reference."""
    dbs = (JMatching(capacity=4), TMatching(capacity=4, device="cpu"))
    assert all(db.search_best(np.zeros(1200)) == (None, None) for db in dbs)
    scs = []
    for i in range(11):
        pts, mask = scan_like(100 + i, 800)
        sc = np.asarray(jsc.pointcloud_to_scancontext(jnp.asarray(pts),
                                                      jnp.asarray(mask)))
        scs.append(sc.reshape(-1))
        for db in dbs:
            db.add_item(sc.reshape(-1), 1000 + i)
    assert [db._capacity for db in dbs] == [16, 16]
    assert dbs[1].data.shape == dbs[0].data.shape == (16, 1200)
    np.testing.assert_array_equal(n(dbs[1].data), np.asarray(dbs[0].data))
    queries = [s + np.float32(0.05) * (s > 0) for s in scs] + \
        [np.roll(scs[3].reshape(20, 60), 9, axis=1).reshape(-1),
         np.zeros(1200, np.float32)]
    for q in queries:
        (item_r,), (sim_r,) = dbs[0].search(q, 5)
        (item_g,), (sim_g,) = dbs[1].search(q, 5)
        assert item_g == item_r
        assert sim_g == pytest.approx(sim_r, abs=SC_DIST_TOL)
    assert dbs[1].search_best(np.zeros(1200)) == (1000, 0.0)


# -- voxel grid ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voxel_downsample_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    pts[:300] = pts[300:600] + rng.normal(0, 0.02, (300, 3)).astype(
        np.float32)                              # shared voxels
    pts[600] = (150.0, 0.0, 0.0)                 # out of range
    pts[601] = (-99.99, 99.9, 0.0)
    mask = (rng.random(2048) < 0.95).astype(np.float32)
    c_ref, k_ref = jreg.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                         0.3)
    c_got, k_got = treg.voxel_downsample(t(pts), t(mask), 0.3)
    c_ref, k_ref = np.asarray(c_ref), np.asarray(k_ref)
    np.testing.assert_array_equal(n(k_got), k_ref)
    keep = k_ref > 0
    assert 1000 < keep.sum() < 2000
    np.testing.assert_allclose(n(c_got)[keep], c_ref[keep], rtol=0,
                               atol=CENTROID_TOL)


# -- FPFH ---------------------------------------------------------------------

@pytest.mark.parametrize("dim", [3, 16, 33, 60])
def test_squared_norms_round_as_the_reference(dim):
    """The compiled reference's sum(x * x, axis=1), bit for bit: fused
    multiply-adds up to 32 columns, two halves of rounded squares above.
    The plain sum of rounded squares differs in the last place on a
    share of the rows, enough to reorder near-equal neighbours."""
    x = np.random.default_rng(dim).uniform(-30, 30, (2000, dim)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a * a, axis=1))(x))
    np.testing.assert_array_equal(n(treg.squared_norms(t(x))), ref)
    if dim in (3, 33):
        assert np.any(n(torch.sum(t(x) * t(x), dim=1)) != ref)


@pytest.mark.parametrize("n_pts,seed", [(256, 0), (512, 1), (500, 2)])
def test_fpfh_matches_reference(n_pts, seed):
    """Neighbours identical, normals and FPFH within 1e-5, a padded
    tail (500 points in 512) included."""
    pts = structured_cloud(np.random.default_rng(seed), n=n_pts) * 2.0
    P, M = padded_cloud(pts, 512 if n_pts > 256 else 256)
    ref_knn = jax.jit(jfpfh._knn_indices, static_argnums=2)
    i_ref, d_ref = (np.asarray(x) for x in ref_knn(jnp.asarray(P),
                                                   jnp.asarray(M), 16))
    i_got, d_got = tfpfh.knn_indices(t(P), t(M), 16)
    np.testing.assert_array_equal(n(i_got), i_ref)
    np.testing.assert_array_equal(n(d_got), d_ref)
    np.testing.assert_allclose(
        n(tfpfh.estimate_normals(t(P), t(M))),
        np.asarray(jax.jit(jfpfh.estimate_normals)(jnp.asarray(P),
                                                   jnp.asarray(M))),
        rtol=0, atol=FPFH_TOL)
    f_ref = np.asarray(jfpfh.fpfh(jnp.asarray(P), jnp.asarray(M)))
    f_got = n(tfpfh.fpfh(t(P), t(M)))
    np.testing.assert_allclose(f_got, f_ref, rtol=0, atol=FPFH_TOL)
    assert np.all(f_got[M == 0] == 0) and (f_got[M > 0] > 0).any()


def test_fpfh_neighbour_distances_are_never_nan():
    """fpfh.py excludes self as `d2 + eye(N) * inf`. Run eagerly that is
    NaN off the diagonal (0 * inf); the compiled reference folds it to
    +inf on the diagonal and +0 elsewhere. The port implements the
    compiled meaning: every neighbour distance is finite or +inf (for
    missing neighbours), as the compiled reference's."""
    pts = structured_cloud(np.random.default_rng(3), n=200) * 2.0
    P, M = padded_cloud(pts, 256)
    _, d_eager = jfpfh._knn_indices(jnp.asarray(P), jnp.asarray(M), 16)
    assert np.isnan(np.asarray(d_eager)).any()     # the eager meaning
    i_got, d_got = (n(x) for x in tfpfh.knn_indices(t(P), t(M), 16))
    assert not np.isnan(d_got).any()
    assert np.all(i_got[:200] < 200) and np.all(i_got[:200] !=
                                                np.arange(200)[:, None])
    # few valid points: the missing neighbours are +inf, never NaN
    few, few_m = padded_cloud(pts[:5], 16)
    i_few, d_few = (n(x) for x in tfpfh.knn_indices(t(few), t(few_m), 8))
    i_ref, d_ref = (np.asarray(x) for x in jax.jit(
        jfpfh._knn_indices, static_argnums=2)(jnp.asarray(few),
                                              jnp.asarray(few_m), 8))
    # 5 valid points: 4 neighbours each, 5 for the padded rows
    assert not np.isnan(d_few).any()
    assert np.isinf(d_few[:5, 4:]).all() and np.isinf(d_few[5:, 5:]).all()
    assert np.isfinite(d_few[:5, :4]).all()
    np.testing.assert_array_equal(i_few, i_ref)
    np.testing.assert_array_equal(d_few, d_ref)
    f = n(tfpfh.fpfh(t(few), t(few_m)))
    assert np.isfinite(f).all()


def test_fpfh_correspondences_and_nearest_neighbors_match_reference():
    rng = np.random.default_rng(3)
    pts = structured_cloud(rng, n=300)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.05, 0.02, 0.9], jnp.float32)))
    dst = (pts @ R.T + np.array([2.0, -1.0, 0.3], np.float32)).astype(
        np.float32)[rng.permutation(300)]
    a, ma = padded_cloud(pts, 320)
    b, mb = padded_cloud(dst, 320)
    fa = np.asarray(jfpfh.fpfh(jnp.asarray(a), jnp.asarray(ma)))
    fb = np.asarray(jfpfh.fpfh(jnp.asarray(b), jnp.asarray(mb)))
    i_ref, v_ref = jfpfh.fpfh_correspondences(*(jnp.asarray(x) for x in
                                                (fa, ma, fb, mb)))
    i_got, v_got = tfpfh.fpfh_correspondences(t(fa), t(ma), t(fb), t(mb))
    np.testing.assert_array_equal(n(i_got), np.asarray(i_ref))
    np.testing.assert_array_equal(n(v_got), np.asarray(v_ref))
    assert n(v_got).sum() > 100
    src = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    msrc = (rng.random(500) < 0.9).astype(np.float32)
    mdst = (rng.random(320) < 0.9).astype(np.float32)
    i_ref, d_ref = jax.jit(jreg.nearest_neighbors)(
        *(jnp.asarray(x) for x in (src, msrc, b, mdst)))
    i_got, d_got = treg.nearest_neighbors(t(src), t(msrc), t(b), t(mdst))
    np.testing.assert_array_equal(n(i_got), np.asarray(i_ref))
    np.testing.assert_array_equal(n(d_got), np.asarray(d_ref))


# -- GNC-ICP ------------------------------------------------------------------

@pytest.mark.parametrize("seed,yaw", [(0, 0.3), (1, -0.25), (2, 0.0)])
def test_gnc_icp_matches_reference(seed, yaw):
    rng = np.random.default_rng(seed)
    src = structured_cloud(rng, n=400) * 2.0
    R_true = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.01, yaw],
                                                 jnp.float32)))
    dst = (src @ R_true.T + np.array([0.5, -0.3, 0.1], np.float32) +
           rng.normal(0, 0.01, src.shape)).astype(np.float32)
    S, M = padded_cloud(src, 512)
    D, _ = padded_cloud(dst[rng.permutation(400)], 512)
    R0 = np.asarray(jreg.yaw_rotation(jnp.float32(0.8 * yaw)))
    np.testing.assert_allclose(
        n(treg.yaw_rotation(torch.tensor(0.8 * yaw, dtype=torch.float32))),
        R0, rtol=0, atol=1e-7)
    kw = dict(max_corr_dist=0.6, max_iters=12, iters_per_level=5)
    ref = jreg.gnc_icp(*(jnp.asarray(x) for x in (S, M, D, M, R0,
                                                  np.zeros(3, np.float32))),
                       **kw)
    got = treg.gnc_icp(t(S), t(M), t(D), t(M), t(R0),
                       torch.zeros(3), **kw)
    assert bool(got.success) == bool(ref.success)
    np.testing.assert_allclose(n(got.R), np.asarray(ref.R), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(n(got.t), np.asarray(ref.t), rtol=0,
                               atol=POSE_TOL)
    assert float(got.inlier_frac) == pytest.approx(float(ref.inlier_frac),
                                                   abs=FRAC_TOL)
    assert 10 < got.iterations <= 10 * 5 + 12
    np.testing.assert_allclose(n(got.R), R_true, atol=0.01)


@pytest.mark.parametrize("share", [0.05, 0.5])
def test_draw_samples_at_lidar_size_match_jax_random_choice(share):
    """FPFH-seeded RANSAC draws from an 8192-entry correspondence mask."""
    N, shape = 8192, (256, 3)
    rng = np.random.default_rng(int(share * 100))
    valid = (rng.random(N) < share).astype(np.float32)

    @jax.jit
    def ref(valid, seed):
        probs = valid / jnp.maximum(jnp.sum(valid), 1.0)
        return jax.random.choice(jax.random.PRNGKey(seed), N, shape=shape,
                                 replace=True, p=probs)

    got = tm2d.draw_samples(t(valid)[None], [0, 9973][:1], 256)
    np.testing.assert_array_equal(n(got)[0], np.asarray(ref(valid, 0)))
    got = tm2d.draw_samples(t(np.stack([valid, valid[::-1].copy()])),
                            [0, 9973], 256)
    np.testing.assert_array_equal(n(got)[1],
                                  np.asarray(ref(valid[::-1].copy(), 9973)))
