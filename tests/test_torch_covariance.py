"""Port parity: per-factor covariance plumbing end to end (the counterpart
of tests/test_covariance.py's 8 tests) and the ReferenceFrames chain
published after an optimization (the counterpart of
tests/test_eval_artifacts.py::test_reference_frames_published_after_optimization),
each on both packages with the same inputs, on the CPU.

Tolerances: sqrt-informations and noise sigmas are the same numpy
arithmetic on the same f32 inputs, compared exactly; wire bytes
identical; factors ingested from messages within 1e-6; the optimum of
the heteroscedastic graph within OPT_TOL (f32 LM steps of two
libraries); registration covariances within REG_RTOL relative (the same
RANSAC samples and the same refinement, f32 reductions in another
order), or within ROUNDING_COV where the alignment is exact and the
covariance is f32 rounding; the published frames within ATE_TOL, the
mission parity bound of tests/test_torch_mission.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cslam_tpu.backend import decentralized_pgo as jdpgo
from cslam_tpu.backend import factor_graph as jfg
from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.ops import registration as jreg
from cslam_tpu.ops.matching2d import ransac_rigid3d as jransac
from cslam_tpu_torch.backend import decentralized_pgo as tdpgo
from cslam_tpu_torch.backend import factor_graph as tfg
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.ops import registration as treg
from cslam_tpu_torch.ops.matching2d import ransac_rigid3d as transac

from test_torch_mission import JAX, PORT, build_swarm, close, \
    drive_pipeline, run_optimization

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

OPT_TOL = 1e-4
REG_RTOL = 1e-3
ROUNDING_COV = 1e-10
ATE_TOL = 1e-3


def test_sqrt_info_from_msg_fallback_and_use():
    default = tfg.diag_sqrt_info(tdpgo.DEFAULT_NOISE_STD)
    np.testing.assert_array_equal(tdpgo.DEFAULT_NOISE_STD,
                                  jdpgo.DEFAULT_NOISE_STD)
    cov = np.array([0.01, 0.01, 0.04, 0.25, 0.25, 1.0], np.float32)
    for arg in (np.zeros(6), None, cov, np.array([0.1, -1, 1, 1, 1, 1]),
                np.full(6, np.inf)):
        ours = tdpgo._sqrt_info_from_msg(arg)
        np.testing.assert_array_equal(ours, jdpgo._sqrt_info_from_msg(arg))
        assert ours.dtype == np.float32
    np.testing.assert_allclose(tdpgo._sqrt_info_from_msg(np.zeros(6)),
                               default)
    np.testing.assert_allclose(tdpgo._sqrt_info_from_msg(None), default)
    np.testing.assert_allclose(np.diag(tdpgo._sqrt_info_from_msg(cov)),
                               1.0 / np.sqrt(cov), rtol=1e-5)


def test_noise_std_of_inverts_diag_sqrt_info():
    std = np.array([0.02, 0.03, 0.04, 0.1, 0.2, 0.3], np.float32)
    ours = tfg.noise_std_of(tfg.diag_sqrt_info(std))
    np.testing.assert_allclose(ours, std, rtol=1e-5)
    np.testing.assert_array_equal(
        ours, jfg.noise_std_of(jfg.diag_sqrt_info(std)))


def test_lc_message_roundtrips_covariance():
    cov = np.arange(1, 7, dtype=np.float32) * 0.01
    pose = (np.eye(3, dtype=np.float32), np.ones(3, np.float32))
    for name, args in (
            ("InterRobotLoopClosure", dict(
                robot0_id=0, robot0_keyframe_id=3, robot1_id=1,
                robot1_keyframe_id=5, success=True, pose=pose,
                covariance_diag=cov)),
            ("IntraRobotLoopClosure", dict(
                keyframe0_id=1, keyframe1_id=2, success=True, pose=pose,
                covariance_diag=cov)),
            ("KeyframeOdom", dict(id=4, covariance_diag=cov))):
        m = getattr(tmsgs, name)(**args)
        wire = getattr(jmsgs, name)(**args).to_bytes()
        assert m.to_bytes() == wire, name
        back = getattr(tmsgs, name).from_bytes(wire)
        np.testing.assert_array_equal(back.covariance_diag, cov)


def _make_node(dpgo, bus, robot_id=0, n_robots=2, **kw):
    params = {"robot_id": robot_id, "max_nb_robots": n_robots,
              "backend.max_waiting_time_sec": 60.0}
    return dpgo.DecentralizedPGO(params,
                                 bus.InProcessBus(bus.InProcessRouter(),
                                                  robot_id),
                                 bus.ManualClock(), **kw)


NODES = {"jax": (jdpgo, jbus, jmsgs, {}),
         "port": (tdpgo, tbus, tmsgs, {"device": "cpu"})}


def _ingest(name):
    dpgo, bus, m, kw = NODES[name]
    node = _make_node(dpgo, bus, **kw)
    cov = np.array([0.0001, 0.0001, 0.0001, 0.01, 0.01, 0.01], np.float32)
    node.odometry_callback(m.KeyframeOdom(id=0))
    node.odometry_callback(m.KeyframeOdom(id=1, covariance_diag=cov))
    node.intra_robot_loop_closure_callback(m.IntraRobotLoopClosure(
        keyframe0_id=0, keyframe1_id=1, success=True,
        covariance_diag=2 * cov))
    node.inter_robot_loop_closure_callback(m.InterRobotLoopClosure(
        robot0_id=0, robot0_keyframe_id=1, robot1_id=1,
        robot1_keyframe_id=0, success=True, covariance_diag=3 * cov))
    node.odometry_callback(m.KeyframeOdom(id=2))
    return node, cov


def test_ingestion_uses_message_covariance():
    node, cov = _ingest("port")
    ref, _ = _ingest("jax")
    try:
        odo, lc, odo2 = node.local_factors
        np.testing.assert_allclose(np.diag(odo.sqrt_info),
                                   1.0 / np.sqrt(cov), rtol=1e-5)
        np.testing.assert_allclose(np.diag(lc.sqrt_info),
                                   1.0 / np.sqrt(2 * cov), rtol=1e-5)
        inter = node.inter_robot_loop_closures[(0, 1)][-1]
        np.testing.assert_allclose(np.diag(inter.sqrt_info),
                                   1.0 / np.sqrt(3 * cov), rtol=1e-5)
        # no covariance -> default model, not garbage
        np.testing.assert_allclose(np.diag(odo2.sqrt_info),
                                   1.0 / tdpgo.DEFAULT_NOISE_STD, rtol=1e-5)
        # the same factors as the reference's back-end
        ours = node.local_factors + node.inter_robot_loop_closures[(0, 1)]
        theirs = ref.local_factors + ref.inter_robot_loop_closures[(0, 1)]
        assert len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            assert (a.key_from, a.key_to, a.is_loop) == \
                (b.key_from, b.key_to, b.is_loop)
            for x, y in ((a.R, b.R), (a.t, b.t), (a.sqrt_info, b.sqrt_info)):
                np.testing.assert_allclose(x, np.asarray(y), atol=1e-6)
    finally:
        node.close()


def test_pose_graph_msg_carries_per_factor_noise():
    """fill_pose_graph_msg keeps per-factor noise (not the default), and
    the port's message is the reference's, byte for byte."""
    cov = np.array([0.0004, 0.0004, 0.0004, 0.04, 0.04, 0.04], np.float32)
    wires = {}
    for name, (dpgo, bus, m, kw) in NODES.items():
        node = _make_node(dpgo, bus, **kw)
        node.odometry_callback(m.KeyframeOdom(id=0))
        node.odometry_callback(m.KeyframeOdom(id=1, covariance_diag=cov))
        pg = node.fill_pose_graph_msg([node.robot_id])
        assert len(pg.edges) == 1
        np.testing.assert_allclose(pg.edges[0].noise_std, np.sqrt(cov),
                                   rtol=1e-4)
        wires[name] = pg.to_bytes()
        if hasattr(node, "close"):
            node.close()
    assert wires["port"] == wires["jax"]
    back = tmsgs.PoseGraph.from_bytes(wires["jax"])
    np.testing.assert_allclose(back.edges[0].noise_std, np.sqrt(cov),
                               rtol=1e-4)


def _solve_x2(fgmod, pgomod, std_a, std_b, to_arrays_kw):
    """x of pose 2 after plain LM on a chain 0-1-2 with identity
    odometry and two conflicting direct 0->2 measurements."""
    fg = fgmod.FactorGraph()
    eye = np.eye(3, dtype=np.float32)
    odo_si = fgmod.diag_sqrt_info([0.05] * 6)
    fg.add_between(fgmod.BetweenFactor((0, 0), (0, 1), eye,
                                       np.zeros(3, np.float32), odo_si))
    fg.add_between(fgmod.BetweenFactor((0, 1), (0, 2), eye,
                                       np.zeros(3, np.float32), odo_si))
    for x, std in ((1.0, std_a), (-1.0, std_b)):
        fg.add_between(fgmod.BetweenFactor(
            (0, 0), (0, 2), eye, np.array([x, 0, 0], np.float32),
            fgmod.diag_sqrt_info([0.05] * 3 + [std] * 3), is_loop=True))
    fg.set_prior((0, 0))
    cfg = pgomod.PGOConfig(lm_max_iters=20, gnc_max_outer_iters=1,
                           barc_sq=1e9)  # plain LM, no outlier gating
    res = pgomod.gnc_optimize(fg.to_arrays(**to_arrays_kw), cfg)
    return float(np.asarray(res.t)[2, 0])


def test_heteroscedastic_noise_changes_optimum():
    """The optimum moves toward the confident measurement, on both
    packages alike (with a constant noise model it would not move)."""
    out = {}
    for stds in ((0.1, 0.1), (0.01, 1.0), (1.0, 0.01)):
        port = _solve_x2(tfg, tpgo, *stds, {"device": "cpu"})
        ref = _solve_x2(jfg, jpgo, *stds, {})
        assert port == pytest.approx(ref, abs=OPT_TOL), stds
        out[stds] = port
    assert abs(out[(0.1, 0.1)]) < 0.15
    assert out[(0.01, 1.0)] > 0.5     # pulled toward +1 measurement
    assert out[(1.0, 0.01)] < -0.5    # pulled toward -1 measurement


def test_registration_covariance_scales_with_noise():
    rng = np.random.default_rng(0)
    src = rng.uniform(-2, 2, (128, 3)).astype(np.float32)
    valid = np.ones(128, np.float32)
    covs = []
    for noise in (0.01, 0.1):
        dst = src + rng.normal(0, noise, src.shape).astype(np.float32)
        port = transac(torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(valid), inlier_threshold=0.5)
        ref = jransac(jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(valid), inlier_threshold=0.5)
        assert bool(port.success) and bool(ref.success)
        assert float(port.num_inliers) == float(ref.num_inliers)
        np.testing.assert_allclose(port.cov_diag.numpy(),
                                   np.asarray(ref.cov_diag), rtol=REG_RTOL)
        covs.append(port.cov_diag.numpy())
    c_low, c_high = covs
    assert np.all(c_low > 0) and np.all(np.isfinite(c_low))
    # noisier correspondences -> strictly larger uncertainty
    assert np.all(c_high > c_low)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_gnc_icp_returns_covariance(noise):
    """The reference test's exact shift (noise 0: the covariance is f32
    rounding of residuals ~1e-6, compared within ROUNDING_COV), and the
    same with measurement noise (compared within REG_RTOL)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    mask = np.ones(256, np.float32)
    dst = (pts + 0.005 + rng.normal(0, noise, pts.shape)).astype(np.float32)
    port = treg.gnc_icp(torch.from_numpy(pts), torch.from_numpy(mask),
                        torch.from_numpy(dst), torch.from_numpy(mask),
                        torch.eye(3), torch.zeros(3))
    ref = jreg.gnc_icp(jnp.asarray(pts), jnp.asarray(mask),
                       jnp.asarray(dst), jnp.asarray(mask),
                       jnp.eye(3), jnp.zeros(3))
    cov = port.cov_diag.numpy()
    assert cov.shape == (6,)
    assert np.all(np.isfinite(cov)) and np.all(cov >= 0)
    if noise:
        np.testing.assert_allclose(cov, np.asarray(ref.cov_diag),
                                   rtol=REG_RTOL)
    else:
        np.testing.assert_allclose(cov, np.asarray(ref.cov_diag),
                                   atol=ROUNDING_COV)


def _frames(P):
    s = build_swarm(P, 2, 16, drift=0.02)
    frames = []
    s.nodes[1].bus.subscribe("/cslam/reference_frames", frames.append)
    try:
        drive_pipeline(s)
        run_optimization(s)
        s.router.spin_until_idle()
    finally:
        close(s)
    return s, frames


def test_reference_frames_published_after_optimization():
    """broadcast_tf_callback publishes the origin->map->latest-optimized
    ->current chain; its composition is consistent, and the port's last
    frame is the reference's."""
    s, frames = _frames(PORT)
    _, ref_frames = _frames(JAX)
    assert frames, "no ReferenceFrames published after optimization"
    fr = frames[-1]
    assert isinstance(fr, tmsgs.ReferenceFrames)
    R = fr.latest_optimized[0] @ fr.odom_delta[0]
    t = fr.latest_optimized[0] @ fr.odom_delta[1] + fr.latest_optimized[1]
    np.testing.assert_allclose(R, fr.current_in_origin[0], atol=1e-5)
    np.testing.assert_allclose(t, fr.current_in_origin[1], atol=1e-4)
    gt_R, gt_t = s.world.pose(fr.robot_id, s.world.n_poses - 1)
    assert np.linalg.norm(np.asarray(fr.current_in_origin[1]) - gt_t) < 2.0
    rf = ref_frames[-1]
    assert len(frames) == len(ref_frames)
    assert (fr.robot_id, fr.origin_robot_id) == \
        (rf.robot_id, rf.origin_robot_id)
    for a, b in ((fr.current_in_origin, rf.current_in_origin),
                 (fr.latest_optimized, rf.latest_optimized),
                 (fr.odom_delta, rf.odom_delta)):
        np.testing.assert_allclose(a[0], np.asarray(b[0]), atol=ATE_TOL)
        np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=ATE_TOL)
