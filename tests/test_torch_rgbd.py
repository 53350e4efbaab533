"""Port parity, the visual front-end: RGBDHandler / StereoHandler of
cslam_tpu_torch against cslam_tpu on the same seeded renders, on the
CPU, through the bus, plus the time-stamped path through the port's
C++ sensor sync, MapManager dispatch, the visual chains of
tests/test_visual_chain.py, the reference's shipped-weight chain gates,
and a small visual mission on both packages.

Tolerances:
- Classical keyframes: keypoints, masks and 3D points identical;
  descriptors max abs <= 1e-5 (measured <= 6e-8). The published
  KeyframeRGB and KeyframeOdom are byte-identical, and so is
  LocalImageDescriptors but for fp16 descriptor values: an f32 value
  within 6e-8 of an fp16 rounding boundary rounds the other way, one
  fp16 step apart (measured: 1 of 57,600 values in this test's message,
  none of 230,400 on 4 other renders; at most 4 allowed).
- Verification results (success, inlier counts): identical; poses
  within 1e-4, covariance diagonals relative 1e-3.
- Learned keyframes (bf16 SuperPoint): >= 95% identical keypoints (the
  bf16 bound of tests/test_torch_visual_models.py); verification
  success identical on the chain cases.
- Small visual mission (2 robots x 8 poses): classical front-end, the
  same keyframes and the same verified loop-closure set, optimized ATE
  within 1e-4 m; learned front-end, the same keyframes, at least 80% of
  the loop closures in common and optimized ATE within 0.01 m
  (measured on both front-ends: the same 7 loop closures, optimized
  ATE within 2.1e-8 m); odometry ATE within 1e-6 m.
"""

import os
import sys

import numpy as np
import pytest
import torch

from cslam_tpu.backend.decentralized_pgo import \
    DecentralizedPGO as JDecentralizedPGO
from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.frontend import global_descriptor_component as jgdc
from cslam_tpu.frontend import loop_closure_detection as jlcd
from cslam_tpu.frontend import map_manager as jmm
from cslam_tpu.frontend import rgbd_handler as jrh
from cslam_tpu_torch.backend.decentralized_pgo import \
    DecentralizedPGO as TDecentralizedPGO
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.frontend import global_descriptor_component as tgdc
from cslam_tpu_torch.frontend import loop_closure_detection as tlcd
from cslam_tpu_torch.frontend import map_manager as tmm
from cslam_tpu_torch.frontend import rgbd_handler as trh
from cslam_tpu_torch.runtime import native as tnative

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_rgbd_handler import INTR, make_pose, render_scene  # noqa: E402
from test_visual_chain import PlaceModel, _chain_params  # noqa: E402

torch.set_num_threads(1)

POSE_TOL = 1e-4
COV_RTOL = 1e-3
F32_TOL = 1e-5
KEYPOINT_OVERLAP = 0.95

PACKAGES = {
    "jax": dict(bus=jbus, msgs=jmsgs, rh=jrh, gdc=jgdc, lcd=jlcd,
                pgo=JDecentralizedPGO, mm=jmm, kw={}),
    "torch": dict(bus=tbus, msgs=tmsgs, rh=trh, gdc=tgdc, lcd=tlcd,
                  pgo=TDecentralizedPGO, mm=tmm, kw={"device": "cpu"}),
}


def params_for(robot_id=0, n_robots=1, **extra):
    params = {
        "robot_id": robot_id, "max_nb_robots": n_robots,
        "frontend.max_queue_size": 5,
        "frontend.keyframe_generation_ratio_threshold": 1.0,
        "frontend.pnp_min_inliers": 6,
    }
    params.update(extra)
    return params


def handler(pkg, robot_id=0, n_robots=1, router=None, cls="RGBDHandler",
            max_keypoints=256, **extra):
    p = PACKAGES[pkg]
    router = router or p["bus"].InProcessRouter()
    bus = p["bus"].InProcessBus(router, robot_id)
    h = getattr(p["rh"], cls)(params_for(robot_id, n_robots, **extra), bus,
                              p["bus"].ManualClock(),
                              max_keypoints=max_keypoints, **p["kw"])
    return h, router, bus


def both(fn):
    """fn(pkg) for both packages: {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PACKAGES}


def assert_keyframes_equal(kf_t, kf_j):
    np.testing.assert_array_equal(kf_t.keypoints, kf_j.keypoints)
    np.testing.assert_array_equal(kf_t.mask, kf_j.mask)
    np.testing.assert_array_equal(kf_t.feat_mask, kf_j.feat_mask)
    np.testing.assert_array_equal(kf_t.points3d, kf_j.points3d)
    np.testing.assert_allclose(kf_t.descriptors, kf_j.descriptors,
                               atol=F32_TOL)


def assert_closures_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for field in ("robot0_id", "robot0_keyframe_id", "robot1_id",
                      "robot1_keyframe_id", "keyframe0_id",
                      "keyframe1_id", "success"):
            assert getattr(a, field, None) == getattr(b, field, None), field
        np.testing.assert_allclose(a.pose[0], b.pose[0], atol=POSE_TOL)
        np.testing.assert_allclose(a.pose[1], b.pose[1], atol=POSE_TOL)
        np.testing.assert_allclose(a.covariance_diag, b.covariance_diag,
                                   rtol=COV_RTOL)


def assert_descriptor_messages_equivalent(m_t, m_j):
    """Byte-identical but for fp16 descriptor values one fp16 step
    apart; the port's bytes parse in the reference. Returns how many
    fp16 values differ."""
    a = m_t.descriptors.astype(np.float32)
    b = m_j.descriptors.astype(np.float32)
    np.testing.assert_allclose(a, b, rtol=2.0 ** -10, atol=0)
    same_desc = tmsgs.LocalImageDescriptors.from_bytes(m_t.to_bytes())
    same_desc.descriptors = m_j.descriptors
    assert same_desc.to_bytes() == m_j.to_bytes()
    parsed = jmsgs.LocalImageDescriptors.from_bytes(m_t.to_bytes())
    np.testing.assert_array_equal(parsed.descriptors, m_t.descriptors)
    np.testing.assert_array_equal(parsed.keypoints, m_t.keypoints)
    return int(np.sum(a != b))


# -- keyframes and messages, classical -------------------------------------

def test_classical_keyframes_and_descriptor_messages_match_reference():
    def run(pkg):
        rng = np.random.default_rng(0)
        h, router, bus = handler(pkg)
        out = {"kf": [], "odom": [], "desc": []}
        bus.subscribe("cslam/keyframe_data", out["kf"].append)
        bus.subscribe("cslam/keyframe_odom", out["odom"].append)
        bus.subscribe("/cslam/local_descriptors", out["desc"].append)
        for pose in (make_pose(0.0), make_pose(0.4, 0.1, 0.03)):
            img, depth = render_scene(pose, rng)
            h.add_sensor_data(img, depth, INTR, pose)
            h.process_new_sensor_data()
        bus.publish("cslam/local_descriptors_request",
                    PACKAGES[pkg]["msgs"].LocalDescriptorsRequest(
                        keyframe_id=1, matches_robot_id=[1],
                        matches_keyframe_id=[3]))
        router.spin_until_idle()
        return h, out

    (h_j, o_j), (h_t, o_t) = run("jax"), run("torch")
    for k in (0, 1):
        assert_keyframes_equal(h_t.local_keyframes[k],
                               h_j.local_keyframes[k])
    assert 10 < h_t.local_keyframes[0].mask.sum() < 256
    for a, b in zip(o_t["kf"], o_j["kf"]):
        assert a.to_bytes() == b.to_bytes()
    for a, b in zip(o_t["odom"], o_j["odom"]):
        assert a.to_bytes() == b.to_bytes()
    assert len(o_t["desc"]) == len(o_j["desc"]) == 1
    n_diff = assert_descriptor_messages_equivalent(o_t["desc"][0],
                                                   o_j["desc"][0])
    assert n_diff <= 4, n_diff
    assert h_t.log_local_descriptors_cumulative_communication == \
        h_j.log_local_descriptors_cumulative_communication


# -- verification, classical -------------------------------------------------

@pytest.mark.parametrize("case", ["revisit", "different_place"])
def test_intra_robot_verification_matches_reference(case):
    def run(pkg):
        rng = np.random.default_rng(1)
        h, router, bus = handler(pkg)
        results = []
        bus.subscribe("cslam/intra_robot_loop_closure", results.append)
        img, depth = render_scene(make_pose(0.0), rng)
        h.add_sensor_data(img, depth, INTR, make_pose(0.0))
        h.process_new_sensor_data()
        pose1 = make_pose(0.4, 0.1, 0.03)
        img, depth = render_scene(pose1, rng,
                                  seed=99 if case != "revisit" else 0)
        h.add_sensor_data(img, depth, INTR, pose1)
        h.process_new_sensor_data()
        bus.publish("cslam/local_keyframe_match",
                    PACKAGES[pkg]["msgs"].LocalKeyframeMatch(
                        keyframe0_id=0, keyframe1_id=1))
        router.spin_until_idle()
        return results

    res = both(run)
    assert_closures_close(res["torch"], res["jax"])
    assert res["torch"][0].success == (case == "revisit")


def test_batched_inter_robot_verification_matches_reference():
    """One request targeting four keyframes (three near, one far): the
    batched path, targets seeded seed + 9973 b."""
    def run(pkg):
        rng = np.random.default_rng(7)
        router = PACKAGES[pkg]["bus"].InProcessRouter()
        h0, _, bus0 = handler(pkg, 0, 2, router)
        h1, _, _ = handler(pkg, 1, 2, router)
        results = []
        router.subscribe("/cslam/inter_robot_loop_closure", results.append)
        img, depth = render_scene(make_pose(0.0), rng)
        h0.add_sensor_data(img, depth, INTR, make_pose(0.0))
        h0.process_new_sensor_data()
        for p in (make_pose(0.3, 0.05, 0.02), make_pose(0.5, -0.1, -0.04),
                  make_pose(0.2, 0.15, 0.0), make_pose(60.0, 0.0, np.pi)):
            img, depth = render_scene(p, rng)
            h1.add_sensor_data(img, depth, INTR, p)
            h1.process_new_sensor_data()
        bus0.publish("cslam/local_descriptors_request",
                     PACKAGES[pkg]["msgs"].LocalDescriptorsRequest(
                         keyframe_id=0, matches_robot_id=[1, 1, 1, 1],
                         matches_keyframe_id=[0, 1, 2, 3]))
        router.spin_until_idle()
        # and one single-target request: the per-pair path
        bus0.publish("cslam/local_descriptors_request",
                     PACKAGES[pkg]["msgs"].LocalDescriptorsRequest(
                         keyframe_id=0, matches_robot_id=[1],
                         matches_keyframe_id=[1]))
        router.spin_until_idle()
        return results

    res = both(run)
    assert_closures_close(res["torch"], res["jax"])
    assert [lc.success for lc in res["torch"]] == [True, True, True, False,
                                                   True]


def test_depthless_query_frame_verifies_through_pnp():
    """The PnP mode on a received frame with no valid depth (the case of
    tests/test_pnp.py), both packages."""
    rng = np.random.default_rng(6)
    N, D = 96, 64
    pts = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    pts[:, 2] += 6
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.1, -0.05, 1.0], np.float32)
    X = pts @ R.T + t
    rays = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    desc = rng.standard_normal((N, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    mask = np.ones(N, np.float32)
    fx, fy, cx, cy = 200.0, 200.0, 80.0, 60.0
    keypoints = np.stack([rays[:, 0] * fx + cx, rays[:, 1] * fy + cy],
                         1).astype(np.float32)

    def run(pkg):
        p = PACKAGES[pkg]
        h, router, bus = handler(pkg, 1, 2,
                                 **{"frontend.verification_mode": "auto"})
        h.local_keyframes[0] = p["rh"].LocalKeyframe(
            0, np.zeros((N, 2), np.float32), desc, pts, mask,
            (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
            feat_mask=mask)
        got = []
        bus.subscribe("/cslam/inter_robot_loop_closure", got.append)
        msg = p["msgs"].LocalImageDescriptors(
            robot_id=0, keyframe_id=7, matches_robot_id=[1, 1],
            matches_keyframe_id=[0, 0], keypoints=keypoints,
            descriptors=desc.astype(np.float16),
            points3d=np.zeros((N, 3), np.float32),
            valid3d=np.zeros(N, np.float32), valid2d=mask,
            intrinsics=(fx, fy, cx, cy))
        h.receive_local_image_descriptors(msg)       # batched PnP
        msg.matches_robot_id, msg.matches_keyframe_id = [1], [0]
        h.receive_local_image_descriptors(msg)       # per-pair PnP
        router.spin_until_idle()
        return got

    res = both(run)
    assert_closures_close(res["torch"], res["jax"])
    assert all(lc.success for lc in res["torch"])
    np.testing.assert_allclose(res["torch"][0].pose[1], t, atol=2e-2)


def test_keyframe_gating_matches_reference():
    def run(pkg):
        rng = np.random.default_rng(4)
        h, _, _ = handler(pkg, **{
            "frontend.keyframe_generation_ratio_threshold": 0.5})
        out = []
        img, depth = render_scene(make_pose(0.0), rng)
        for _ in range(2):
            h.add_sensor_data(img, depth, INTR, make_pose(0.0))
            out.append(h.process_new_sensor_data())
        far = make_pose(50.0, 0.0, np.pi)
        img2, depth2 = render_scene(far, rng)
        h.add_sensor_data(img2, depth2, INTR, far)
        out.append(h.process_new_sensor_data())
        return out

    res = both(run)
    assert res["torch"] == res["jax"] == [0, None, 1]


# -- learned handler ----------------------------------------------------------

def test_learned_handler_matches_reference():
    """frontend.features: learned with no checkpoint configured loads the
    shipped SuperPoint and the shipped 3-layer LightGlue on both
    packages; the keyframes agree within the bf16 bound and the
    intra-robot verification of a displaced revisit gives the same
    result."""
    from cslam_tpu.frontend.sim import render_corner_scene

    def run(pkg):
        rng = np.random.default_rng(2)
        h, router, bus = handler(pkg, max_keypoints=128,
                                 **{"frontend.features": "learned"})
        results = []
        bus.subscribe("cslam/intra_robot_loop_closure", results.append)
        for pose in (make_pose(0.0), make_pose(0.12, 0.06, 0.035)):
            img, depth = render_corner_scene(pose, INTR, rng)
            h.add_sensor_data(img, depth, INTR, pose)
            h.process_new_sensor_data()
        bus.publish("cslam/local_keyframe_match",
                    PACKAGES[pkg]["msgs"].LocalKeyframeMatch(
                        keyframe0_id=0, keyframe1_id=1))
        router.spin_until_idle()
        return h, results

    (h_j, r_j), (h_t, r_t) = run("jax"), run("torch")
    # loaded, not random init (tests/test_trained_weights.py:133)
    from cslam_tpu_torch.models import convert, zoo
    want = convert.superpoint_state_dict(convert.load_flat(
        zoo.shipped_checkpoint("superpoint_synth.npz")))
    for k, v in h_t.superpoint.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    assert h_t.lightglue.model.num_layers == 3
    for k in (0, 1):
        a, b = h_t.local_keyframes[k], h_j.local_keyframes[k]
        ref = {tuple(p) for p in b.keypoints[b.feat_mask > 0]}
        got = [tuple(p) for p in a.keypoints[a.feat_mask > 0]]
        assert sum(p in ref for p in got) >= KEYPOINT_OVERLAP * len(ref)
        assert a.descriptors.shape == (128, 256)
    assert len(r_t) == len(r_j) == 1
    assert r_t[0].success and r_j[0].success
    np.testing.assert_allclose(r_t[0].pose[1], r_j[0].pose[1], atol=0.02)


# -- stereo ---------------------------------------------------------------------

SH, SW = 96, 192
SFX, SFY, SCX, SCY, SB = 100.0, 100.0, 96.0, 48.0, 0.2


def _texture(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((SH, SW)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    for axis in (0, 1):
        img = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), axis, img)
    img -= img.min()
    return (img / img.max()).astype(np.float32)


def _shift(img, d):
    x = np.arange(SW, dtype=np.float32) + d
    x0 = np.clip(np.floor(x).astype(int), 0, SW - 1)
    x1 = np.clip(x0 + 1, 0, SW - 1)
    f = (x - x0).astype(np.float32)
    return img[:, x0] * (1 - f) + img[:, x1] * f


def test_stereo_handler_matches_reference(capsys):
    """The ZNCC pair path (camera model from infos), the 4-way
    time-stamped sync, the precomputed-disparity path, the camera-model
    checks and the encoding validation, on both packages."""
    def run(pkg):
        p = PACKAGES[pkg]
        linfo = p["rh"].CameraInfo(fx=SFX, fy=SFY, cx=SCX, cy=SCY, tx=0.0)
        rinfo = p["rh"].CameraInfo(fx=SFX, fy=SFY, cx=SCX, cy=SCY,
                                   tx=-SFX * SB)
        h, router, _ = handler(pkg, cls="StereoHandler",
                               **{"frontend.stereo_max_disparity": 32,
                                  "frontend.stereo_baseline_fallback": 0.12})
        left = _texture(seed=5)
        pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        h.add_stereo_pair(left, _shift(left, 5.0), pose, left_info=linfo,
                          right_info=rinfo)
        assert h.process_new_sensor_data() == 0
        # 4-way sync: a complete tuple, then one missing its right info
        h.add_odometry(1.0, pose)
        h.add_odometry(2.0, pose)
        h.add_left_image(1.000, left)
        h.add_camera_info_left(1.004, linfo)
        h.add_camera_info_right(1.006, rinfo)
        h.add_right_image(1.008, _shift(left, 6.0))
        h.add_left_image(2.0, left)
        h.add_right_image(2.0, _shift(left, 6.0))
        h.add_camera_info_left(2.0, linfo)
        queued = len(h.received_queue)
        assert h.process_new_sensor_data() == 1
        # precomputed disparity
        rng = np.random.default_rng(5)
        img, depth = render_scene(make_pose(0.0), rng)
        with np.errstate(divide="ignore"):
            disp = np.where(depth > 0, INTR.fx * INTR.baseline /
                            np.maximum(depth, 0.1), 0.0).astype(np.float32)
        h.add_stereo_data(img, disp, INTR, make_pose(0.0))
        assert h.process_new_sensor_data() == 2
        models = [h.stereo_camera_model(linfo, p["rh"].CameraInfo(
            fx=SFX, fy=SFY, cx=SCX, cy=SCY, tx=tx))
            for tx in (0.0, 0.0, +SFX * SB, -SFX * 12.0, -SFX * 12.0)]
        h.add_stereo_pair(np.zeros((4, 4, 2), np.float32),
                          np.zeros((4, 4), np.float32), pose)
        h.add_stereo_pair(np.zeros((4, 4), np.int32),
                          np.zeros((4, 4), np.float32), pose)
        out = capsys.readouterr().out.replace("r0", "")
        return h, queued, models, out

    (h_j, q_j, m_j, out_j), (h_t, q_t, m_t, out_t) = run("jax"), \
        run("torch")
    assert q_t == q_j == 1
    for k in (0, 1, 2):
        a, b = h_t.local_keyframes[k], h_j.local_keyframes[k]
        np.testing.assert_array_equal(a.keypoints, b.keypoints)
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_allclose(a.points3d, b.points3d, rtol=1e-4,
                                   atol=1e-5)
    assert h_t.local_keyframes[0].mask.sum() >= 10
    assert [None if m is None else m.baseline for m in m_t] == \
        [None if m is None else m.baseline for m in m_j]
    assert m_t[2] is None and m_t[0].baseline == pytest.approx(0.12)
    assert h_t.log_dropped_frames == h_j.log_dropped_frames == 2
    assert out_t == out_j
    assert out_t.count("only printed once") == 1
    assert out_t.count("quite large") == 1


# -- the time-stamped path through the port's C++ sync -------------------------

@pytest.fixture(scope="module")
def sync_lib():
    return tnative.build(tnative.SYNC_SOURCE)


def test_sensor_sync_pairs_and_drops(sync_lib):
    """The cases of tests/test_sensor_sync.py on the port's binding."""
    sync = tnative.NativeSensorSync(n_streams=2, slop=0.02, max_queue=10,
                                    odom_slop=0.03)
    sync.push(0, 1.000, 11)
    assert sync.take() is None
    sync.push(1, 1.005, 21)
    stamp, handles = sync.take()
    assert handles == [11, 21] and abs(stamp - 1.0) < 1e-9
    sync.close()
    sync = tnative.NativeSensorSync(2, 0.02, 10, 0.03)
    sync.push(0, 1.0, 1)
    sync.push(1, 2.0, 2)
    sync.push(0, 2.001, 3)
    assert sync.take()[1] == [3, 2]
    sync.push_odom(5.0, 50)
    sync.push_odom(5.1, 51)
    assert sync.lookup_odom(5.02) == (50, 5.0)
    assert sync.lookup_odom(5.09) == (51, 5.1)
    assert sync.lookup_odom(6.0) is None
    with pytest.raises(ValueError):
        sync.push(2, 1.0, 9)
    sync.close()
    assert sync_lib.name.startswith("libcslam_sync_")
    assert sync_lib.parent == tnative.BUILD_DIR


def test_rgbd_handler_timestamped_path(sync_lib):
    rng = np.random.default_rng(0)
    h, _, _ = handler("torch")
    pose = make_pose(0.0)
    img, depth = render_scene(pose, rng)
    h.add_odometry(10.000, pose)
    h.add_image(10.001, img, INTR)
    h.add_depth(10.004, depth)
    assert h.process_new_sensor_data() == 0
    img2, depth2 = render_scene(make_pose(1.0), rng)
    h.add_image(20.0, img2, INTR)
    h.add_depth(20.0, depth2)
    assert h.process_new_sensor_data() is None
    h.close()


# -- map manager -------------------------------------------------------------

def test_map_manager_dispatch():
    for sensor, cls in (("rgbd", trh.RGBDHandler),
                        ("stereo", trh.StereoHandler),
                        ("RGBD", trh.RGBDHandler)):
        router = tbus.InProcessRouter()
        h = tmm.make_sensor_handler(
            params_for(**{"frontend.sensor_type": sensor}),
            tbus.InProcessBus(router, 0), tbus.ManualClock(), device="cpu")
        assert type(h) is cls
        ref = jmm.make_sensor_handler(
            params_for(**{"frontend.sensor_type": sensor}),
            jbus.InProcessBus(jbus.InProcessRouter(), 0), jbus.ManualClock())
        assert type(ref).__name__ == cls.__name__
    # the lidar branch (ported with the lidar slice): LidarHandler
    lidar = params_for(**{"frontend.sensor_type": "lidar"})
    h = tmm.make_sensor_handler(lidar, tbus.InProcessBus(
        tbus.InProcessRouter(), 0), tbus.ManualClock(), device="cpu")
    ref = jmm.make_sensor_handler(lidar, jbus.InProcessBus(
        jbus.InProcessRouter(), 0), jbus.ManualClock())
    assert type(h).__name__ == type(ref).__name__ == "LidarHandler"
    rng = np.random.default_rng(0)
    h, _, _ = handler("torch")
    mm = tmm.MapManager(h, {"frontend.map_manager_process_period_ms": 50})
    assert mm.period_ms == 50 and mm.tick() is None and mm.processed == 0
    img, depth = render_scene(make_pose(0.0), rng)
    h.add_sensor_data(img, depth, INTR, make_pose(0.0))
    assert mm.tick() == 0 and mm.processed == 1


# -- the visual chains -----------------------------------------------------------

def run_chain(pkg, params, poses, render, max_keypoints=256, seed=1):
    """tests/test_visual_chain.py's chain: handler -> descriptor component
    -> detection -> verification -> back-end, over one bus."""
    p = PACKAGES[pkg]
    router = p["bus"].InProcessRouter()
    clock = p["bus"].ManualClock()
    bus = p["bus"].InProcessBus(router, 0)
    model = PlaceModel()
    h = p["rh"].RGBDHandler(params, bus, clock, max_keypoints=max_keypoints,
                            **p["kw"])
    gdc = p["gdc"].GlobalDescriptorComponent(params, bus, model=model,
                                             batch_size=1, **p["kw"])
    p["lcd"].GlobalDescriptorLoopClosureDetection(
        params, bus, clock, descriptor_model=model, **p["kw"])
    backend = p["pgo"](params, bus, clock, **p["kw"])
    rng = np.random.default_rng(seed)
    try:
        for pose in poses:
            img, depth = render(pose, rng)
            h.add_sensor_data(img, depth, INTR, pose)
            h.process_new_sensor_data()
            gdc.tick()
            router.spin_until_idle()
        return [f for f in backend.local_factors if f.is_loop], \
            len(backend.odometry_pose_estimates)
    finally:
        if hasattr(backend, "close"):
            backend.close()


def _assert_loops_close(got, want, atol):
    assert [(f.key_from, f.key_to) for f in got] == \
        [(f.key_from, f.key_to) for f in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.R, b.R, atol=atol)
        np.testing.assert_allclose(a.t, b.t, atol=atol)


def test_classical_visual_chain_matches_reference():
    poses = [make_pose(0.0), make_pose(0.8, 0.2, 0.1),
             make_pose(1.6, 0.0, 0.2), make_pose(0.8, -0.2, 0.1),
             make_pose(0.02, 0.01, 0.005)]
    res = both(lambda pkg: run_chain(pkg, _chain_params(), poses,
                                     render_scene))
    (l_t, n_t), (l_j, n_j) = res["torch"], res["jax"]
    assert n_t == n_j == 5 and len(l_t) >= 1
    _assert_loops_close(l_t, l_j, POSE_TOL)


def test_learned_visual_chain_matches_reference():
    params = _chain_params(**{
        "frontend.features": "learned", "frontend.lightglue_layers": 2,
        "frontend.lightglue_score_threshold": 0.0})
    poses = [make_pose(0.0), make_pose(0.8, 0.2, 0.1),
             make_pose(1.6, 0.0, 0.2), make_pose(0.8, -0.2, 0.1),
             make_pose(0.0)]
    res = both(lambda pkg: run_chain(pkg, params, poses, render_scene,
                                     max_keypoints=128))
    (l_t, n_t), (l_j, n_j) = res["torch"], res["jax"]
    assert n_t == n_j == 5 and len(l_t) >= 1
    _assert_loops_close(l_t, l_j, 0.02)
    np.testing.assert_allclose(l_t[0].R, np.eye(3), atol=0.05)


# -- the reference's shipped-weight chain gates, on the port ----------------------

def _chip_smoke():
    """chip_smoke.py as a module: its shipped-weight gates take a device,
    so the card and the CPU run one implementation."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trained_chain_verifies_offset_revisit():
    """tests/test_trained_weights.py:169 on the port: the shipped
    SuperPoint + LightGlue, through the whole chain, verify a displaced
    revisit (~0.15 m, 2 deg) and the closure agrees with ground truth
    (rotation within 0.05, translation within 0.15 m)."""
    rot, trans = _chip_smoke().check_offset_revisit("cpu")
    assert rot <= 0.05 and trans <= 0.15


def test_trained_inter_robot_verification():
    """tests/test_trained_weights.py:233 on the port, its poses and seed:
    robot 0's learned keyframe features cross the bus and robot 1
    verifies them against its own view 0.4 m away (rotation within
    0.05, translation within 0.15 m)."""
    rot, trans = _chip_smoke().check_inter_robot("cpu")
    assert rot <= 0.05 and trans <= 0.15


# -- a small visual mission on both packages -----------------------------------

def _bench():
    """benchmarks/visual_mission_bench.py as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "visual_mission_bench.py")
    spec = importlib.util.spec_from_file_location("visual_mission_bench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_visual_mission(n_robots, n_poses, features, traj):
    """benchmarks/visual_mission_bench.py's mission on the reference
    (its main() writes a result file, so its steps are driven here)."""
    vb = _bench()
    from cslam_tpu.backend import pgo
    from cslam_tpu.node import SwarmNode
    from test_e2e_swarm import run_optimization

    world = vb.SquareWorld()
    router = jbus.InProcessRouter()
    clock = jbus.ManualClock()
    model, _ = vb.make_place_model("cosplace")
    cfg = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)
    nodes, handlers = {}, {}
    for rid in range(n_robots):
        bus = jbus.InProcessBus(router, rid)
        params = vb.make_params(rid, n_robots, 6, 0.75)
        params["frontend.features"] = features
        handlers[rid] = jrh.RGBDHandler(params, bus, clock,
                                        max_keypoints=128)
        jgdc.GlobalDescriptorComponent(params, bus, model=model,
                                       batch_size=1)
        nodes[rid] = SwarmNode(params, bus, clock, descriptor_model=model,
                               pgo_config=cfg)
    true, odom = traj
    rng = np.random.default_rng(3)
    kf_to_pose = {rid: {} for rid in range(n_robots)}
    for kf in range(n_poses):
        for rid in range(n_robots):
            img, depth = world.render(true[rid][kf], rng)
            handlers[rid].add_sensor_data(
                img, depth, vb.INTR, (odom[rid][0][kf], odom[rid][1][kf]))
            kf_id = handlers[rid].process_new_sensor_data()
            if kf_id is not None:
                kf_to_pose[rid][kf_id] = kf
        router.spin_until_idle(max_rounds=2000)
    for _ in range(4):
        for node in nodes.values():
            node.tick_detection_publication()
        router.spin_until_idle(max_rounds=2000)
        for node in nodes.values():
            node.tick_inter_robot_detection()
        router.spin_until_idle(max_rounds=2000)
    run_optimization(router, nodes, rounds=20)
    intra = sorted((rid, f.key_from, f.key_to) for rid, n in nodes.items()
                   for f in n.backend.local_factors if f.is_loop)
    inter = sorted({(tuple(lc.key_from), tuple(lc.key_to))
                    for n in nodes.values()
                    for lcs in n.backend.inter_robot_loop_closures.values()
                    for lc in lcs})
    ate = {}
    from cslam_tpu.utils.evaluation import ate_rmse
    for rid in range(n_robots):
        gt_t = np.stack([p[1] for p in true[rid]])
        est = nodes[rid].backend.current_pose_estimates
        own = [k for k in sorted(est) if k[0] == rid
               and k[1] in kf_to_pose[rid]]
        if len(own) < 3:
            continue
        idx = [kf_to_pose[rid][k[1]] for k in own]
        ate[rid] = (ate_rmse(np.stack([odom[rid][1][i] for i in idx]),
                             gt_t[idx]),
                    ate_rmse(np.stack([est[k][1] for k in own]), gt_t[idx]))
    for node in nodes.values():
        node.backend._executor.shutdown(wait=True)
    return {"keyframe_poses": {r: sorted(m.values())
                               for r, m in kf_to_pose.items()},
            "intra_loop_closures": intra, "inter_loop_closures": inter,
            "ate": ate}


@pytest.mark.parametrize("features", ["classical", "learned"])
def test_small_visual_mission_matches_reference(features):
    """2 robots x 8 poses through SwarmNode with the shipped CosPlace at
    0.75, budget 6, 4 detection rounds; each package renders its own
    trajectories, which agree (positions exactly, rotations within
    1e-6)."""
    vb = _bench()
    from cslam_tpu_torch.visual_mission import run_visual_mission, \
        trajectories
    traj = vb.trajectories(2, 8)
    # the port's own trajectories are the reference's
    mine = trajectories(2, 8)
    for a, b in zip(mine[0], traj[0]):
        for (Ra, ta), (Rb, tb) in zip(a, b):
            np.testing.assert_allclose(Ra, Rb, atol=1e-6)
            np.testing.assert_array_equal(ta, tb)
    ref = reference_visual_mission(2, 8, features, traj)
    got = run_visual_mission(2, 8, features=features, device="cpu")
    assert got["keyframe_poses"] == ref["keyframe_poses"]
    assert got["keyframes"] == 16
    assert set(got["ate"]) == set(ref["ate"]) == {0, 1}
    lcs_t = set(got["intra_loop_closures"]) | set(got["inter_loop_closures"])
    lcs_j = set(ref["intra_loop_closures"]) | set(ref["inter_loop_closures"])
    assert lcs_j and got["inter_loop_closures"]
    if features == "classical":
        assert lcs_t == lcs_j
        tol = 1e-4
    else:
        assert len(lcs_t & lcs_j) >= 0.8 * len(lcs_j)
        tol = 0.01
    for rid, (odo, opt) in ref["ate"].items():
        assert got["ate"][rid][0] == pytest.approx(odo, abs=1e-6)
        assert got["ate"][rid][1] == pytest.approx(opt, abs=tol)
        assert got["ate"][rid][1] < got["ate"][rid][0]
