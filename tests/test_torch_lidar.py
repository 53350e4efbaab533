"""Port parity, the lidar front-end: LidarHandler, ScanContextModel, the
lidar branches of MapManager, the detector and the sparse matcher, and
the lidar mission through SwarmNode, on cslam_tpu and cslam_tpu_torch
with the same seeded inputs, on the CPU, through the bus.

Tolerances:
- Keyframes (the voxelized clouds), their odometry messages, Scan
  Context embeddings: identical.
- Verification (the four scenarios of tests/test_lidar_handler.py and
  a registration of a structured pair): the same closures and success
  flags; poses within 1e-4 (the weighted Kabsch sums in another order;
  measured <= 2e-6); covariance diagonals relative 1e-3.
- Lidar mission (2 robots x 8 poses of the reference's world, and the
  reference bench's 3 x 12, marked slow): the same keyframes, the same
  intra- and inter-robot loop closures, ATE per robot within 1e-3 m
  (measured 5e-5 m on 2 x 8); the trajectories agree (positions
  exactly, rotations within 1e-6) and the scans within 1e-5 m.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from cslam_tpu.comm import bus as jbus
from cslam_tpu.comm import messages as jmsgs
from cslam_tpu.frontend import lidar_handler as jlh
from cslam_tpu.frontend import loop_closure_detection as jlcd
from cslam_tpu.frontend import map_manager as jmm
from cslam_tpu.matching import sparse_matching as jsm
from cslam_tpu_torch.comm import bus as tbus
from cslam_tpu_torch.comm import messages as tmsgs
from cslam_tpu_torch.frontend import lidar_handler as tlh
from cslam_tpu_torch.frontend import loop_closure_detection as tlcd
from cslam_tpu_torch.frontend import map_manager as tmm
from cslam_tpu_torch.matching import sparse_matching as tsm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_lidar_handler as tl  # noqa: E402
from test_fpfh import structured_cloud  # noqa: E402

torch.set_num_threads(1)

POSE_TOL = 1e-4
COV_RTOL = 1e-3
ATE_TOL = 1e-3

PACKAGES = {
    "jax": dict(bus=jbus, msgs=jmsgs, lh=jlh, mm=jmm, lcd=jlcd, sm=jsm,
                kw={}),
    "torch": dict(bus=tbus, msgs=tmsgs, lh=tlh, mm=tmm, lcd=tlcd, sm=tsm,
                  kw={"device": "cpu"}),
}


def assert_closure_close(got, ref):
    assert type(got).__name__ == type(ref).__name__
    for f in ("keyframe0_id", "keyframe1_id", "robot0_id",
              "robot0_keyframe_id", "robot1_id", "robot1_keyframe_id"):
        assert getattr(got, f, None) == getattr(ref, f, None)
    assert bool(got.success) == bool(ref.success)
    for a, b in zip(got.pose, ref.pose):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.covariance_diag, ref.covariance_diag,
                               rtol=COV_RTOL, atol=1e-12)


# -- the four scenarios of tests/test_lidar_handler.py ------------------------

def scenario(pkg, name):
    """Drive one scenario of tests/test_lidar_handler.py; returns what
    went over the bus: (keyframes, odometry, closures, descriptors)."""
    p = PACKAGES[pkg]
    bus, msgs, lh, kw = p["bus"], p["msgs"], p["lh"], p["kw"]
    router = bus.InProcessRouter()
    params = tl.make_params
    out = {"kf": [], "odom": [], "lc": [], "desc": []}

    def handler(rid, n_robots):
        b = bus.InProcessBus(router, rid)
        h = lh.LidarHandler(params(rid, n_robots), b, bus.ManualClock(),
                            **kw)
        b.subscribe("cslam/keyframe_data", out["kf"].append)
        b.subscribe("cslam/keyframe_odom", out["odom"].append)
        b.subscribe("cslam/intra_robot_loop_closure", out["lc"].append)
        b.subscribe("/cslam/local_descriptors", out["desc"].append)
        return h, b

    if name == "keyframe_gate":
        h, _ = handler(0, 1)
        world = tl.world_cloud(np.random.default_rng(0))
        for x in (0.0, 0.5, 1.6):
            pose = tl.make_pose(x)
            h.add_sensor_data(tl.observe(world, pose), pose)
            out.setdefault("returns", []).append(h.process_new_sensor_data())
    elif name == "intra":
        h, b = handler(0, 1)
        world = tl.world_cloud(np.random.default_rng(1))
        for pose in (tl.make_pose(0.0), tl.make_pose(1.5, 0.3, 0.25)):
            h.add_sensor_data(tl.observe(world, pose), pose)
            h.process_new_sensor_data()
        b.publish("cslam/local_keyframe_match",
                  msgs.LocalKeyframeMatch(keyframe0_id=0, keyframe1_id=1))
    elif name == "inter":
        router.subscribe("/cslam/inter_robot_loop_closure", out["lc"].append)
        h0, b0 = handler(0, 2)
        h1, _ = handler(1, 2)
        world = tl.world_cloud(np.random.default_rng(2))
        for h, pose in ((h0, tl.make_pose(0.0)),
                        (h1, tl.make_pose(1.0, -0.5, -0.2))):
            h.add_sensor_data(tl.observe(world, pose), pose)
            h.process_new_sensor_data()
        b0.publish("cslam/local_descriptors_request",
                   msgs.LocalDescriptorsRequest(
                       keyframe_id=0, matches_robot_id=[1],
                       matches_keyframe_id=[0]))
    elif name == "unknown_request":
        _, b = handler(0, 1)
        b.publish("cslam/local_descriptors_request",
                  msgs.LocalDescriptorsRequest(keyframe_id=99))
    router.spin_until_idle()
    return out


@pytest.mark.parametrize("name", ["keyframe_gate", "intra", "inter",
                                  "unknown_request"])
def test_lidar_handler_scenarios_match_reference(name):
    ref, got = scenario("jax", name), scenario("torch", name)
    assert got.get("returns") == ref.get("returns")
    assert [k.id for k in got["kf"]] == [k.id for k in ref["kf"]]
    for a, b in zip(got["kf"], ref["kf"]):
        np.testing.assert_array_equal(a.points, b.points)
    assert [o.to_bytes() for o in got["odom"]] == \
        [o.to_bytes() for o in ref["odom"]]
    assert [d.to_bytes() for d in got["desc"]] == \
        [d.to_bytes() for d in ref["desc"]]
    assert len(got["lc"]) == len(ref["lc"])
    for a, b in zip(got["lc"], ref["lc"]):
        assert_closure_close(a, b)
    if name in ("intra", "inter"):
        assert len(got["lc"]) == 1 and got["lc"][0].success
    if name == "inter":
        assert got["desc"]


def test_register_structured_pair_matches_reference():
    """_register on a pair with no pose prior worth the name (0.9 rad
    yaw, 2 m offset, a permuted and partly cropped copy): the same
    success flag and pose from both seeds' better fit."""
    rng = np.random.default_rng(4)
    pts = structured_cloud(rng, n=420) * 2.0
    R, t = tl.make_pose(2.0, -1.0, 0.9)
    dst = tl.observe(pts, (R, t))[rng.permutation(420)][:380]
    res = {}
    for pkg in PACKAGES:
        p = PACKAGES[pkg]
        h = p["lh"].LidarHandler(tl.make_params(), p["bus"].InProcessBus(
            p["bus"].InProcessRouter(), 0), p["bus"].ManualClock(),
            **p["kw"])
        res[pkg] = h._register(dst, pts)
    got, ref = res["torch"], res["jax"]
    assert bool(got.success) == bool(ref.success) is True
    for f in ("R", "t"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=POSE_TOL)
    np.testing.assert_allclose(np.asarray(got.R), R, atol=0.02)
    assert float(got.inlier_frac) == pytest.approx(float(ref.inlier_frac),
                                                   abs=1e-3)


# -- the lidar branches of the front-end --------------------------------------

def lidar_params(robot_id=0, n_robots=2):
    """The lidar mission's parameters with this file's keyframe gate and a
    looser match threshold for the small structured world."""
    from cslam_tpu_torch.lidar_mission import make_params
    return dict(make_params(robot_id, n_robots),
                **{"frontend.kf_distance_threshold": 1.0,
                   "frontend.similarity_threshold": 0.5,
                   "frontend.intra_loop_min_inbetween_keyframes": 2})


def test_lidar_branches_build_and_embed_like_the_reference():
    """make_sensor_handler(lidar) -> LidarHandler; the detector with
    scancontext builds the Scan Context model, whose embeddings equal
    the reference's; keyframes published on the bus reach the detector
    (receive_keyframe) and its Scan Context databases."""
    world = tl.world_cloud(np.random.default_rng(5))
    stored = {}
    for pkg, p in PACKAGES.items():
        router = p["bus"].InProcessRouter()
        b = p["bus"].InProcessBus(router, 0)
        clock = p["bus"].ManualClock()
        params = lidar_params()
        h = p["mm"].make_sensor_handler(params, b, clock, **p["kw"])
        assert type(h).__name__ == "LidarHandler"
        det = p["lcd"].GlobalDescriptorLoopClosureDetection(
            params, b, clock, **p["kw"])
        assert type(det.global_descriptor).__name__ == "ScanContextModel"
        assert type(det.lcm.local_nnsm).__name__ == "ScanContextMatching"
        for x in (0.0, 1.2, 2.4, 0.2):
            pose = tl.make_pose(x, 0.1 * x, 0.05 * x)
            h.add_sensor_data(tl.observe(world, pose), pose)
            h.process_new_sensor_data()
        router.spin_until_idle()
        stored[pkg] = (
            det.lcm.local_nnsm.nb_items,
            np.asarray(det.lcm.local_nnsm.data.cpu() if torch.is_tensor(
                det.lcm.local_nnsm.data) else det.lcm.local_nnsm.data),
            det.global_descriptor.compute_embedding(
                tl.observe(world, tl.make_pose(0.7))),
            sorted(det.global_descriptors_buffer))
    (n_t, data_t, emb_t, buf_t), (n_j, data_j, emb_j, buf_j) = \
        stored["torch"], stored["jax"]
    assert n_t == n_j == 4 and buf_t == buf_j == [0, 1, 2, 3]
    np.testing.assert_array_equal(data_t, data_j)
    np.testing.assert_array_equal(emb_t, emb_j)


def test_lidar_sparse_matching_matches_reference():
    """LoopClosureSparseMatching with sensor_type lidar: local and
    cross-robot Scan Context matches equal the reference's."""
    world = tl.world_cloud(np.random.default_rng(6))
    model = tlh.ScanContextModel(device="cpu")
    embs = [model.compute_embedding(tl.observe(world, tl.make_pose(
        0.4 * k, 0.2 * np.sin(k), 0.1 * k))) for k in range(6)]
    found = {}
    for pkg, p in PACKAGES.items():
        lcm = p["sm"].LoopClosureSparseMatching(lidar_params(0, 2),
                                                **p["kw"])
        out = []
        for k, e in enumerate(embs[:4]):
            out.append([(m.robot0_keyframe_id, m.robot1_keyframe_id,
                         round(m.weight, 6))
                        for m in lcm.add_local_global_descriptor(e, k)])
            out.append(lcm.match_local_loop_closures(e, k)[0])
        for k, e in enumerate(embs[4:]):
            msg = p["msgs"].GlobalDescriptor(keyframe_id=k, robot_id=1,
                                             descriptor=e)
            m = lcm.add_other_robot_global_descriptor(msg)
            out.append(None if m is None else (
                m.robot0_keyframe_id, m.robot1_keyframe_id,
                round(m.weight, 6)))
        found[pkg] = out
    assert found["torch"] == found["jax"]
    assert any(x is not None for x in found["torch"][-2:])


# -- the lidar mission on both packages ---------------------------------------

def _bench():
    """benchmarks/lidar_mission_bench.py as a module (its main() writes a
    result file, so the tests drive its steps)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "lidar_mission_bench.py")
    spec = importlib.util.spec_from_file_location("lidar_mission_bench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_lidar_mission(n_robots, n_poses):
    """benchmarks/lidar_mission_bench.py's mission on the reference: its
    world, trajectories, parameters and steps (4 detection rounds, the
    optimization of tests/test_e2e_swarm.py)."""
    lb = _bench()
    from cslam_tpu.backend import pgo
    from cslam_tpu.node import SwarmNode
    from cslam_tpu.utils.evaluation import ate_rmse
    from test_e2e_swarm import run_optimization

    world = lb.LidarWorld()
    router = jbus.InProcessRouter()
    clock = jbus.ManualClock()
    cfg = pgo.PGOConfig(lm_max_iters=15, cg_max_iters=80)
    nodes, handlers = {}, {}
    for rid in range(n_robots):
        b = jbus.InProcessBus(router, rid)
        params = lb.make_params(rid, n_robots)
        handlers[rid] = jlh.LidarHandler(params, b, clock)
        nodes[rid] = SwarmNode(params, b, clock,
                               descriptor_model=jlh.ScanContextModel(),
                               pgo_config=cfg)
    true, odom = lb.trajectories(n_robots, n_poses)
    rng = np.random.default_rng(3)
    kf_to_pose = {rid: {} for rid in range(n_robots)}
    scans = []
    try:
        for kf in range(n_poses):
            for rid in range(n_robots):
                scan = world.scan(true[rid][kf], rng)
                scans.append(scan)
                handlers[rid].add_sensor_data(
                    scan, (odom[rid][0][kf], odom[rid][1][kf]))
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
    finally:
        for node in nodes.values():
            node.backend._executor.shutdown(wait=True)
    intra = sorted((rid, f.key_from, f.key_to) for rid, n in nodes.items()
                   for f in n.backend.local_factors if f.is_loop)
    inter = sorted({(tuple(lc.key_from), tuple(lc.key_to))
                    for n in nodes.values()
                    for lcs in n.backend.inter_robot_loop_closures.values()
                    for lc in lcs})
    ate = {}
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
    return {"keyframe_poses": {r: sorted(m.values())
                               for r, m in kf_to_pose.items()},
            "intra_loop_closures": intra, "inter_loop_closures": inter,
            "ate": ate, "trajectories": (true, odom), "world": world,
            "scans": scans}


def check_lidar_mission(n_robots, n_poses):
    from cslam_tpu_torch.lidar_mission import DEFAULT_WORLD, SCAN_SEED, \
        LidarWorld, run_lidar_mission, trajectories
    ref = reference_lidar_mission(n_robots, n_poses)
    # the port's world, trajectories and scans are the reference's
    world = LidarWorld(*DEFAULT_WORLD)
    np.testing.assert_array_equal(world.points, ref["world"].points)
    (true, odom), (true_r, odom_r) = trajectories(n_robots, n_poses), \
        ref["trajectories"]
    for a, b in zip(true, true_r):
        for (Ra, ta), (Rb, tb) in zip(a, b):
            np.testing.assert_allclose(Ra, Rb, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(ta, tb)
    for a, b in zip(odom, odom_r):
        for xs, ys in zip(a, b):
            np.testing.assert_allclose(np.stack(xs), np.stack(ys), rtol=0,
                                       atol=1e-5)
    rng = np.random.default_rng(SCAN_SEED)
    scans = [world.scan(true[rid][kf], rng) for kf in range(n_poses)
             for rid in range(n_robots)]
    for a, b in zip(scans, ref["scans"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    got = run_lidar_mission(n_robots, n_poses, device="cpu")
    assert got["keyframe_poses"] == ref["keyframe_poses"]
    assert got["intra_loop_closures"] == ref["intra_loop_closures"]
    assert got["inter_loop_closures"] == ref["inter_loop_closures"]
    assert got["inter_loop_closures"]
    assert set(got["ate"]) == set(ref["ate"]) == set(range(n_robots))
    for rid, (odo, opt) in ref["ate"].items():
        assert got["ate"][rid][0] == pytest.approx(odo, abs=ATE_TOL)
        assert got["ate"][rid][1] == pytest.approx(opt, abs=ATE_TOL)
    return got


def test_small_lidar_mission_matches_reference():
    """2 robots x 8 poses of the reference bench's world through
    SwarmNode on both packages."""
    got = check_lidar_mission(2, 8)
    assert got["keyframes"] == 15 and got["verifications"] >= 7
    assert set(got["register_caps"]) == {2048}


@pytest.mark.slow
def test_bench_lidar_mission_matches_reference():
    """The reference bench's own size, 3 robots x 12 poses."""
    check_lidar_mission(3, 12)
