"""Port parity: checkpoint/resume (the counterpart of
tests/test_checkpoint.py) and checkpoints across the two packages.

A SwarmNode checkpointed by cslam_tpu_torch.utils.checkpoint restores
into a fresh port node with intact descriptor databases, candidate
bookkeeping, gossip watermarks and graph, and the restored node still
selects and optimizes; f32 and bf16 databases round-trip exactly. A
checkpoint written by either package loads in the other: same database
lengths, identical top-3 search results for the same query, identical
fixed edges, candidates and watermarks, and poses within POSE_TOL (both
store f32; the only arithmetic is the f32 round trip of npz).

All on the CPU, in-process, after the e2e pipeline of test_e2e_swarm.py
(2 robots x 16 keyframes, 2 detection rounds).
"""

import numpy as np
import pytest
import torch

from cslam_tpu.matching.descriptor_db import DescriptorDatabase as JaxDB
from cslam_tpu.utils import checkpoint as jckpt
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase as TDB
from cslam_tpu_torch.utils import checkpoint as tckpt

from test_e2e_swarm import make_params
from test_torch_mission import JAX, PORT, build_swarm, close, drive_pipeline

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

POSE_TOL = 1e-6
CKPT = {"jax": (JAX, jckpt), "port": (PORT, tckpt)}


def _mission(P):
    s = build_swarm(P, 2, 16, drift=0.01)
    drive_pipeline(s, detection_rounds=2)
    return s


def _fresh_node(P, robot_id=0, n_robots=2):
    router = P.bus.InProcessRouter()
    node = P.node.SwarmNode(make_params(robot_id, n_robots),
                            P.bus.InProcessBus(router, robot_id),
                            P.bus.ManualClock(), **P.kw)
    return router, node


def _search(node, query):
    items, sims = node.detection.lcm.local_nnsm.search(query, 3)
    return list(items), np.asarray(sims, dtype=np.float32)


def _assert_restored(src, dst, query):
    """dst (restored from src's checkpoint) holds src's state."""
    lcm_a, lcm_b = src.detection.lcm, dst.detection.lcm
    assert len(lcm_b.local_nnsm) == len(lcm_a.local_nnsm) > 0
    assert len(lcm_b.other_robots_nnsm[1]) == \
        len(lcm_a.other_robots_nnsm[1]) > 0
    items_a, sims_a = _search(src, query)
    items_b, sims_b = _search(dst, query)
    assert items_b == items_a
    np.testing.assert_allclose(sims_b, sims_a, atol=1e-5)

    sel_a, sel_b = lcm_a.candidate_selector, lcm_b.candidate_selector
    assert sel_a.fixed_edges and sel_a.candidate_edges
    assert set(sel_b.candidate_edges.keys()) == set(sel_a.candidate_edges)
    assert sel_b.already_considered_matches == sel_a.already_considered_matches
    assert [tuple(e) for e in sel_b.fixed_edges] == \
        [tuple(e) for e in sel_a.fixed_edges]
    assert sel_b.nb_poses == sel_a.nb_poses

    mons_a = src.detection.neighbor_manager.neighbors_monitors
    mons_b = dst.detection.neighbor_manager.neighbors_monitors
    for rid, mon in mons_a.items():
        for field in ("last_keyframe_sent", "last_keyframe_received",
                      "last_match_sent"):
            assert getattr(mons_b[rid], field) == getattr(mon, field)

    be_a, be_b = src.backend, dst.backend
    for store in ("odometry_pose_estimates", "current_pose_estimates"):
        a, b = getattr(be_a, store), getattr(be_b, store)
        assert set(b) == set(a)
        for key in a:
            np.testing.assert_allclose(b[key][0], a[key][0], atol=POSE_TOL)
            np.testing.assert_allclose(b[key][1], a[key][1], atol=POSE_TOL)
    assert len(be_b.local_factors) == len(be_a.local_factors) > 0
    assert sum(len(v) for v in be_b.inter_robot_loop_closures.values()) == \
        sum(len(v) for v in be_a.inter_robot_loop_closures.values())
    assert be_b.latest_local_key == be_a.latest_local_key


def test_checkpoint_roundtrip(tmp_path):
    s = _mission(PORT)
    router2, node2 = _fresh_node(PORT)
    try:
        folder = str(tmp_path / "ckpt")
        tckpt.save_node(s.nodes[0], folder)
        tckpt.load_node(node2, folder)
        _assert_restored(s.nodes[0], node2, s.world.descriptor(0, 3))

        # the restored node can still run a full selection + optimization
        selection = node2.detection.lcm.select_candidates(
            3, {0: True, 1: True})
        assert isinstance(selection, list)
        be = node2.backend
        be.current_neighbors = PORT.msgs.RobotIdsAndOrigin(ids=[],
                                                           origins=[])
        be.optimizer_state = type(be.optimizer_state).START_OPTIMIZATION
        be.start_optimization()
        if be._optimization_future is not None:
            be._optimization_future.result(timeout=120)
            be.check_result_and_finish_optimization()
        router2.spin_until_idle()
        assert be.optimization_count == 1
    finally:
        node2.close()
        close(s)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_descriptor_database_checkpoint_roundtrip(tmp_path, storage):
    """A database's rows round-trip exactly in its storage dtype; bf16
    is written as its f32 up-cast (npz has no bfloat16) and re-rounded
    by add_item on restore."""
    rng = np.random.default_rng(0)
    db = TDB(method="exact", storage=storage, device="cpu")
    for i in range(10):
        db.add_item(rng.standard_normal(32).astype(np.float32), i)
    path = str(tmp_path / "db.npz")
    tckpt._save_descriptor_db(db, path)
    with np.load(path) as blob:
        assert blob["data"].dtype == np.float32
    db2 = TDB(method="exact", storage=storage, device="cpu")
    tckpt._load_descriptor_db(db2, path)
    assert db2.data.dtype == db.data.dtype
    assert torch.equal(db2.data[:10], db.data[:10])
    assert db2.items == db.items
    # and the reference reads the same file into the same values
    jdb = JaxDB(method="exact", storage=storage)
    jckpt._load_descriptor_db(jdb, path)
    np.testing.assert_array_equal(
        np.asarray(jdb.data[:10], dtype=np.float32),
        db.data[:10].float().numpy())


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_loads_across_packages(tmp_path, writer, reader):
    (PW, ckpt_w), (PR, ckpt_r) = CKPT[writer], CKPT[reader]
    s = _mission(PW)
    _, node2 = _fresh_node(PR)
    try:
        folder = str(tmp_path / "ckpt")
        ckpt_w.save_node(s.nodes[0], folder)
        ckpt_r.load_node(node2, folder)
        _assert_restored(s.nodes[0], node2, s.world.descriptor(0, 3))
    finally:
        if hasattr(node2, "close"):
            node2.close()
        close(s)
