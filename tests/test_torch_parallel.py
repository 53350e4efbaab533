"""Port parity, multi-device layer: cslam_tpu_torch.parallel on a mesh of
8 gloo ranks on the CPU against cslam_tpu.parallel on the conftest's 8
virtual CPU devices, on the same seeded numpy inputs.

The counterparts of tests/test_parallel.py's six tests, with its shapes
and tolerances: sharded kNN indices equal and similarities within 1e-5
(at the reference's shapes and at every n_valid on a shard boundary);
the distributed solve against the single-device solve and against the
reference's distributed solve: GNC rounds equal, initial cost rtol
1e-5, cost rtol 1e-3 / atol 1e-8, weights atol 1e-2, translations atol
1e-3 (the all-reduce sums the edges in another order). Then what is the
port's own: every rank ends a solve with an uneven robot split on the
same GNC round count, data-parallel CosPlace against the reference's
batch-sharded forward, no child outlives close(), and a killed worker
makes the next call raise. The multi-device dry run (cslam_tpu_torch
.entry) is tests/test_torch_entry.py's.
"""

import multiprocessing
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec

from cslam_tpu.backend import pgo as jpgo
from cslam_tpu.models import cosplace as jcp
from cslam_tpu.ops import knn as jknn
from cslam_tpu.parallel import distributed_pgo as jdist
from cslam_tpu.parallel import make_swarm_mesh as jmake_mesh
from cslam_tpu.parallel.sharded_knn import \
    sharded_cosine_topk as jsharded_topk
from cslam_tpu_torch import interop
from cslam_tpu_torch.backend import pgo as tpgo
from cslam_tpu_torch.backend.factor_graph import (BetweenFactor,
                                                  FactorGraph,
                                                  diag_sqrt_info)
from cslam_tpu_torch.models import convert as tconvert
from cslam_tpu_torch.models import cosplace as tcp
from cslam_tpu_torch.ops import knn as tknn
from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
from cslam_tpu_torch.parallel import distributed_pgo as tdist
from cslam_tpu_torch.parallel import make_swarm_mesh
from cslam_tpu_torch.parallel.sharded_knn import \
    kernel_slots_to_reference, sharded_cosine_topk
from test_pgo import ate_rmse, build_graph

# one intra-op thread per rank: the suite runs several pytest workers
# side by side, and every rank of a mesh is a process
torch.set_num_threads(1)

N_RANKS = 8


class _Meshes:
    """The module's one open port mesh (torch.distributed allows one
    group per process): reused while the size matches."""

    def __init__(self):
        self.open = None

    def get(self, n):
        if self.open is None or self.open.size != n:
            self.close()
            self.open = make_swarm_mesh(n, device="cpu")
        return self.open

    def close(self):
        if self.open is not None:
            self.open.close()
            self.open = None


@pytest.fixture(scope="module")
def meshes():
    m = _Meshes()
    yield m
    m.close()


@pytest.fixture
def mesh(meshes):
    return meshes.get(N_RANKS)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N_RANKS, "conftest must provide 8 devices"
    return jmake_mesh(N_RANKS)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# Sharded kNN
# ----------------------------------------------------------------------

def test_sharded_knn_matches_single_chip(mesh, jmesh):
    rng = np.random.default_rng(0)
    N, D, B, k = 1024, 64, 7, 5
    data = rng.standard_normal((N, D)).astype(np.float32)
    n_valid = 777
    data[n_valid:] = 0.0
    queries = rng.standard_normal((B, D)).astype(np.float32)

    ref_idx, ref_sims = jknn.cosine_topk(jnp.asarray(data), n_valid,
                                         jnp.asarray(queries), k)
    jidx, jsims = jsharded_topk(jmesh, jnp.asarray(data), n_valid,
                                jnp.asarray(queries), k)
    idx, sims = sharded_cosine_topk(mesh, _t(data), n_valid, _t(queries), k)
    for ri, rs in ((ref_idx, ref_sims), (jidx, jsims)):
        np.testing.assert_allclose(_np(sims), np.asarray(rs), atol=1e-5)
        np.testing.assert_array_equal(_np(idx), np.asarray(ri))
    # placed once, searched twice: the same answer without re-sending
    placed = mesh.place_rows(_t(data))
    for _ in range(2):
        idx2, sims2 = sharded_cosine_topk(mesh, placed, n_valid,
                                          _t(queries), k)
        np.testing.assert_array_equal(_np(idx2), _np(idx))
        np.testing.assert_array_equal(_np(sims2), _np(sims))
    placed.free()


def test_sharded_knn_n_valid_at_shard_boundaries(mesh, jmesh):
    """Shards with no valid row; the missing slots (n_valid < k) follow
    the reference exactly: -inf at the rows the reference returns."""
    rng = np.random.default_rng(1)
    N, D = 256, 16
    data = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((1, D)).astype(np.float32)
    placed = mesh.place_rows(_t(data))
    for n_valid in [1, 32, 33, 128, 255, 256]:
        ref_idx, ref_sims = jknn.cosine_topk(jnp.asarray(data), n_valid,
                                             jnp.asarray(q), 3)
        jidx, jsims = jsharded_topk(jmesh, jnp.asarray(data), n_valid,
                                    jnp.asarray(q), 3)
        idx, sims = sharded_cosine_topk(mesh, placed, n_valid, _t(q), 3)
        np.testing.assert_allclose(_np(sims), np.asarray(ref_sims),
                                   atol=1e-5, err_msg=f"n_valid={n_valid}")
        np.testing.assert_allclose(_np(sims), np.asarray(jsims), atol=1e-5,
                                   err_msg=f"n_valid={n_valid}")
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx),
                                      err_msg=f"n_valid={n_valid}")
    placed.free()


@pytest.mark.parametrize("local_valid", [0, 1, 3, 6, 40])
def test_kernel_missing_slots_map_to_the_reference_convention(local_valid):
    """A shard's search on the card goes through the kernel, whose
    missing slots hold -3e38 with row 0; after the rewrite they equal the
    exact path's (-inf, row = slot), so no shard's missing slot can win
    the merge. Held here with the kernel's plain version."""
    rng = np.random.default_rng(5)
    data = _t(rng.standard_normal((64, 24)).astype(np.float32))
    q = _t(rng.standard_normal((3, 24)).astype(np.float32))
    k = 6
    idx, sims = kernel_slots_to_reference(
        *cosine_topk_pallas(data, local_valid, q, k), local_valid)
    ref_idx, ref_sims = tknn.cosine_topk(data, local_valid, q, k)
    np.testing.assert_array_equal(_np(idx), _np(ref_idx))
    np.testing.assert_allclose(_np(sims), _np(ref_sims), atol=1e-6)


# ----------------------------------------------------------------------
# Distributed PGO
# ----------------------------------------------------------------------

def _assert_parity(res, ref):
    """tests/test_parallel.py's iteration-parity tolerances."""
    assert int(res.gnc_iters) == int(ref.gnc_iters)
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-3,
                               atol=1e-8)
    np.testing.assert_allclose(_np(res.weights), _np(ref.weights),
                               atol=1e-2)
    np.testing.assert_allclose(_np(res.t), _np(ref.t), atol=1e-3)


def test_distributed_pgo_matches_single_chip(mesh, jmesh):
    rng = np.random.default_rng(2)
    fg, Rs, ts = build_graph(rng, n=25, loops=((0, 12), (3, 20)),
                             outliers=((2, 22),), init_noise=0.05)
    cfg = jpgo.PGOConfig(lm_max_iters=15, cg_max_iters=100)
    tcfg = interop.pgo_config_from_dict(cfg)
    tfg = interop.factor_graph_from(fg)
    tfg_single = interop.factor_graph_from(fg)

    res_single = tpgo.optimize(tfg_single, tcfg, device="cpu")
    ate_single = ate_rmse(tfg_single, Rs, ts)
    res_dist = tdist.optimize(mesh, tfg, tcfg)
    ate_dist = ate_rmse(tfg, Rs, ts)
    jres = jdist.optimize(jmesh, fg, cfg)

    assert np.isfinite(float(res_dist.cost))
    # both recover the trajectory and reject the outlier
    assert ate_dist < 0.05
    assert abs(ate_dist - ate_single) < 0.02
    g = tfg.to_arrays(device="cpu")
    loop_idx = np.nonzero(_np(g.is_loop))[0]
    w = _np(res_dist.weights)
    assert w[loop_idx[-1]] < 0.1  # outlier rejected
    assert abs(ate_dist - ate_rmse(fg, Rs, ts)) < 1e-3
    _assert_parity(res_dist, jres)


def test_distributed_pgo_iteration_parity(mesh, jmesh):
    """The distributed solve runs the SAME core as the single-device
    solver, so on identical graph arrays the GNC round count, final cost
    and converged weights match; and they match the reference's
    distributed solve on the same arrays."""
    rng = np.random.default_rng(7)
    fg, _, _ = build_graph(rng, n=30, loops=((0, 15), (5, 25)),
                           outliers=((2, 27),), init_noise=0.05)
    cfg = jpgo.PGOConfig(linear_solver="pcg")  # pin both paths to PCG
    g = fg.to_arrays(edge_bucket_multiple=8, sort_by_robot=True)
    gt = interop.graph_arrays_from(g, device="cpu")
    tcfg = interop.pgo_config_from_dict(cfg)

    res_single = tpgo.gnc_optimize(gt, tcfg)
    res_dist = tdist.distributed_gnc_optimize(mesh, gt, tcfg)
    _assert_parity(res_dist, res_single)
    _assert_parity(res_dist, jdist.distributed_gnc_optimize(jmesh, g, cfg))


def test_distributed_pgo_warm_start_and_chordal(mesh, jmesh):
    """Chordal init + the distributed path compose (init runs on the
    full edge set before sharding), and a second solve warm-started
    from the first's estimates converges at least as fast."""
    rng = np.random.default_rng(11)
    fg, Rs, ts = build_graph(rng, n=24, loops=((0, 12),), outliers=(),
                             init_noise=0.3)
    tfg = interop.factor_graph_from(fg)
    cfg = jpgo.PGOConfig(linear_solver="pcg", use_chordal_init=True)
    res = tdist.optimize(mesh, tfg, interop.pgo_config_from_dict(cfg))
    assert np.isfinite(float(res.cost))
    assert ate_rmse(tfg, Rs, ts) < 0.05
    jres = jdist.optimize(jmesh, fg, cfg)
    np.testing.assert_allclose(_np(res.t), np.asarray(jres.t), atol=1e-3)
    # warm start: estimates written back by the first solve seed the
    # second; it must converge in <= the cold solve's GNC rounds
    cfg2 = jpgo.PGOConfig(linear_solver="pcg")
    res2 = tdist.optimize(mesh, tfg, interop.pgo_config_from_dict(cfg2))
    assert int(res2.gnc_iters) <= int(res.gnc_iters)
    assert float(res2.cost) <= float(res.cost) * 1.5
    jres2 = jdist.optimize(jmesh, fg, cfg2)
    assert int(res2.gnc_iters) == int(jres2.gnc_iters)


def test_sorted_factor_blocks_map_robots_to_shards():
    """sort_by_robot places each robot's factors contiguously (as the
    reference does) so the equal-split sharding aligns robots with
    shards."""
    from cslam_tpu.backend.factor_graph import FactorGraph as JFG
    from cslam_tpu.backend.factor_graph import BetweenFactor as JBF

    sq = diag_sqrt_info([0.01] * 6)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    fg, jfg = FactorGraph(), JFG()
    # interleave insertion across robots 1, 0, 2
    for rid in (1, 0, 2, 1, 0, 2):
        kf = fg.num_factors  # unique ids
        fg.add_between(BetweenFactor((rid, kf), (rid, kf + 100), eye, zero,
                                     sq))
        jfg.add_between(JBF((rid, kf), (rid, kf + 100), eye, zero, sq))
    g = fg.to_arrays(sort_by_robot=True, device="cpu")
    jg = jfg.to_arrays(sort_by_robot=True)
    idx_to_robot = {v: k[0] for k, v in fg.key_to_index.items()}
    owners = [idx_to_robot[int(i)] for i, m in
              zip(_np(g.e_i), _np(g.edge_mask)) if m > 0]
    assert owners == sorted(owners), owners
    np.testing.assert_array_equal(_np(g.e_i), np.asarray(jg.e_i))
    # unsorted keeps insertion order
    g2 = fg.to_arrays(device="cpu")
    owners2 = [idx_to_robot[int(i)] for i, m in
               zip(_np(g2.e_i), _np(g2.edge_mask)) if m > 0]
    assert owners2 == [1, 0, 2, 1, 0, 2]
    # 4 robots x 4 factors over 4 shards: shard r holds robot r's block
    fg4 = FactorGraph()
    for k in range(4):
        for rid in (3, 1, 0, 2):
            fg4.add_between(BetweenFactor((rid, k), (rid, k + 1), eye, zero,
                                          sq))
    g4 = fg4.to_arrays(edge_bucket_multiple=4, sort_by_robot=True,
                       device="cpu")
    idx_to_robot = {v: key[0] for key, v in fg4.key_to_index.items()}
    shards = [[idx_to_robot[int(i)] for i in blk]
              for blk in _np(g4.e_i).reshape(4, -1)]
    assert shards == [[r] * 4 for r in range(4)], shards


def _uneven_swarm_graph(rng, sizes=(5, 23, 11), outlier=True):
    """Robots with `sizes` poses each: noisy odometry chains, three
    inter-robot loops (one a gross outlier), perturbed initial
    estimates, the prior on robot 0's first pose."""
    fg = FactorGraph()
    sq = diag_sqrt_info([0.01] * 3 + [0.05] * 3)
    truth = {}
    for rid, n in enumerate(sizes):
        t = np.cumsum(rng.standard_normal((n, 3)).astype(np.float32) * 0.5,
                      axis=0) + np.float32(3 * rid)
        truth[rid] = t.astype(np.float32)
        for k in range(n):
            fg.add_node((rid, k), np.eye(3, dtype=np.float32),
                        (t[k] + rng.standard_normal(3) * 0.05).astype(
                            np.float32))
        for k in range(n - 1):
            fg.add_between(BetweenFactor((rid, k), (rid, k + 1),
                                         np.eye(3, dtype=np.float32),
                                         t[k + 1] - t[k], sq))
    loops = [((0, 2), (1, 7)), ((1, 20), (2, 4)), ((0, 4), (2, 9))]
    for i, (a, b) in enumerate(loops):
        rel = truth[b[0]][b[1]] - truth[a[0]][a[1]]
        if outlier and i == 2:
            rel = rel + np.float32(9.0)
        fg.add_between(BetweenFactor(a, b, np.eye(3, dtype=np.float32),
                                     rel.astype(np.float32), sq,
                                     is_loop=True))
    fg.set_prior((0, 0), np.eye(3, dtype=np.float32), truth[0][0])
    return fg


def test_uneven_robot_split_ends_on_every_rank_alike(mesh):
    """Robots of 4, 22 and 10 factors over 8 shards: shards hold
    different numbers of live factors, yet every host decision of the
    core reads a reduced or replicated value, so every rank ends on the
    same GNC round count, cost and poses as rank 0, and as the
    single-device solve."""
    fg = _uneven_swarm_graph(np.random.default_rng(3))
    g = fg.to_arrays(edge_bucket_multiple=N_RANKS, sort_by_robot=True,
                     device="cpu")
    live = _np(g.edge_mask).reshape(N_RANKS, -1).sum(1)
    assert len(set(live.tolist())) > 1, live  # uneven by construction
    cfg = tpgo.PGOConfig(linear_solver="pcg")
    res, summaries = tdist._solve_on_mesh(mesh, g, cfg, "shard")
    assert [s["rank"] for s in summaries] == list(range(N_RANKS))
    assert len({s["gnc_iters"] for s in summaries}) == 1
    assert len({(s["cost"], s["t_sum"]) for s in summaries}) == 1
    assert res.gnc_iters > 0  # the outlier takes GNC rounds
    _assert_parity(res, tpgo.gnc_optimize(g, cfg))
    w = _np(res.weights)
    assert w[_np(g.is_loop) > 0].min() < 0.1  # the 9 m outlier rejected


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_data_parallel_cosplace_matches_reference(mesh, jmesh, dtype):
    """Stage 1 of the multi-device dry run: the reference's model.init
    weights, converted, broadcast once, the batch split over the 8
    ranks. The split changes no arithmetic: the outputs equal the
    one-process forward of the same weights (1e-6). In f32 they also
    equal the reference's batch-sharded forward (1e-5, as
    tests/test_torch_models.py). bf16 convs are held against the
    reference there, with the shipped weights (2e-3); with these random
    weights and 1x1 final feature maps, 8 of 1024 outputs differ by up
    to 2.6e-3 from rounding flips, whatever the split."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    jm = jcp.GeoLocalizationNet(fc_output_dim=64, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(jax.device_get(variables), sep="/").items()}
    model = tcp.load_flat_weights(tcp.GeoLocalizationNet(64, dtype=dtype),
                                  tconvert.cosplace_state_dict(flat)).eval()
    handle = mesh.replicate_module(model, tcp.GeoLocalizationNet, 64,
                                   dtype=dtype)
    out = _np(mesh.data_parallel(handle, _t(images)))
    mesh.free(handle)
    with torch.no_grad():
        single = _np(model(_t(images)))
    np.testing.assert_allclose(out, single, rtol=0, atol=1e-6)
    if dtype == torch.float32:
        ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jax.device_put(
                jnp.asarray(images),
                NamedSharding(jmesh, PartitionSpec("shard"))))
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Lifecycle
# ----------------------------------------------------------------------

def _pid_gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_close_leaves_no_child(meshes):
    meshes.close()
    with make_swarm_mesh(3, device="cpu") as mesh:
        pids = [w.proc.pid for w in mesh._workers]
        assert mesh.children_alive() == 2
        data = torch.randn(12, 8, generator=torch.Generator().manual_seed(0))
        idx, _ = sharded_cosine_topk(mesh, data, 12, data[:2], 1)
        assert _np(idx)[:, 0].tolist() == [0, 1]
    assert mesh.children_alive() == 0
    assert all(_pid_gone(p) for p in pids)
    assert not multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="closed"):
        sharded_cosine_topk(mesh, data, 12, data[:2], 1)


def test_killed_worker_makes_the_next_call_raise(meshes):
    meshes.close()
    data = torch.randn(12, 8, generator=torch.Generator().manual_seed(1))
    with make_swarm_mesh(3, device="cpu") as mesh:
        victim = mesh._workers[1].proc
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exited with code -9"):
            sharded_cosine_topk(mesh, data, 12, data[:2], 1)
        assert time.monotonic() - t0 < mesh.timeout_s
        with pytest.raises(RuntimeError, match="failed earlier"):
            sharded_cosine_topk(mesh, data, 12, data[:2], 1)
    assert mesh.children_alive() == 0
    assert not multiprocessing.active_children()
