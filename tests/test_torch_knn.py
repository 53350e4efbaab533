"""Port parity, descriptor search: cslam_tpu_torch against cslam_tpu on
the same seeded numpy inputs, on the CPU.

The kernel's plain version (`cosine_topk_plain`, what the port's
`cosine_topk_pallas` runs on a CPU tensor) is held against the Pallas
kernel run in interpret mode and against the XLA exact path, on the
cases of test_knn_pallas.py. Tolerances: f32 similarities 1e-5 (only
the summation order differs); bf16 5e-3 with >= 0.9 index agreement
(the reference's own bf16 bound between its two lowerings).
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.matching.descriptor_db import \
    DescriptorDatabase as JaxDescriptorDatabase
from cslam_tpu.matching.sparse_matching import \
    LoopClosureSparseMatching as JaxLCSM
from cslam_tpu.ops import knn as jknn
from cslam_tpu_torch.matching.descriptor_db import DescriptorDatabase
from cslam_tpu_torch.matching.sparse_matching import LoopClosureSparseMatching
from cslam_tpu_torch.ops import knn as tknn
from cslam_tpu_torch.ops import knn_pallas as tkp
from test_knn_pallas import _pallas_interpret

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

F32_TOL = 1e-5
GlobalDescriptor = namedtuple("GlobalDescriptor",
                              ["keyframe_id", "robot_id", "descriptor"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_pallas(data, n_valid, queries, k, dtype=torch.float32):
    idx, sims = tkp.cosine_topk_pallas(_t(data).to(dtype), n_valid,
                                       _t(queries), k)
    return idx.numpy(), sims.numpy()


def _assert_same_topk(idx_a, sims_a, idx_b, sims_b, k_eff, atol):
    np.testing.assert_allclose(sims_a[:, :k_eff], sims_b[:, :k_eff],
                               atol=atol)
    for b in range(sims_a.shape[0]):
        for j in range(k_eff):
            if j + 1 < k_eff and abs(sims_b[b, j] - sims_b[b, j + 1]) < 1e-6:
                continue
            assert idx_a[b, j] == idx_b[b, j], (b, j)


@pytest.mark.parametrize("n_valid", [1, 100, 256, 500, 512])
def test_plain_matches_pallas_interpret(n_valid):
    rng = np.random.default_rng(0)
    N, D, B, k = 512, 128, 8, 5
    data = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    ref_idx, ref_sims = _pallas_interpret(jnp.asarray(data), n_valid,
                                          jnp.asarray(queries), k,
                                          tile_rows=128)
    idx, sims = _port_pallas(data, n_valid, queries, k)
    # every slot, missing ones included (-3e38 with index 0)
    _assert_same_topk(idx, sims, np.asarray(ref_idx), np.asarray(ref_sims),
                      k, F32_TOL)
    xla_idx, xla_sims = jknn.cosine_topk(jnp.asarray(data), n_valid,
                                         jnp.asarray(queries), k)
    k_eff = min(k, n_valid)
    _assert_same_topk(idx, sims, np.asarray(xla_idx), np.asarray(xla_sims),
                      k_eff, F32_TOL)


def test_plain_multiple_tiles_finds_source_rows():
    rng = np.random.default_rng(1)
    N, D, B, k = 1024, 128, 4, 10
    data = rng.standard_normal((N, D)).astype(np.float32)
    queries = data[[3, 77, 500, 1000]] + \
        rng.standard_normal((4, D)).astype(np.float32) * 0.01
    ref_idx, ref_sims = _pallas_interpret(jnp.asarray(data), N,
                                          jnp.asarray(queries), k,
                                          tile_rows=256)
    idx, sims = _port_pallas(data, N, queries, k)
    np.testing.assert_array_equal(idx[:, 0], [3, 77, 500, 1000])
    _assert_same_topk(idx, sims, np.asarray(ref_idx), np.asarray(ref_sims),
                      k, F32_TOL)


def test_plain_bf16_matches_reference_bf16():
    rng = np.random.default_rng(3)
    N, D, B, k = 512, 128, 8, 5
    data = jnp.asarray(rng.standard_normal((N, D)), dtype=jnp.bfloat16)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    ref_idx, ref_sims = _pallas_interpret(data, N, jnp.asarray(queries), k,
                                          tile_rows=128)
    idx, sims = _port_pallas(np.asarray(data.astype(jnp.float32)), N,
                             queries, k, dtype=torch.bfloat16)
    np.testing.assert_allclose(sims, np.asarray(ref_sims), atol=5e-3)
    assert np.mean(idx == np.asarray(ref_idx)) >= 0.9
    xla_idx, xla_sims = jknn.cosine_topk(data, N, jnp.asarray(queries), k)
    np.testing.assert_allclose(sims, np.asarray(xla_sims), atol=5e-3)
    assert np.mean(idx == np.asarray(xla_idx)) >= 0.9


@pytest.mark.parametrize("query_groups", [2, 4])
def test_plain_matches_query_groups(query_groups):
    rng = np.random.default_rng(3)
    N, D, B, k = 1024, 128, 8, 5
    data = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    ref_idx, ref_sims = _pallas_interpret(jnp.asarray(data), N,
                                          jnp.asarray(queries), k,
                                          tile_rows=256,
                                          query_groups=query_groups)
    idx, sims = tkp.cosine_topk_pallas(_t(data), N, _t(queries), k,
                                       tile_rows=256,
                                       query_groups=query_groups)
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_wrapper_checks_like_the_reference():
    data = torch.zeros((1000, 8))
    with pytest.raises(ValueError):
        tkp.cosine_topk_pallas(data, 10, torch.ones((2, 8)), 1, tile_rows=256)
    with pytest.raises(ValueError):
        tkp.cosine_topk_pallas(data, 10, torch.ones((3, 8)), 1,
                               query_groups=2)


def test_plain_ties_keep_lower_row_and_pad_missing():
    data = np.ones((16, 4), np.float32)  # every row ties
    idx, sims = _port_pallas(data, 6, np.ones((1, 4), np.float32), 8)
    np.testing.assert_array_equal(idx[0], [0, 1, 2, 3, 4, 5, 0, 0])
    np.testing.assert_allclose(sims[0, :6], 1.0, atol=1e-6)
    assert np.all(sims[0, 6:] == np.float32(tkp.NEG_LARGE))


def _plain_in_passes(data, n_valid, queries, k):
    """The kernel's k > KMAX composition, driven on the CPU: passes of
    at most KMAX by the after-gated plain version."""
    data, queries = _t(data), _t(queries)
    inv, bias, q_n = tkp.prepare_inputs(data, n_valid, queries)

    def one_pass(dst_i, dst_v, after):
        i, v = tkp.cosine_topk_plain(data, n_valid, q_n, inv, bias,
                                     dst_i.shape[1], after=after)
        dst_i.copy_(i)
        dst_v.copy_(v)

    idx, sims = tkp.topk_in_passes(one_pass, queries.shape[0], k, "cpu")
    return idx.numpy(), sims.numpy()


@pytest.mark.parametrize("n_valid,k", [(300, 65), (300, 130), (100, 130),
                                       (64, 65)])
def test_passes_compose_to_the_plain_top_k(n_valid, k):
    """k > KMAX as the card serves it (ceil(k / 64) after-gated passes)
    equals the one-pass plain top-k exactly, k > n_valid included."""
    rng = np.random.default_rng(20)
    data = rng.standard_normal((384, 24)).astype(np.float32)
    queries = rng.standard_normal((4, 24)).astype(np.float32)
    idx, sims = _plain_in_passes(data, n_valid, queries, k)
    ref_idx, ref_sims = _port_pallas(data, n_valid, queries, k)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(sims, ref_sims)
    n_eff = min(k, n_valid)
    assert np.all(sims[:, n_eff:] == np.float32(tkp.NEG_LARGE))
    assert np.all(idx[:, n_eff:] == 0)


def test_passes_match_reference_pallas_above_kmax():
    """The reference serves k = 80 (its Pallas kernel in interpret mode);
    the port's one-pass plain version and its two-pass composition give
    the same top-80."""
    rng = np.random.default_rng(21)
    N, n_valid, D, B, k = 256, 200, 32, 3, 80
    data = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    ref_idx, ref_sims = _pallas_interpret(jnp.asarray(data), n_valid,
                                          jnp.asarray(queries), k,
                                          tile_rows=128)
    ref_idx, ref_sims = np.asarray(ref_idx), np.asarray(ref_sims)
    for idx, sims in (_port_pallas(data, n_valid, queries, k),
                      _plain_in_passes(data, n_valid, queries, k)):
        _assert_same_topk(idx, sims, ref_idx, ref_sims, k, F32_TOL)


def test_passes_keep_the_lower_row_across_a_pass_boundary():
    """100 tied rows: the first pass ends on row 63 and the second starts
    at row 64, lower rows first, then the missing slots."""
    data = np.ones((128, 4), np.float32)
    data[100:] = -1.0  # below the tie
    idx, sims = _plain_in_passes(data, 110, np.ones((2, 4), np.float32),
                                 120)
    np.testing.assert_array_equal(idx[:, :110],
                                  np.tile(np.arange(110), (2, 1)))
    np.testing.assert_allclose(sims[:, :100], 1.0, atol=1e-6)
    np.testing.assert_allclose(sims[:, 100:110], -1.0, atol=1e-6)
    assert np.all(sims[:, 110:] == np.float32(tkp.NEG_LARGE))
    assert np.all(idx[:, 110:] == 0)


@pytest.mark.parametrize("n_valid", [1, 900, 2048])
def test_xla_paths_match_reference(n_valid):
    """cosine_topk / _blocked / _streamed / _approx against the
    reference's exact XLA path: same indices, sims within 1e-5."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2048, 64)).astype(np.float32)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    ref_i, ref_s = jknn.cosine_topk(jnp.asarray(data), n_valid,
                                    jnp.asarray(q), 10)
    k_eff = min(10, n_valid)
    for fn, kw in ((tknn.cosine_topk, {}),
                   (tknn.cosine_topk_blocked, {"block": 512}),
                   (tknn.cosine_topk_streamed, {"block": 256}),
                   (tknn.cosine_topk_approx, {})):
        i, s = fn(_t(data), n_valid, _t(q), 10, **kw)
        _assert_same_topk(i.numpy(), s.numpy(), np.asarray(ref_i),
                          np.asarray(ref_s), k_eff, F32_TOL)
        assert np.all(np.isneginf(s.numpy()[:, k_eff:]))


def test_cross_similarity_matches_reference():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    ref = np.asarray(jknn.cross_similarity(jnp.asarray(a), 20,
                                           jnp.asarray(b), 50))
    got = tknn.cross_similarity(_t(a), 20, _t(b), 50).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


def _unit(rng, d):
    v = rng.random(d)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("method,storage", [("exact", "float32"),
                                            ("pallas", "float32"),
                                            ("approx", "float32"),
                                            ("pallas", "bfloat16"),
                                            ("exact", "bfloat16")])
def test_descriptor_database_matches_reference(method, storage):
    """Same adds (with capacity growth) and searches: same items,
    similarities within 1e-5 — the reference's exact search is the
    yardstick for every port method; bf16 storage against bf16. The
    kernel path normalizes bf16 queries before the cast (as the
    reference's Pallas wrapper does) and the exact path after, so
    there the bound is the reference's own 5e-3 between the two."""
    tol = 5e-3 if (method, storage) == ("pallas", "bfloat16") else F32_TOL
    rng = np.random.default_rng(4)
    ref = JaxDescriptorDatabase(dim=8, capacity=4, method="exact",
                                storage=storage)
    db = DescriptorDatabase(dim=8, capacity=4, method=method,
                            storage=storage, device="cpu")
    for i in range(20):
        v = _unit(rng, 8)
        ref.add_item(v, i)
        db.add_item(v, i)
    assert len(db) == 20 and db._capacity == ref._capacity == 32
    np.testing.assert_allclose(db._norms.numpy(), np.asarray(ref._norms),
                               atol=1e-6)
    for _ in range(5):
        q = _unit(rng, 8)
        items_r, sims_r = ref.search(q, 5)
        items, sims = db.search(q, 5)
        assert items == items_r
        np.testing.assert_allclose(sims, sims_r, atol=tol)
        assert db.search_best(q)[0] == ref.search_best(q)[0]
    qs = np.stack([_unit(rng, 8) for _ in range(3)])
    items_r, sims_r = ref.batch_search(qs, 30)
    items, sims = db.batch_search(qs, 30)
    assert items == items_r and sims.shape == (3, 20)
    np.testing.assert_allclose(sims, sims_r, atol=tol)


def test_descriptor_database_empty_and_auto():
    db = DescriptorDatabase(device="cpu")
    assert db.method == "exact"  # "auto" on the CPU
    items, sims = db.search(np.ones(4), 5)
    assert items == [] and len(sims) == 0
    assert db.search_best(np.ones(4)) == (None, None)
    with pytest.raises(ValueError):
        DescriptorDatabase(method="nope", device="cpu")


def _set_params(**over):
    params = {
        "robot_id": 0,
        "max_nb_robots": 2,
        "frontend.sensor_type": "stereo",
        "frontend.similarity_threshold": 0.0,
        "frontend.enable_sparsification": True,
        "frontend.nb_best_matches": 10,
        "frontend.intra_loop_min_inbetween_keyframes": 10,
        "evaluation.enable_sparsification_comparison": False,
    }
    params.update(over)
    return params


@pytest.mark.parametrize("max_nb_robots,robot_id,other_ids,method", [
    (3, 0, (1, 2), "pallas"),
    (4, 0, (2, 3), "exact"),
    (4, 1, (2, 3), "pallas"),
])
def test_sparse_matching_matches_reference(max_nb_robots, robot_id,
                                           other_ids, method):
    """test_sparse_matching.py's budget case through both packages: the
    same matches on every add, the same candidates, the same two rounds
    of selection."""
    rng = np.random.default_rng(6)
    params = _set_params(max_nb_robots=max_nb_robots, robot_id=robot_id)
    ref = JaxLCSM(dict(params, **{"frontend.nns_method": "exact"}))
    port = LoopClosureSparseMatching(
        dict(params, **{"frontend.nns_method": method}), device="cpu")
    for i in range(60):
        d = _unit(rng, 10)
        m_r = ref.add_local_global_descriptor(d, i)
        m_p = port.add_local_global_descriptor(d, i)
        assert [tuple(m)[:4] for m in m_p] == [tuple(m)[:4] for m in m_r]
    for rid in other_ids:
        for i in range(60):
            msg = GlobalDescriptor(i, rid, _unit(rng, 10).tolist())
            m_r = ref.add_other_robot_global_descriptor(msg)
            m_p = port.add_other_robot_global_descriptor(msg)
            assert (m_p is None) == (m_r is None)
            if m_r is not None:
                assert tuple(m_p)[:4] == tuple(m_r)[:4]
                assert abs(m_p.weight - m_r.weight) < F32_TOL
    assert set(port.candidate_selector.candidate_edges) == \
        set(ref.candidate_selector.candidate_edges)
    considered = {i: True for i in range(max_nb_robots)}
    for _ in range(2):
        sel_r = ref.select_candidates(20, considered)
        sel_p = port.select_candidates(20, considered)
        assert len(sel_p) == 20
        assert sorted(tuple(e)[:4] for e in sel_p) == \
            sorted(tuple(e)[:4] for e in sel_r)


def test_match_local_loop_closures_matches_reference():
    rng = np.random.default_rng(7)
    params = _set_params(**{
        "frontend.similarity_threshold": 0.5,
        "frontend.intra_loop_min_inbetween_keyframes": 5,
    })
    ref = JaxLCSM(params)
    port = LoopClosureSparseMatching(params, device="cpu")
    base = _unit(rng, 16)
    for lcsm in (ref, port):
        lcsm.add_local_global_descriptor(base, 0)
        lcsm.add_local_global_descriptor(base, 3)
    for kf in range(1, 30):
        d = np.clip(base + rng.standard_normal(16) * 0.3, 0, None)
        for lcsm in (ref, port):
            lcsm.add_local_global_descriptor(d, kf + 3)
        q = _unit(rng, 16)
        kf_r, sims_r = ref.match_local_loop_closures(q, kf + 3)
        kf_p, sims_p = port.match_local_loop_closures(q, kf + 3)
        assert kf_p == kf_r
        np.testing.assert_allclose(sims_p, sims_r, atol=F32_TOL)


def test_lidar_branch_not_ported():
    """The lidar branch (it raised until the lidar slice) builds Scan
    Context databases on the matcher's device, as the reference."""
    params = _set_params(**{"frontend.sensor_type": "lidar"})
    port = LoopClosureSparseMatching(params, device="cpu")
    ref = JaxLCSM(params)
    for a, b in ((port.local_nnsm, ref.local_nnsm),
                 (port.other_robots_nnsm[1], ref.other_robots_nnsm[1])):
        assert type(a).__name__ == type(b).__name__ == "ScanContextMatching"
        assert a.device == torch.device("cpu") and a.shape == b.shape


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_database_state_carried_across(storage):
    """interop.descriptor_database_from_numpy: the reference database's
    padded buffer, norms, count and items, searched by the port's kernel
    path, give the reference's results."""
    from cslam_tpu_torch import interop
    rng = np.random.default_rng(12)
    ref = JaxDescriptorDatabase(dim=16, capacity=8, method="exact",
                                storage=storage)
    for i in range(40):
        ref.add_item(_unit(rng, 16), ("kf", i))
    db = interop.descriptor_database_from_numpy(
        np.asarray(ref.data), np.asarray(ref._norms), ref.n, ref.items,
        method="pallas", device="cpu")
    assert db.data.shape == (64, 16) and len(db) == 40
    assert db.data.dtype == (torch.bfloat16 if storage == "bfloat16"
                             else torch.float32)
    tol = 5e-3 if storage == "bfloat16" else F32_TOL
    for _ in range(5):
        q = _unit(rng, 16)
        items_r, sims_r = ref.search(q, 6)
        items, sims = db.search(q, 6)
        assert items == items_r
        np.testing.assert_allclose(sims, sims_r, atol=tol)
