"""Port parity, MAC selection: Laplacian ops, Fiedler solvers and MAC of
cslam_tpu_torch against cslam_tpu on the same seeded numpy inputs, on
the CPU (the ACM bookkeeping is in test_torch_acm.py).

Tolerances: Laplacian ops 1e-5 absolute (f32 sums in another order);
lambda_2 1e-3 relative (the reference's own Fiedler accuracy budget);
selections identical on the exact-eigh and matrix-free (map-scale)
paths. The warm-LOBPCG path tracks lambda_2 as sigma - theta, a
cancellation that amplifies the last-bit differences of two BLAS
libraries through the Frank-Wolfe iterations, so its selections are
held to the reference's quality contracts instead (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cslam_tpu.sparsification.mac as jmac
import cslam_tpu_torch.sparsification.mac as tmac
from cslam_tpu.ops import fiedler as jfied
from cslam_tpu.ops import laplacian as jlap
from cslam_tpu_torch.ops import fiedler as tfied
from cslam_tpu_torch.ops import laplacian as tlap
from cslam_tpu_torch.utils import jax_random
from cslam_tpu_torch.utils.edges import Edge
from test_fiedler import random_connected_graph
from test_mac_large import chain_with_candidates

# one intra-op thread: the suite runs several pytest workers side by side,
# and torch's default of one thread per core oversubscribes the host
torch.set_num_threads(1)

LAM_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,shape", [(3, (64,)), (3, (128, 4)),
                                        (11, (4096,)), (13, (512,)),
                                        (7, (64, 4))])
def test_start_vectors_match_reference(seed, shape):
    import jax
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                       dtype=jnp.float32))
    np.testing.assert_allclose(jax_random.normal(seed, shape), ref,
                               rtol=0, atol=1e-6)


def test_laplacian_ops_match_reference():
    rng = np.random.default_rng(0)
    n = 16
    e_i, e_j, w = random_connected_graph(rng, n, 10)
    je = (jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(w))
    te = (_t(e_i), _t(e_j), _t(w))
    np.testing.assert_allclose(tlap.laplacian_dense(*te, n).numpy(),
                               np.asarray(jlap.laplacian_dense(*je, n)),
                               atol=1e-5)
    B = tlap.incidence_matrix(te[0], te[1], n)
    np.testing.assert_array_equal(
        B.numpy(), np.asarray(jlap.incidence_matrix(je[0], je[1], n)))
    np.testing.assert_allclose(
        tlap.laplacian_from_incidence(B, te[2]).numpy(),
        np.asarray(jlap.laplacian_from_incidence(
            jlap.incidence_matrix(je[0], je[1], n), je[2])), atol=1e-5)
    np.testing.assert_allclose(tlap.degree_vector(*te, n).numpy(),
                               np.asarray(jlap.degree_vector(*je, n)),
                               atol=1e-5)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        tlap.laplacian_matvec(*te, _t(x)).numpy(),
        np.asarray(jlap.laplacian_matvec(*je, jnp.asarray(x))), atol=1e-5)


def test_dense_fiedler_matches_reference():
    rng = np.random.default_rng(1)
    n, P = 24, 32
    e_i, e_j, w = random_connected_graph(rng, n, 15)
    L = np.asarray(jlap.laplacian_dense(jnp.asarray(e_i), jnp.asarray(e_j),
                                        jnp.asarray(w), P))
    mask = np.zeros(P, np.float32)
    mask[:n] = 1.0
    for jfn, tfn in ((jmac._fiedler_dense, tmac._fiedler_dense),
                     (jfied.fiedler_pair_dense, tfied.fiedler_pair_dense)):
        lam_r, v_r = jfn(jnp.asarray(L), jnp.asarray(mask))
        lam, v = tfn(_t(L), _t(mask))
        assert float(lam) == pytest.approx(float(lam_r), rel=LAM_RTOL)
        v, v_r = v.numpy(), np.asarray(v_r)
        assert min(np.linalg.norm(v - v_r), np.linalg.norm(v + v_r)) < 1e-2


def test_lobpcg_fiedler_matches_reference():
    rng = np.random.default_rng(2)
    n, P = 48, 64
    e_i, e_j, w = random_connected_graph(rng, n, 30)
    mask = np.zeros(P, np.float32)
    mask[:n] = 1.0
    lam_r, _ = jfied.fiedler_pair_lobpcg(
        jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(w),
        jnp.asarray(mask), num_iters=200)
    lam, v = tfied.fiedler_pair_lobpcg(_t(e_i), _t(e_j), _t(w), _t(mask),
                                       num_iters=200)
    assert float(lam) == pytest.approx(float(lam_r), rel=LAM_RTOL)
    assert v.shape == (P,)


def _chain_graph(n, seed, extra=12):
    rng = np.random.default_rng(seed)
    e_i = np.arange(n - 1, dtype=np.int32)
    e_j = np.arange(1, n, dtype=np.int32)
    w = np.ones(n - 1, np.float32)
    for _ in range(extra):
        a, b = rng.choice(n, 2, replace=False)
        e_i = np.append(e_i, np.int32(a))
        e_j = np.append(e_j, np.int32(b))
        w = np.append(w, np.float32(0.5 + rng.random()))
    return e_i, e_j, w


def test_inverse_iteration_matches_reference_and_gates_fire():
    """test_fiedler.py:92 on both packages: the same lambda_2 (1e-3),
    the same gated iteration counts, and the port's gates fire (a warm
    start exits at the 2-iteration floor with fewer CG trips)."""
    e_i, e_j, w = _chain_graph(512, 3)
    mask = np.ones(512, np.float32)
    je = (jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(w),
          jnp.asarray(mask))
    te = (_t(e_i), _t(e_j), _t(w), _t(mask))
    lam_c_r, v_c_r, it_c_r, cg_c_r = jfied.fiedler_pair_inverse(
        *je, invit_iters=12, cg_iters=24, return_iters=True)
    lam_c, v_c, it_c, cg_c = tfied.fiedler_pair_inverse(
        *te, invit_iters=12, cg_iters=24, return_iters=True)
    lam_w, _, it_w, cg_w = tfied.fiedler_pair_inverse(
        *te, v0=v_c, invit_iters=12, cg_iters=24, return_iters=True)
    lam_w_r, _, it_w_r, cg_w_r = jfied.fiedler_pair_inverse(
        *je, v0=v_c_r, invit_iters=12, cg_iters=24, return_iters=True)
    assert int(it_w) == 2
    assert int(cg_w) < int(cg_c)
    assert (int(it_c), int(it_w)) == (int(it_c_r), int(it_w_r))
    assert abs(int(cg_c) - int(cg_c_r)) <= 2
    assert abs(int(cg_w) - int(cg_w_r)) <= 2
    vals = np.linalg.eigvalsh(np.asarray(
        jlap.laplacian_dense(je[0], je[1], je[2], 512), np.float64))
    for lam, lam_r in ((lam_c, lam_c_r), (lam_w, lam_w_r)):
        assert float(lam) == pytest.approx(float(lam_r), rel=LAM_RTOL)
        assert abs(float(lam) - vals[1]) / vals[1] < 2e-3


def test_batched_inverse_iteration_equals_single_runs():
    """A batch of weight vectors (MAC's swap evaluation) gives each
    member the result of its own gated solve, as the reference's vmap."""
    e_i, e_j, w = _chain_graph(256, 4)
    mask = np.ones(256, np.float32)
    rng = np.random.default_rng(0)
    ws = np.stack([w * rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
                   for _ in range(3)])
    lam_b, v_b, it_b, cg_b = tfied.fiedler_pair_inverse(
        _t(e_i), _t(e_j), _t(ws), _t(mask), invit_iters=8, cg_iters=20,
        return_iters=True)
    for m in range(3):
        lam, v, it, cg = tfied.fiedler_pair_inverse(
            _t(e_i), _t(e_j), _t(ws[m]), _t(mask), invit_iters=8,
            cg_iters=20, return_iters=True)
        assert float(lam_b[m]) == pytest.approx(float(lam), rel=1e-5)
        assert (int(it_b[m]), int(cg_b[m])) == (int(it), int(cg))


def test_fiedler_dense_squaring_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(6):
        P = int(rng.choice([64, 128, 512]))
        n_real = P - int(rng.integers(0, P // 4))
        mask = np.zeros(P, np.float32)
        mask[:n_real] = 1.0
        L = np.zeros((P, P), np.float32)
        for i in range(n_real - 1):
            L[i, i] += 1
            L[i + 1, i + 1] += 1
            L[i, i + 1] -= 1
            L[i + 1, i] -= 1
        for _ in range(int(rng.integers(3, 60))):
            i, j = rng.integers(0, n_real, 2)
            if i != j:
                wt = float(rng.random())
                L[i, i] += wt
                L[j, j] += wt
                L[i, j] -= wt
                L[j, i] -= wt
        lam_r, _ = jmac._fiedler_dense_squaring(jnp.asarray(L),
                                                jnp.asarray(mask))
        lam, v = tmac._fiedler_dense_squaring(_t(L), _t(mask))
        assert float(lam) == pytest.approx(float(lam_r), rel=LAM_RTOL), trial
        assert float(torch.linalg.vector_norm(v)) == pytest.approx(
            1.0, abs=1e-4)


def _greedy_w0(cand, k):
    w0 = np.zeros(len(cand), np.float32)
    w0[np.argsort([e.weight for e in cand])[-k:]] = 1.0
    return w0


@pytest.mark.parametrize("seed,n,m,k,method,iters", [
    (0, 120, 40, 6, "eigh", 10),
    (7, 200, 60, 8, "eigh", 20),
    (0, 120, 40, 6, "matfree", 10),
    (5, 200, 60, 8, "matfree", None),
])
def test_mac_selection_identical(seed, n, m, k, method, iters):
    """test_mac_large.py problems on the exact and matrix-free paths:
    identical selections, dual bounds within 1e-3."""
    rng = np.random.default_rng(seed)
    fixed, cand = chain_with_candidates(rng, n, m)
    w0 = _greedy_w0(cand, k)
    ref = jmac.MAC(fixed, cand, n)
    port = tmac.MAC(fixed, cand, n, device="cpu")
    if method == "matfree":
        ref.use_lobpcg = port.use_lobpcg = True
    else:
        ref.fiedler_method = port.fiedler_method = method
    r = ref.fw_subset(w0, k, max_iters=iters)
    p = port.fw_subset(w0, k, max_iters=iters)
    np.testing.assert_array_equal(p.w, r.w)
    assert p.upper_bound == pytest.approx(r.upper_bound, rel=LAM_RTOL)
    assert port.evaluate_objective(p.w) == pytest.approx(
        ref.evaluate_objective(r.w), rel=LAM_RTOL)


def test_mac_map_scale_path_identical():
    """> _LOBPCG_NODE_THRESHOLD nodes: both packages default to the
    matrix-free inverse-iteration path (P = 4096, the slice's) and
    select the same edges."""
    rng = np.random.default_rng(1)
    n = 3000
    fixed, cand = chain_with_candidates(rng, n, 64)
    w0 = _greedy_w0(cand, 8)
    ref = jmac.MAC(fixed, cand, n)
    port = tmac.MAC(fixed, cand, n, device="cpu")
    assert port.use_lobpcg and port._P == 4096
    r = ref.fw_subset(w0, 8, max_iters=5)
    p = port.fw_subset(w0, 8, max_iters=5)
    assert int(p.w.sum()) == 8
    np.testing.assert_array_equal(p.w, r.w)
    assert p.upper_bound == pytest.approx(r.upper_bound, rel=LAM_RTOL)


@pytest.mark.parametrize("seed,n,m,k", [(7, 200, 60, 8), (0, 120, 40, 6)])
def test_mac_warm_lobpcg_quality_contracts(seed, n, m, k):
    """Default small-graph path: the reference's own contracts — exactly
    k selected, at least 0.9x the exact-eigh path's lambda_2, never
    below the greedy selection — and the reference meets them too."""
    rng = np.random.default_rng(seed)
    fixed, cand = chain_with_candidates(rng, n, m)
    w0 = _greedy_w0(cand, k)
    for mac in (jmac.MAC(fixed, cand, n),
                tmac.MAC(fixed, cand, n, device="cpu")):
        assert mac.fiedler_method == "warm-lobpcg"
        res = mac.fw_subset(w0, k, max_iters=20)
        assert int(res.w.sum()) == k
        mac.fiedler_method = "eigh"
        res_eigh = mac.fw_subset(w0, k, max_iters=20)
        obj = mac.evaluate_objective(res.w)
        assert obj >= mac.evaluate_objective(res_eigh.w) * 0.9
        assert obj >= mac.evaluate_objective(w0) * (1 - 1e-3)


def test_mac_disconnected_raises_and_empty():
    fixed = [Edge(0, 1, 1.0), Edge(2, 3, 1.0)]
    mac = tmac.MAC(fixed, [Edge(0, 1, 0.5)], 4, device="cpu")
    with pytest.raises(tmac.DisconnectedGraphError):
        mac.fw_subset(np.array([1.0]), 1)
    empty = tmac.MAC(fixed, [], 4, device="cpu").fw_subset(np.zeros(0), 3)
    assert empty.w.shape == (0,) and empty.upper_bound == float("inf")
