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

import zlib

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


# -- LOBPCG's device gate and the small-dense factorizations --------------

def _shifted_laplacian_operator(seed, n, P, extra):
    """sigma*I - L_s of a random connected graph padded to P, as MAC's
    warm-LOBPCG path builds it, and the path's start block."""
    rng = np.random.default_rng(seed)
    e_i, e_j, w = random_connected_graph(rng, n, extra)
    L = tlap.laplacian_dense(_t(e_i), _t(e_j), _t(w), P)
    mask = torch.zeros(P)
    mask[:n] = 1.0
    L_s = tmac._shift_deflate(L, mask)[0]
    sigma = 2.0 * torch.max(torch.diagonal(L_s)) + 1.0
    X0 = torch.from_numpy(jax_random.normal(3, (P, 4)))
    return (lambda Y: sigma * Y - L_s @ Y), X0


@pytest.mark.parametrize("seed,n,P,extra,m,converges", [
    (2, 48, 64, 30, 200, True),    # test_fiedler.py's graph: stops early
    (2, 48, 64, 30, 16, False),    # MAC's 16 iterations: the cap
    (1, 200, 256, 100, 16, False),
])
def test_lobpcg_device_gate_matches_early_exit(seed, n, P, extra, m,
                                               converges):
    """All m iterations under the device gate, nothing read back, give
    theta, U and the iteration count bitwise equal to the loop that
    reads the gate and stops."""
    from cslam_tpu_torch.ops.lobpcg import lobpcg_standard
    A, X0 = _shifted_laplacian_operator(seed, n, P, extra)
    theta_e, U_e, it_e = lobpcg_standard(A, X0, m=m)
    theta_g, U_g, it_g = lobpcg_standard(A, X0, m=m, early_exit=False)
    assert int(it_g) == int(it_e)
    assert (int(it_e) < m) == converges
    assert torch.equal(theta_g, theta_e)
    assert torch.equal(U_g, U_e)


def _small_dense_input(rng, kind, m, n, symmetric):
    """random, graded (columns over six decades) or nearly degenerate
    (eigenvalue / singular value pairs 1e-7 apart; for a tall matrix two
    columns 1e-7 apart), float32."""
    A = rng.standard_normal((m, n))
    if kind == "graded":
        A = A * np.logspace(0, -6, n)[None, :]
    if symmetric:
        A = (A + A.T) / 2
    if kind == "degenerate":
        if m == n:
            Q1 = np.linalg.qr(rng.standard_normal((n, n)))[0]
            Q2 = np.linalg.qr(rng.standard_normal((n, n)))[0]
            vals = np.repeat(np.arange(1, n // 2 + 1), 2)[:n] + \
                1e-7 * rng.standard_normal(n)
            A = Q1 @ np.diag(vals) @ (Q1 if symmetric else Q2).T
        else:
            A[:, 1] = A[:, 0] + 1e-7 * rng.standard_normal(m)
    return A.astype(np.float32)


def _clusters(vals, scale, gap_rel=1e-2):
    """Index groups of values within gap_rel * scale of a neighbour, each
    with its distance to the rest of the values."""
    order = np.argsort(vals)
    groups, cur = [], [order[0]]
    for a, b in zip(order[:-1], order[1:]):
        if vals[b] - vals[a] > gap_rel * scale:
            groups.append(cur)
            cur = []
        cur.append(b)
    groups.append(cur)
    out = []
    for g in groups:
        rest = np.delete(vals, g)
        gap = np.min(np.abs(rest[:, None] - vals[g][None, :])) \
            if rest.size else scale
        out.append((g, gap))
    return out


def _same_subspaces(vals, V1, V2, scale, what):
    """Davis-Kahan: each cluster's projector within 20 eps_32 ||A|| / gap
    (plus 1e-6) of the other's; signs and bases inside a cluster free."""
    eps = float(np.finfo(np.float32).eps)
    for g, gap in _clusters(vals, scale):
        P1 = V1[:, g] @ V1[:, g].T
        P2 = V2[:, g] @ V2[:, g].T
        err = np.abs(P1 - P2).max()
        assert err <= 20 * eps * scale / gap + 1e-6, (what, g, err, gap)


@pytest.mark.parametrize("kind", ["random", "graded", "degenerate"])
@pytest.mark.parametrize("op,shape", [("eigh", (4, 4)), ("eigh", (12, 12)),
                                      ("qr", (8, 4)), ("svd", (4, 4))])
def test_small_dense_plain_matches_linalg_f32(kind, op, shape):
    """The plain version (float64, rounded to float32) against
    torch.linalg in float32 at LOBPCG's shapes: eigen- and singular
    values within 1e-6 of the largest, subspaces by Davis-Kahan (signs
    and bases of near-equal values free), Q R = A within 1e-6 of A's
    largest entry and the factors orthonormal."""
    from cslam_tpu_torch.ops import small_dense as sd
    rng = np.random.default_rng(zlib.crc32(f"{kind} {op} {shape}".encode()))
    for _ in range(20):
        A_np = _small_dense_input(rng, kind, *shape, symmetric=op == "eigh")
        A = torch.from_numpy(A_np)
        A64 = A_np.astype(np.float64)
        if op == "eigh":
            w, V = sd.eigh(A)
            w32, V32 = torch.linalg.eigh(A)
            assert w.dtype == V.dtype == torch.float32
            scale = float(np.abs(w32.numpy()).max())
            assert np.abs(w.numpy() - w32.numpy()).max() <= 1e-6 * scale
            _same_subspaces(w.numpy().astype(np.float64), V.numpy(),
                            V32.numpy(), scale, "eigh")
            V64 = V.numpy().astype(np.float64)
            assert np.abs(V64 @ np.diag(w.numpy()) @ V64.T - A64).max() \
                <= 1e-6 * np.abs(A64).max()
        elif op == "qr":
            Q, R = sd.qr(A)
            Q32, _ = torch.linalg.qr(A)
            Q64, R64 = Q.numpy().astype(np.float64), R.numpy()
            assert np.abs(Q64 @ R64 - A64).max() <= 1e-6 * np.abs(A64).max()
            assert np.abs(Q64.T @ Q64 - np.eye(shape[1])).max() <= 1e-6
            # the span of the leading columns (nearly parallel columns
            # leave the next direction to rounding)
            lead = 1 if kind == "degenerate" else shape[1]
            for j in range(1, lead + 1):
                P1 = Q64[:, :j] @ Q64[:, :j].T
                P2 = Q32.numpy()[:, :j] @ Q32.numpy()[:, :j].T
                assert np.abs(P1 - P2).max() <= 1e-5
        else:
            U, S, Vh = sd.svd(A)
            U32, S32, Vh32 = torch.linalg.svd(A)
            scale = float(S32[0])
            assert np.abs(S.numpy() - S32.numpy()).max() <= 1e-6 * scale
            U64, Vh64 = U.numpy().astype(np.float64), Vh.numpy()
            assert np.abs(U64 @ np.diag(S.numpy()) @ Vh64 - A64).max() \
                <= 1e-6 * np.abs(A64).max()
            _same_subspaces(-S.numpy().astype(np.float64), Vh64.T,
                            Vh32.numpy().T, scale, "svd V")


@pytest.mark.parametrize("seed,n,m,k,tol", [(7, 200, 60, 8, 1e-8),
                                            (0, 120, 40, 6, 1e-8),
                                            (0, 120, 40, 6, 0.05)])
def test_fw_step_graph_body_matches_eager_loop(seed, n, m, k, tol):
    """The body a CUDA graph captures (static buffers updated in place,
    alpha from the float32 table at the device step counter, LOBPCG under
    its device gate), run uncaptured on the CPU with the host reading
    `done` as the replay loop does: w, u and the iteration count bitwise
    equal to the eager warm-LOBPCG loop. tol 0.05 stops early."""
    rng = np.random.default_rng(seed)
    fixed, cand = chain_with_candidates(rng, n, m)
    mac = tmac.MAC(fixed, cand, n, device="cpu")
    assert mac.fiedler_method == "warm-lobpcg"
    w0 = mac._pad_w(_greedy_w0(cand, k))
    pb = tmac._Problem(
        mac.L_fixed, tlap.incidence_matrix(mac._e_i_d, mac._e_j_d, mac._P),
        mac._weights_d, mac._valid_d, mac.node_mask, mac._e_i_d.long(),
        mac._e_j_d.long(), torch.tensor(float("-inf")))
    X0 = torch.from_numpy(jax_random.normal(3, (mac._P, mac.lobpcg_block)))
    w_e, u_e, it_e = tmac._fw_loop(
        pb, k, w0, X0, tol, 20,
        lambda w, X: tmac._warm_fiedler(pb, w, X, mac.lobpcg_iters))
    entry = tmac._StepGraph(torch.device("cpu"), mac._P, mac._E, k,
                            mac.lobpcg_iters, mac.lobpcg_block, 32)
    entry.load(pb, w0, X0, tol)
    it = 0
    while it < 20 and not bool(entry.done):
        entry.step()
        it += 1
    assert it == it_e == int(entry.it)
    assert (it < 20) == (tol > 1e-3)
    assert torch.equal(entry.w, w_e)
    assert torch.equal(entry.u, u_e)
