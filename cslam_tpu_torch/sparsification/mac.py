"""MAC — maximize algebraic connectivity under an edge budget.

Port of cslam_tpu/sparsification/mac.py: Frank-Wolfe maximization of
lambda_2(L(w)) subject to |w| = k over candidate edge weights w in
[0, 1]^m, with the reference's semantics throughout — supergradient
weight_k * (v_i - v_j)^2, top-k direction, dual upper bound with
duality-gap stop, step 2/(it+2), tie-broken rounding, the >=greedy
safeguard, one-swap refinement, and DisconnectedGraphError from an
exact union-find check of the initial iterate.

Fiedler pairs per FW step: "eigh" (exact), "warm-lobpcg" (dense
Laplacian, LOBPCG block carried across steps; the default up to
_LOBPCG_NODE_THRESHOLD nodes) or "matfree" (inverse iteration over edge
lists, the map-scale default). Nodes and candidate edges are padded to
power-of-two buckets as in the reference: the padding fixes P in the
dense forms and in the reference's fixed-seed start vectors, which this
port reproduces (utils/jax_random.py), so iteration counts match.

The reference evaluates the refinement's SWAP_K^2 swapped selections
with one vmapped program; here they run as one batch of the same
solvers (a member's gated loops stop independently).
"""

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from cslam_tpu_torch.device import DeviceLike, resolve_device
from cslam_tpu_torch.ops.fiedler import fiedler_pair_inverse
from cslam_tpu_torch.ops.knn import topk_desc
from cslam_tpu_torch.ops.laplacian import (incidence_matrix, laplacian_dense,
                                           laplacian_from_incidence)
from cslam_tpu_torch.ops.lobpcg import lobpcg_standard
from cslam_tpu_torch.utils import jax_random
from cslam_tpu_torch.utils.edges import Edge

# Above this node count the dense Fiedler forms give way to the
# matrix-free inverse iteration over edge lists.
_LOBPCG_NODE_THRESHOLD = 2048


class DisconnectedGraphError(RuntimeError):
    """Raised when the (fixed + selected-candidate) graph is disconnected."""


class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


class MACResult(NamedTuple):
    w: np.ndarray  # rounded {0,1}^m selection
    w_unrounded: np.ndarray
    upper_bound: float


def _next_pow2(n: int, minimum: int = 64) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _shift_deflate(L, node_mask):
    """L + (c/n_real) 1_real 1_real^T + diag(padding * big), with c and
    big above lambda_max; batched over leading axes of L. Returns
    (L_shifted, max_deg)."""
    n_real = torch.clamp(torch.sum(node_mask), min=1.0)
    max_deg = torch.amax(torch.diagonal(L, dim1=-2, dim2=-1), dim=-1)
    c = 2.0 * max_deg + 1.0
    big = 2.0 * max_deg + 2.0
    outer = node_mask[:, None] * node_mask[None, :]
    L_shifted = (L + (c / n_real)[..., None, None] * outer
                 + torch.diag_embed((1.0 - node_mask) * big[..., None]))
    return L_shifted, max_deg


def _fiedler_dense(L, node_mask):
    """(lambda_2, v_2) by eigh of the shifted/deflated Laplacian."""
    L_shifted, _ = _shift_deflate(L, node_mask)
    vals, vecs = torch.linalg.eigh(L_shifted)
    return vals[..., 0], vecs[..., :, 0]


def _fiedler_dense_squaring(L, node_mask, squarings=16):
    """(lambda_2, v_2) by `squarings` renormalized squarings of
    sigma*I - L_shifted (its dominant eigenpair); batched over leading
    axes of L. One-sided estimate (>= the true lambda_2)."""
    L_shifted, max_deg = _shift_deflate(L, node_mask)
    P = L.shape[-1]
    sigma = 2.0 * max_deg + 3.0
    eye = torch.eye(P, dtype=L.dtype, device=L.device)
    M = sigma[..., None, None] * eye - L_shifted

    def renorm(M):
        n = torch.linalg.matrix_norm(M)
        return M / torch.clamp(n, min=1e-30)[..., None, None]

    M = renorm(M)
    for _ in range(squarings):
        M = renorm(M @ M)
    col = torch.argmax(torch.sum(M * M, dim=-2), dim=-1)
    v = torch.gather(M, -1, col[..., None, None].expand(
        M.shape[:-1] + (1,)))[..., 0]
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-30)
    lam = torch.sum(v * (L_shifted @ v[..., None])[..., 0], dim=-1)
    return lam, v


def _scatter_one(base, idx, value):
    out = base.clone()
    out[idx] = value
    return out


def _swap_batch(sel, add_idx, rem_idx, swap_k):
    """(swap_k^2, E) selections: row a*swap_k + r removes rem_idx[r]
    and adds add_idx[a]."""
    aa = torch.arange(swap_k, device=sel.device).repeat_interleave(swap_k)
    rr = torch.arange(swap_k, device=sel.device).repeat(swap_k)
    sels = sel.expand(swap_k * swap_k, -1).clone()
    rows = torch.arange(swap_k * swap_k, device=sel.device)
    sels[rows, rem_idx[rr]] = 0.0
    sels[rows, add_idx[aa]] = 1.0
    return sels, aa, rr


def _fw_subset(L_fixed, e_i, e_j, weights, valid, node_mask, w_init,
               duality_gap_tol, fixed_e_i=None, fixed_e_j=None,
               fixed_w=None, *, k, max_iters, num_nodes,
               fiedler_method="eigh", lobpcg_iters=16, lobpcg_block=4,
               refine_rounds=0, swap_k=4):
    """Frank-Wolfe subset selection. Returns (w_rounded, w_unrounded,
    upper_bound) as tensors."""
    dev = weights.device
    ninf = torch.tensor(float("-inf"), device=dev)
    ei, ej = e_i.to(torch.int64), e_j.to(torch.int64)

    if fiedler_method == "matfree":
        all_i = torch.cat([fixed_e_i, e_i])
        all_j = torch.cat([fixed_e_j, e_j])

        def eval_sel(sel, v0, invit, cg):
            all_w = torch.cat([fixed_w.expand(sel.shape[:-1] + (-1,)),
                               sel * weights], dim=-1)
            return fiedler_pair_inverse(all_i, all_j, all_w, node_mask,
                                        v0=v0, invit_iters=invit,
                                        cg_iters=cg)

        def fiedler_at(w, v):
            lam2, v = eval_sel(w, v, 6, 16)
            return lam2, v, v
        carry = torch.from_numpy(
            jax_random.normal(3, (node_mask.shape[0],))).to(dev)
    else:
        B = incidence_matrix(e_i, e_j, num_nodes)

        def shifted(w):
            L = L_fixed + laplacian_from_incidence(B, w * weights)
            return _shift_deflate(L, node_mask)[0]

        def rounding_lam2(sel):
            L = L_fixed + laplacian_from_incidence(B, sel * weights)
            return _fiedler_dense_squaring(L, node_mask)[0]

        if fiedler_method == "warm-lobpcg":
            def fiedler_at(w, X):
                L_s = shifted(w)
                # largest eigenpairs of sigma*I - L_s == smallest of L_s
                sigma = 2.0 * torch.max(torch.diagonal(L_s)) + 1.0
                theta, U, _ = lobpcg_standard(lambda Y: sigma * Y - L_s @ Y,
                                              X, m=lobpcg_iters)
                return sigma - theta[0], U[:, 0], U
            carry = torch.from_numpy(
                jax_random.normal(3, (num_nodes, lobpcg_block))).to(dev)
        else:
            def fiedler_at(w, carry):
                vals, vecs = torch.linalg.eigh(shifted(w))
                return vals[0], vecs[:, 0], carry
            carry = torch.zeros((1,), device=dev)

    def round_topk(key_vec):
        _, idx = topk_desc(torch.where(valid > 0, key_vec, ninf), k)
        return _scatter_one(torch.zeros_like(key_vec), idx, 1.0)

    def supergrad(v):
        return weights * torch.square(v[ei] - v[ej]) * valid

    it = 0
    w = w_init.float()
    u = torch.tensor(float("inf"), device=dev)
    done = False
    while it < max_iters and not done:
        lam2, v, carry = fiedler_at(w, carry)
        grad = supergrad(v)
        s = round_topk(grad)
        u = torch.minimum(u, lam2 + torch.dot(grad, s - w))
        done = bool((u - lam2) < duality_gap_tol)
        if not done:
            w = w + (2.0 / (it + 2.0)) * (s - w)
        it += 1

    # tie-break rounding: primary key w, secondary key original weight
    # (the reference's lexsort; its last key is primary)
    primary = torch.where(valid > 0, w, torch.full_like(w, -1.0))
    by_weight = torch.sort(weights, stable=True)[1]
    order = by_weight[torch.sort(primary[by_weight], stable=True)[1]]
    w_rounded = torch.zeros_like(w)
    if k > 0:
        w_rounded[order[-k:]] = 1.0

    if fiedler_method != "matfree" and k > 0:
        # >=greedy safeguard: keep the FW rounding only if it beats the
        # greedy-by-weight rounding by the squaring estimate's margin
        w_greedy = round_topk(weights)
        lam2s = rounding_lam2(torch.stack([w_rounded, w_greedy]))
        if not bool(lam2s[0] > lam2s[1] * 1.003):
            w_rounded = w_greedy

    if fiedler_method != "matfree" and k > 0 and refine_rounds > 0:
        can_swap = bool(torch.sum(valid) > k) and k >= 1
        for _ in range(refine_rounds):
            L = L_fixed + laplacian_from_incidence(B, w_rounded * weights)
            lam2_cur, v = _fiedler_dense_squaring(L, node_mask)
            grad = supergrad(v)
            sel = w_rounded
            add_s, add_idx = topk_desc(
                torch.where((sel < 0.5) & (valid > 0), grad, ninf), swap_k)
            rem_s, rem_idx = topk_desc(
                torch.where(sel > 0.5, -grad, ninf), swap_k)
            sels, aa, rr = _swap_batch(sel, add_idx, rem_idx, swap_k)
            swap_ok = torch.isfinite(add_s)[aa] & torch.isfinite(rem_s)[rr]
            lam2s = rounding_lam2(sels)
            lam2s = torch.where(swap_ok & can_swap, lam2s, ninf)
            best = int(torch.argmax(lam2s))
            if bool(lam2s[best] > lam2_cur * 1.005):
                w_rounded = sels[best]

    if fiedler_method == "matfree" and k > 0 and refine_rounds > 0:
        can_swap = bool(torch.sum(valid) > k)
        v_carry = torch.from_numpy(
            jax_random.normal(11, (node_mask.shape[0],))).to(dev)
        # >=greedy safeguard, matfree flavor
        w_greedy = round_topk(weights)
        lam_fw, v_carry = eval_sel(w_rounded, v_carry, 12, 24)
        lam_gr, _ = eval_sel(w_greedy, v_carry, 12, 24)
        if not bool(lam_fw > lam_gr * 1.01):
            w_rounded = w_greedy
        for _ in range(refine_rounds):
            sel = w_rounded
            lam2_cur, v_carry = eval_sel(sel, v_carry, 8, 20)
            grad = supergrad(v_carry)
            add_s, add_idx = topk_desc(
                torch.where((sel < 0.5) & (valid > 0), grad, ninf), swap_k)
            rem_s, rem_idx = topk_desc(
                torch.where(sel > 0.5, -grad, ninf), swap_k)
            sels, aa, rr = _swap_batch(sel, add_idx, rem_idx, swap_k)
            swap_ok = torch.isfinite(add_s)[aa] & torch.isfinite(rem_s)[rr]
            lam2s, _ = eval_sel(sels, v_carry, 8, 20)
            lam2s = torch.where(swap_ok & can_swap, lam2s, ninf)
            best = int(torch.argmax(lam2s))
            if bool(lam2s[best] > lam2_cur * 1.01):
                w_rounded = sels[best]
    return w_rounded, w, u


class MAC:
    """Host wrapper: builds padded arrays once, runs the FW solve.

    Interface of the reference MAC class: __init__(fixed_measurements,
    candidate_measurements, num_poses) and fw_subset(w_init, k,
    max_iters, duality_gap_tol); plus `device` (None = the CUDA card).
    """

    def __init__(self, fixed_measurements: Sequence[Edge],
                 candidate_measurements: Sequence[Edge], num_poses: int,
                 device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        self.num_poses = int(num_poses)
        self._P = _next_pow2(max(self.num_poses, 2))
        m = len(candidate_measurements)
        self._E = _next_pow2(max(m, 1), minimum=8)
        self.m = m

        # fixed edges padded to a power-of-two bucket; zero-weight (0, 0)
        # padding contributes nothing to any Laplacian form
        F = _next_pow2(max(len(fixed_measurements), 1))
        fi = np.zeros(F, dtype=np.int32)
        fj = np.zeros(F, dtype=np.int32)
        fw = np.zeros(F, dtype=np.float32)
        for idx, e in enumerate(fixed_measurements):
            fi[idx], fj[idx], fw[idx] = e.i, e.j, e.weight
        self._fixed_i = torch.from_numpy(fi).to(dev)
        self._fixed_j = torch.from_numpy(fj).to(dev)
        self._fixed_w = torch.from_numpy(fw).to(dev)
        self.fiedler_method = "matfree" if self._P > _LOBPCG_NODE_THRESHOLD \
            else "warm-lobpcg"
        self.lobpcg_iters = 16
        self.lobpcg_block = 4
        self.refine_rounds = self._default_refine_rounds()
        self.swap_k = 4
        # matfree FW iteration cap for the default budget at map scale
        self.fw_matfree_iters = 8
        if self.fiedler_method == "matfree":
            self.L_fixed = torch.zeros((1, 1), device=dev)
        else:
            self.L_fixed = laplacian_dense(self._fixed_i, self._fixed_j,
                                           self._fixed_w, self._P)

        self.e_i = np.zeros(self._E, dtype=np.int32)
        self.e_j = np.zeros(self._E, dtype=np.int32)
        self.weights = np.zeros(self._E, dtype=np.float32)
        self.valid = np.zeros(self._E, dtype=np.float32)
        for idx, e in enumerate(candidate_measurements):
            self.e_i[idx], self.e_j[idx] = e.i, e.j
            self.weights[idx] = e.weight
            self.valid[idx] = 1.0

        mask = np.zeros(self._P, dtype=np.float32)
        mask[:self.num_poses] = 1.0
        self.node_mask = torch.from_numpy(mask).to(dev)
        self._e_i_d = torch.from_numpy(self.e_i).to(dev)
        self._e_j_d = torch.from_numpy(self.e_j).to(dev)
        self._weights_d = torch.from_numpy(self.weights).to(dev)
        self._valid_d = torch.from_numpy(self.valid).to(dev)

        self._fixed_pairs = [(int(e.i), int(e.j)) for e in fixed_measurements]
        self._cand_pairs = [(int(e.i), int(e.j))
                            for e in candidate_measurements]

    def _default_refine_rounds(self) -> int:
        if self.fiedler_method == "matfree":
            return 4
        return 2 if self._P <= 512 else 1

    @property
    def use_lobpcg(self):
        return self.fiedler_method == "matfree"

    @use_lobpcg.setter
    def use_lobpcg(self, value):
        self.fiedler_method = "matfree" if value else "eigh"
        self.refine_rounds = self._default_refine_rounds()

    def _check_connected(self, w, tol=1e-10):
        """Exact connectivity of fixed edges + candidates with w > tol;
        raises DisconnectedGraphError when a node is unreachable."""
        if self.num_poses <= 1:
            return
        uf = _UnionFind(self.num_poses)
        for i, j in self._fixed_pairs:
            uf.union(i, j)
        for (i, j), wi in zip(self._cand_pairs, np.asarray(w)):
            if wi > tol:
                uf.union(i, j)
        root = uf.find(0)
        for node in range(1, self.num_poses):
            if uf.find(node) != root:
                raise DisconnectedGraphError(
                    f"node {node} unreachable in the selected graph")

    def _pad_w(self, w):
        out = np.zeros(self._E, dtype=np.float32)
        out[:len(w)] = np.asarray(w, dtype=np.float32)
        return torch.from_numpy(out).to(self.device)

    def evaluate_objective(self, w) -> float:
        """lambda_2(L(w)) by the exact dense eigensolve."""
        L = self.L_fixed + laplacian_dense(self._e_i_d, self._e_j_d,
                                      self._pad_w(w) * self._weights_d,
                                      self._P)
        self._check_connected(w)
        lam2, _ = _fiedler_dense(L, self.node_mask)
        return float(lam2)

    def fw_subset(self, w_init, k: int, max_iters=None,
                  duality_gap_tol: float = 1e-8) -> MACResult:
        """Frank-Wolfe subset selection. Defaults match the reference:
        max_iters=20, tol 1e-8; max_iters=None lets the map-scale matfree
        path take its fw_matfree_iters budget, an explicit value is
        honored as given."""
        k = int(min(k, self.m))
        if self.m == 0 or k <= 0:
            return MACResult(np.zeros(self.m, np.float32),
                             np.zeros(self.m, np.float32), float("inf"))
        if max_iters is None:
            max_iters = 20
            if (self.fiedler_method == "matfree"
                    and self._P > _LOBPCG_NODE_THRESHOLD):
                max_iters = min(max_iters, self.fw_matfree_iters)
        # FW support only grows, so connectivity at the initial iterate
        # implies connectivity at every iterate
        self._check_connected(w_init)
        w_rounded, w, u = _fw_subset(
            self.L_fixed, self._e_i_d, self._e_j_d,
            self._weights_d, self._valid_d,
            self.node_mask, self._pad_w(w_init), float(duality_gap_tol),
            self._fixed_i, self._fixed_j, self._fixed_w,
            k=k, max_iters=max_iters, num_nodes=self._P,
            fiedler_method=self.fiedler_method,
            lobpcg_iters=self.lobpcg_iters, lobpcg_block=self.lobpcg_block,
            refine_rounds=self.refine_rounds, swap_k=self.swap_k)
        return MACResult(w_rounded.cpu().numpy()[:self.m],
                         w.cpu().numpy()[:self.m], float(u))


def select_measurements(measurements: Sequence, w) -> List:
    """Subset of measurements where the rounded selection is 1."""
    if len(measurements) != len(w):
        raise ValueError("measurements and w differ in length")
    return [m for m, wi in zip(measurements, w) if wi == 1.0]
