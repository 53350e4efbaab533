"""Graph-Laplacian assembly ops (dense and matrix-free).

Port of cslam_tpu/ops/laplacian.py. Endpoints are int32 at the public
boundary, as in the reference; `index_add_` wants int64, so they are
widened inside. Padded edges carry weight 0 and endpoints (0, 0), so
they contribute nothing.

The matrix-free forms also take a leading batch axis on `weights` and
`x` ((Bt, E) and (Bt, P)): MAC evaluates a batch of one-edge-swapped
selections at once, as the reference does with vmap.
"""

import torch


def _long(idx):
    return idx.to(torch.int64)


def laplacian_dense(e_i, e_j, weights, num_nodes: int):
    """Weighted graph Laplacian L = D - W as a dense (P, P) matrix."""
    w = weights.float()
    ei, ej = _long(e_i), _long(e_j)
    P = int(num_nodes)
    L = torch.zeros(P * P, dtype=torch.float32, device=w.device)
    L.index_add_(0, ei * P + ei, w)
    L.index_add_(0, ej * P + ej, w)
    L.index_add_(0, ei * P + ej, -w)
    L.index_add_(0, ej * P + ei, -w)
    return L.reshape(P, P)


def incidence_matrix(e_i, e_j, num_nodes: int):
    """Dense signed incidence matrix B (P, E): column e has +1 at e_i,
    -1 at e_j, so L(w) = (B * w) @ B.T."""
    rows = torch.arange(int(num_nodes), device=e_i.device)[:, None]
    return ((rows == _long(e_i)[None, :]).float()
            - (rows == _long(e_j)[None, :]).float())


def laplacian_from_incidence(B, weights):
    """L(w) = B diag(w) B^T; batched over leading axes of `weights`."""
    return (B * weights.float()[..., None, :]) @ B.T


def degree_vector(e_i, e_j, weights, num_nodes: int):
    """Weighted degrees d_i = sum of incident edge weights; (..., P) for
    weights (..., E)."""
    w = weights.float()
    d = torch.zeros(w.shape[:-1] + (int(num_nodes),), dtype=torch.float32,
                    device=w.device)
    d.index_add_(-1, _long(e_i), w)
    d.index_add_(-1, _long(e_j), w)
    return d


def laplacian_matvec(e_i, e_j, weights, x):
    """y = L x without materializing L. x: (..., P); weights (E,) or
    (..., E) with the same leading axes."""
    ei, ej = _long(e_i), _long(e_j)
    w = weights.to(x.dtype)
    diff = w * (x[..., ei] - x[..., ej])
    y = torch.zeros_like(x)
    y.index_add_(-1, ei, diff)
    y.index_add_(-1, ej, -diff)
    return y
