"""Port of `jax.experimental.sparse.linalg.lobpcg_standard`.

The reference's warm-started MAC and `fiedler_pair_lobpcg` call JAX's
LOBPCG; `torch.lobpcg` is a different algorithm (other basis handling,
other convergence test), so its eigenvalues and iteration counts would
not match. This is the same iteration, step for step: SVQB
orthonormalization (twice), "twice is enough" projection with the
0.99-norm truncation, a Rayleigh-Ritz eigensolve of the (X, P, R)
basis, the QR-orthogonalized P update, the block-Householder basis
extension, and the self-consistency convergence test
|r| < eps * 10 * n * (|A x| + theta). Every product runs in full fp32
(the reference uses HIGHEST precision). The small eigensolves, the QR
and the SVD go through `ops/small_dense.py`: on the card a kernel that
never synchronizes with the host, on the CPU `torch.linalg` in float64.

The loop's gate (fewer than m iterations, fewer than k pairs converged)
is a device flag: an iteration whose gate has closed leaves the state as
it was. With `early_exit` the host reads the flag before each iteration
and stops, as the reference's while loop does; without it all m
iterations run and nothing is read back, so the whole solve can be
captured into a CUDA graph. Both give the same theta, U and count.
"""

import torch

from cslam_tpu_torch.ops import small_dense


def _eigh_descending(A):
    w, V = small_dense.eigh(A)
    return w.flip(-1), V.flip(-1)


def _col_norms(X):
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _svqb(X):
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _col_norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = _col_norms(U)
    return U * (normU >= 0.99).to(U.dtype)


def _extend_basis(X, m):
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = small_dense.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(A, X, m: int = 100, tol=None, early_exit: bool = True):
    """Top-k eigenpairs of the symmetric operator `A` (a callable on
    (n, k) blocks) from the start block X. Returns (theta, U, iters),
    iters a 0-d int64 tensor on X's device. early_exit=False runs all m
    iterations under the device gate and reads nothing back."""
    n, k = X.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"need 0 < 5k < n, got k={k}, n={n}")
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i = torch.zeros((), dtype=torch.int64, device=X.device)
    active = torch.full((), m > 0, dtype=torch.bool, device=X.device)
    for step in range(m):
        if early_exit and step > 0 and not bool(active):
            break
        R_n = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R_n), dim=1)
        theta_all, Q = _eigh_descending(XPR.T @ A(XPR))
        B = Q[:, :k]
        B = B / _col_norms(B)
        X_n = XPR @ B
        X_n = X_n / _col_norms(X_n)
        q, _ = small_dense.qr(Q[:k, k:].T)
        P_n = XPR @ (Q[:, k:] @ q)
        normP = _col_norms(P_n)
        P_n = P_n / torch.where(normP == 0, torch.ones_like(normP), normP)
        AX = A(X_n)
        R_n = AX - theta_all[None, :k] * X_n
        resid_norms = torch.linalg.vector_norm(R_n, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta_all[:k]) * n * 10
        converged = torch.sum(resid_norms < tol * reltol)
        X = torch.where(active, X_n, X)
        P = torch.where(active, P_n, P)
        R = torch.where(active, R_n, R)
        theta = torch.where(active, theta_all[None, :k], theta)
        i = i + active.to(i.dtype)
        active = active & (i < m) & (converged < k)
    return theta[0, :], X, i
