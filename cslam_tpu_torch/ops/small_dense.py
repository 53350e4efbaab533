"""Batched small dense factorizations for LOBPCG: the hand-written CUDA
kernel and its plain PyTorch version.

The kernel (`csrc/small_dense.cu`, built by `_build.py` at first use)
replaces no TPU kernel: the reference leaves these factorizations to
XLA inside its compiled LOBPCG. It was added because cuSOLVER's calls
at LOBPCG's sizes (eigh of 4 x 4 and 12 x 12, QR of 8 x 4, SVD of
4 x 4) each read their `info` back to the host, and a host
synchronization cannot be captured into a CUDA graph: MAC's warm-LOBPCG
Frank-Wolfe step ran ~99 of them. The kernel writes no status; it is
bound by latency, a few KB a matrix (design in its header).

On a CUDA tensor each function launches the kernel, or raises. On a CPU
tensor it runs the plain version: the same factorization through
`torch.linalg` in float64, rounded to the input's dtype. There is no
fall-back between the two: the device of the data decides. Both accept
a batch of matrices (..., n, n) or (..., m, n).

`LAUNCHES[name]` counts the kernel's executions: each launch outside a
CUDA graph capture, and each replayed one, which the code replaying a
graph adds with `count_replays`. `CAPTURED[name]` counts the launches
recorded into captures.
"""

import ctypes

import torch

EIGH_MAX = 16     # largest symmetric order
QR_MAX_ROWS = 16
QR_MAX_COLS = 8
SVD_MAX = 8       # largest square SVD
LAUNCHES = {"small_eigh": 0, "small_qr": 0, "small_svd": 0}
CAPTURED = dict.fromkeys(LAUNCHES, 0)


def _launched(name):
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def count_replays(per_replay, replays):
    """Adds `replays` replays of a graph holding `per_replay[name]`
    launches of each kernel to LAUNCHES."""
    for name, n in per_replay.items():
        LAUNCHES[name] += n * replays


def eigh_plain(A):
    """(w ascending, V) of the symmetric A's lower triangle, in float64."""
    w, V = torch.linalg.eigh(A.double())
    return w.to(A.dtype), V.to(A.dtype)


def qr_plain(A):
    """Reduced (Q, R) of the (..., m, n) A, m >= n, in float64."""
    Q, R = torch.linalg.qr(A.double())
    return Q.to(A.dtype), R.to(A.dtype)


def svd_plain(A):
    """(U, S descending, Vh) of the square A, in float64."""
    U, S, Vh = torch.linalg.svd(A.double())
    return U.to(A.dtype), S.to(A.dtype), Vh.to(A.dtype)


def _on_card(A, what, rows_max, cols_max, square):
    """A as a contiguous (batch, m, n) float32 card tensor; raises on
    what the kernel does not take."""
    if A.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"the {what} kernel takes float32, got {A.dtype}")
    if A.dim() < 2:
        raise ValueError(f"{what} takes (..., m, n) matrices")
    m, n = A.shape[-2:]
    if (square and m != n) or m > rows_max or n > cols_max or m < n or \
            n < 1:
        raise ValueError(f"the {what} kernel takes up to {rows_max} x "
                         f"{cols_max}{' square' if square else ', m >= n'}"
                         f", got {m} x {n}")
    return A.reshape(-1, m, n).contiguous()


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(dev):
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev.index))


def eigh(A):
    """Eigenvalues ascending and eigenvectors of the symmetric A (the
    lower triangle is read), as `torch.linalg.eigh`; n <= 16 on the
    card."""
    if A.device.type == "cpu":
        return eigh_plain(A)
    from cslam_tpu_torch import _build
    a = _on_card(A, "eigh", EIGH_MAX, EIGH_MAX, True)
    batch, n = a.shape[0], a.shape[-1]
    w = torch.empty((batch, n), dtype=a.dtype, device=a.device)
    V = torch.empty_like(a)
    if batch:
        _check(_build.load_library().small_eigh_launch(
            a.data_ptr(), batch, n, w.data_ptr(), V.data_ptr(),
            _stream(a.device)), "small_eigh")
        _launched("small_eigh")
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def qr(A):
    """Reduced QR of the (..., m, n) A, m >= n, as `torch.linalg.qr`;
    m <= 16 and n <= 8 on the card."""
    if A.device.type == "cpu":
        return qr_plain(A)
    from cslam_tpu_torch import _build
    a = _on_card(A, "qr", QR_MAX_ROWS, QR_MAX_COLS, False)
    batch, m, n = a.shape
    Q = torch.empty_like(a)
    R = torch.empty((batch, n, n), dtype=a.dtype, device=a.device)
    if batch:
        _check(_build.load_library().small_qr_launch(
            a.data_ptr(), batch, m, n, Q.data_ptr(), R.data_ptr(),
            _stream(a.device)), "small_qr")
        _launched("small_qr")
    return Q.reshape(A.shape), R.reshape(A.shape[:-2] + (n, n))


def svd(A):
    """(U, S descending, Vh) of the square A, as `torch.linalg.svd`;
    n <= 8 on the card."""
    if A.device.type == "cpu":
        return svd_plain(A)
    from cslam_tpu_torch import _build
    a = _on_card(A, "svd", SVD_MAX, SVD_MAX, True)
    batch, n = a.shape[0], a.shape[-1]
    U = torch.empty_like(a)
    S = torch.empty((batch, n), dtype=a.dtype, device=a.device)
    Vh = torch.empty_like(a)
    if batch:
        _check(_build.load_library().small_svd_launch(
            a.data_ptr(), batch, n, U.data_ptr(), S.data_ptr(),
            Vh.data_ptr(), _stream(a.device)), "small_svd")
        _launched("small_svd")
    return U.reshape(A.shape), S.reshape(A.shape[:-1]), Vh.reshape(A.shape)
