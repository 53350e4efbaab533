"""Fused exact cosine top-k: the hand-written CUDA kernel and its plain
PyTorch version.

Port of cslam_tpu/ops/knn_pallas.py. The reference streams database
tiles through a Pallas TPU kernel (`_knn_kernel`) that keeps a running
top-k per query behind a gate; here the kernel is
`csrc/cosine_topk.cu` (design and bound in its header), built by
`_build.py` at first use.

On a CUDA tensor `cosine_topk_pallas` launches the kernel, or raises.
The kernel takes the raw queries and the cached row norms and does the
reference wrapper's preparation itself (queries normalized in f32 and
cast to the database dtype, inverse norms, rows past n_valid masked),
so a search of k <= KMAX is one launch; a wider k is served in
ceil(k / KMAX) launches chained by `topk_in_passes`. On a CPU tensor it
runs `prepare_inputs` and `cosine_topk_plain`, the plain version of the
same function. There is no fall-back between the two: the device of the
data decides.

`CardSearch` serves one database's searches of k <= KMAX on the card in
one native call each (`cosine_topk_search_sync`): the rows added since
the last upload, the query, the same pass of the same kernel, and the
results back into pinned host memory, on a stream of the database's own.
"""

import ctypes

import numpy as np
import torch

from cslam_tpu_torch.ops.knn import topk_desc

NEG_LARGE = -3.0e38  # finite "-inf" of missing slots, as in the reference
KMAX = 64            # widest pass of the kernel
_TARGET_BLOCKS = 2 * 132  # about two blocks per H100 SM
_MAX_SPLITS = 1024
KERNELS = {torch.float32: "cosine_topk_f32",
           torch.bfloat16: "cosine_topk_bf16_mma"}


def prepare_inputs(data, n_valid, queries, data_norms=None):
    """(inv, bias, queries_n) as the reference's wrapper builds them:
    masked inverse row norms (0 past n_valid), a bias row (NEG_LARGE
    past n_valid), queries normalized in f32 then cast to data.dtype."""
    N = data.shape[0]
    if data_norms is None:
        data_norms = torch.linalg.vector_norm(data.float(), dim=1)
    valid = torch.arange(N, device=data.device) < int(n_valid)
    inv = torch.where(valid,
                      1.0 / torch.clamp(data_norms.float(), min=1e-12),
                      torch.zeros((), device=data.device))
    bias = torch.where(valid, torch.zeros((), device=data.device),
                       torch.full((), NEG_LARGE, device=data.device))
    q = queries.float()
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                        min=1e-12)
    return inv.contiguous(), bias.contiguous(), q.to(data.dtype).contiguous()


def cosine_topk_plain(data, n_valid, queries_n, inv, bias, k: int,
                      after=None):
    """The kernel's function in plain PyTorch: sims = (q . row) * inv +
    bias in f32 over the first n_valid rows, top-k by value descending
    with ties to the lower row; slots past the admissible rows hold
    NEG_LARGE with row 0.

    after: optional ((B,) values, (B,) rows), the pair a previous pass
    ended on; a row is then admissible only if it ranks strictly after
    that pair (value desc, row asc), as in one pass of the kernel."""
    N = data.shape[0]
    B = queries_n.shape[0]
    sims = (queries_n.float() @ data.float().T) * inv[None, :] + bias[None, :]
    rows = torch.arange(N, device=data.device)
    admissible = (rows < int(n_valid))[None, :]
    if after is not None:
        av, ai = after[0][:, None], after[1][:, None].long()
        admissible = admissible & ((sims < av) | ((sims == av) &
                                                  (rows[None, :] > ai)))
    sims = torch.where(admissible, sims, torch.full_like(sims, -torch.inf))
    n_take = min(int(k), N)
    vals, idx = topk_desc(sims, n_take)
    missing = vals == -torch.inf
    out_v = torch.full((B, k), NEG_LARGE, dtype=torch.float32,
                       device=data.device)
    out_i = torch.zeros((B, k), dtype=torch.int32, device=data.device)
    out_v[:, :n_take] = torch.where(missing, NEG_LARGE, vals)
    out_i[:, :n_take] = torch.where(missing, 0, idx).to(torch.int32)
    return out_i, out_v


def topk_in_passes(one_pass, B: int, k: int, device):
    """An exact top-k of any width from passes of at most KMAX.

    `one_pass(dst_i, dst_v, after)` writes the next dst.shape[1] <= KMAX
    entries into the (B, width) views dst_i / dst_v, taking only rows
    that rank strictly after `after` (None on the first pass, else the
    (values, rows) column the previous pass ended on). The order is
    total, so the passes concatenate to the top-k; once a pass ends on a
    missing slot, every later slot is missing too.

    Returns (indices, sims), (B, k) int32 and float32."""
    out_i = torch.empty((B, k), dtype=torch.int32, device=device)
    out_v = torch.empty((B, k), dtype=torch.float32, device=device)
    if k <= KMAX:
        one_pass(out_i, out_v, None)
        return out_i, out_v
    for c0 in range(0, k, KMAX):
        c1 = min(c0 + KMAX, k)
        after = None if c0 == 0 else (out_v[:, c0 - 1], out_i[:, c0 - 1])
        one_pass(out_i[:, c0:c1], out_v[:, c0:c1], after)
    return out_i, out_v


def block_shape(dtype, B: int):
    """(queries per block, rows per tile) of the kernel for this dtype:
    float32 32 x 64, or 4 x 64 for B <= 4; bfloat16 64 x 128, or 16 x 128
    for B <= 16."""
    if dtype == torch.float32:
        return (4 if B <= 4 else 32), 64
    return (16 if B <= 16 else 64), 128


def split_plan(B: int, n_valid: int, qb: int, rt: int):
    """(splits, rows_per_split): enough row ranges that the grid has
    about _TARGET_BLOCKS blocks, each range a whole number of tiles.
    Depends on the shapes only, so every pass of a search has the same
    grid (and the same summation order)."""
    qblocks = -(-B // qb)
    tiles = max(-(-n_valid // rt), 1)
    splits = min(max(-(-_TARGET_BLOCKS // qblocks), 1), tiles, _MAX_SPLITS)
    rows = -(-tiles // splits) * rt
    splits = max(-(-n_valid // rows), 1)
    return splits, rows


# Per (device, stream): ticket counters, split lists and the normalized
# query scratch, grown on demand. The kernel leaves every counter at 0,
# so the counters are zeroed only when allocated; two streams never
# share them.
_WORKSPACES = {}


def _workspace(dev, stream, n_tickets, n_cand, qn_bytes):
    ws = _WORKSPACES.get((dev, stream))
    if ws is None or ws[0].numel() < n_tickets or \
            ws[1].numel() < 2 * n_cand or ws[2].numel() < qn_bytes:
        have = (0, 0, 0) if ws is None else tuple(t.numel() for t in ws)
        ws = (torch.zeros(max(n_tickets, have[0], 64), dtype=torch.int32,
                          device=dev),
              torch.empty(max(2 * n_cand, have[1]), dtype=torch.int32,
                          device=dev),
              torch.empty(max(qn_bytes, have[2], 16), dtype=torch.uint8,
                          device=dev))
        _WORKSPACES[(dev, stream)] = ws
    return ws


def _search_on_card(data, n_valid, queries, norms, k):
    """One search on the card: ceil(k / KMAX) kernel launches."""
    from cslam_tpu_torch import _build

    dev = data.device
    if data.dtype not in KERNELS:
        raise TypeError(f"cosine_topk kernel takes float32 or bfloat16 "
                        f"data, got {data.dtype}")
    if queries.dtype != torch.float32:
        queries = queries.float()
    for name, t in (("data", data), ("queries", queries), ("norms", norms)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if norms.dtype != torch.float32:
        raise TypeError("data_norms must be float32")
    N, D = data.shape
    B = queries.shape[0]
    if queries.shape[1] != D or norms.shape != (N,):
        raise ValueError("shape mismatch between data, queries and norms")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    lib = _build.load_library()
    qb, rt = block_shape(data.dtype, B)
    splits, rows = split_plan(B, n_valid, qb, rt)
    # the raw cudaStream_t of torch.cuda.current_stream(dev), without
    # building a Stream object (a tenth of the host time per search)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets, cand, qn = _workspace(
        dev.index, stream, 3 * -(-B // qb), B * splits * min(k, KMAX),
        B * D * data.element_size())
    dtype_code = 0 if data.dtype == torch.float32 else 1

    def one_pass(dst_i, dst_v, after):
        kp = dst_i.shape[1]
        n_cand = B * splits * kp
        rc = lib.cosine_topk_launch(
            data.data_ptr(), dtype_code, norms.data_ptr(),
            queries.data_ptr(), qn.data_ptr(), n_valid, D, B, qb, kp,
            splits, rows, None if after is None else after[0].data_ptr(),
            None if after is None else after[1].data_ptr(), k,
            cand.data_ptr() + 4 * n_cand, cand.data_ptr(),
            tickets.data_ptr(), dst_v.data_ptr(), dst_i.data_ptr(), k,
            ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"cosine_topk kernel launch failed: CUDA "
                               f"error {rc}")

    out = topk_in_passes(one_pass, B, k, dev)
    cosine_topk_pallas.launches[KERNELS[data.dtype]] += 1
    return out


def cosine_topk_pallas(data, n_valid, queries, k: int, tile_rows=None,
                       data_norms=None, query_groups: int = 1):
    """Fused exact top-k cosine search (the reference's signature).

    Args:
      data: (N_cap, D) float32 or bfloat16 database.
      n_valid: number of valid rows.
      queries: (B, D); normalized here (inside the kernel on the card).
      k: neighbor count, any k >= 1.
      tile_rows, query_groups: the reference kernel's tiling knobs,
        checked as the reference checks them and otherwise unused (the
        CUDA kernel picks its own tiles; results do not depend on them).
      data_norms: optional (N_cap,) cached float32 row norms; computed
        here when absent.

    Returns (indices, sims): (B, k) int32 and (B, k) float32, descending;
    missing slots carry NEG_LARGE with index 0.

    `cosine_topk_pallas.launches[name]` counts the searches on the card
    through each kernel (KERNELS).
    """
    N = data.shape[0]
    B = queries.shape[0]
    if tile_rows is None:
        tile_rows = 2048 if N % 2048 == 0 else N
    if N % tile_rows != 0:
        raise ValueError(f"N_cap={N} is not a multiple of tile_rows="
                         f"{tile_rows}")
    if B % query_groups != 0:
        raise ValueError(f"B={B} is not a multiple of query_groups="
                         f"{query_groups}")
    n_valid = min(max(int(n_valid), 0), N)
    if data.device.type == "cpu":
        inv, bias, queries_n = prepare_inputs(data, n_valid, queries,
                                              data_norms)
        return cosine_topk_plain(data, n_valid, queries_n, inv, bias, k)
    if data.device.type != "cuda":
        raise ValueError(f"cosine_topk_pallas runs on cuda or cpu tensors, "
                         f"got {data.device}")
    if data_norms is None:
        data_norms = torch.linalg.vector_norm(data, dim=1,
                                              dtype=torch.float32)
    return _search_on_card(data, n_valid, queries, data_norms, int(k))


cosine_topk_pallas.launches = dict.fromkeys(KERNELS.values(), 0)


class SearchCall(ctypes.Structure):
    """`SearchCall` of csrc/cosine_topk.cu, field for field."""

    _fields_ = ([(name, ctypes.c_int64) for name in (
        "dtype", "D", "n_valid", "B", "qb", "kp", "splits",
        "rows_per_split", "row0", "n_rows")] +
        [(name, ctypes.c_void_p) for name in (
            "stage_rows", "stage_norms", "query", "query_pinned",
            "query_dev", "data", "norms", "qn", "cand_v", "cand_i",
            "tickets", "out_dev", "out_host", "stream")])


class CardSearch:
    """One database's searches of width <= KMAX on the card, each one
    native call on `stream` (a non-blocking stream of the caller's, so
    its synchronize never waits for the legacy default stream).

    The workspaces (kernel scratch, the query's device and pinned host
    copies, the results' device and pinned host copies) belong to this
    object and grow with the batch and the split lists; `bind` points
    the call at the database's buffers and its staging rows after every
    reallocation. Not thread-safe: one thread at a time.

    The call holds the GIL (a `ctypes.PYFUNCTYPE` prototype): a thread
    that gives it up for the ~40 us call waits to take it back behind the
    solve thread's small torch ops (PERF.md §6)."""

    def __init__(self, stream, dtype, dim: int):
        from cslam_tpu_torch import _build

        if dtype not in KERNELS:
            raise TypeError(f"cosine_topk kernel takes float32 or bfloat16 "
                            f"data, got {dtype}")
        self._fn = ctypes.PYFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(
            ("cosine_topk_search_sync", _build.load_library()))
        self.stream = stream
        self.device = stream.device
        self._dtype = dtype
        self._kernel = KERNELS[dtype]
        self._call = SearchCall(dtype=0 if dtype == torch.float32 else 1,
                                D=dim, stream=stream.cuda_stream)
        self._ptr = ctypes.addressof(self._call)
        self._batch = 0      # queries the workspaces hold
        self._n_cand = 0     # split-list entries they hold
        self._keep = ()      # the workspaces' tensors
        self._reserve(1, _TARGET_BLOCKS * KMAX)  # any search at B = 1

    def bind(self, data, norms, stage_rows, stage_norms):
        """The database's (N_cap, D) rows and (N_cap,) norms on the card,
        and its staging rows and norms in pinned host memory."""
        c = self._call
        c.data, c.norms = data.data_ptr(), norms.data_ptr()
        c.stage_rows, c.stage_norms = (stage_rows.data_ptr(),
                                       stage_norms.data_ptr())

    def _reserve(self, B: int, n_cand: int):
        B, n_cand = max(B, self._batch), max(n_cand, self._n_cand)
        D = self._call.D
        kw = dict(device=self.device)
        with torch.cuda.stream(self.stream):
            tickets = torch.zeros(max(3 * B, 64), dtype=torch.int32, **kw)
            cand = torch.empty(2 * n_cand, dtype=torch.int32, **kw)
            qn = torch.empty(B * D, dtype=self._dtype, **kw)
            query_dev = torch.empty(B * D, dtype=torch.float32, **kw)
            out_dev = torch.empty(2 * B * KMAX, dtype=torch.int32, **kw)
        query_pinned = torch.empty(B * D, dtype=torch.float32,
                                   pin_memory=True)
        out_host = torch.empty(2 * B * KMAX, dtype=torch.int32,
                               pin_memory=True)
        self.stream.synchronize()
        c = self._call
        c.tickets, c.qn, c.query_dev = (tickets.data_ptr(), qn.data_ptr(),
                                        query_dev.data_ptr())
        c.cand_i = cand.data_ptr()
        c.cand_v = cand.data_ptr() + 4 * n_cand
        c.out_dev, c.query_pinned, c.out_host = (
            out_dev.data_ptr(), query_pinned.data_ptr(), out_host.data_ptr())
        self._keep = (tickets, cand, qn, query_dev, out_dev, query_pinned,
                      out_host)
        self._out = out_host.numpy()
        self._batch, self._n_cand = B, n_cand

    def search(self, queries: np.ndarray, n_valid: int, kp: int,
               row0: int, n_rows: int):
        """(B, kp) int32 rows and float32 sims of C-contiguous float32
        (B, D) `queries` over the first n_valid rows, after uploading the
        n_rows staged rows to rows row0 onwards. The arrays are views of
        pinned memory that the next search overwrites."""
        if queries.dtype != np.float32 or queries.ndim != 2 or \
                queries.shape[1] != self._call.D or \
                not queries.flags.c_contiguous:
            raise ValueError("queries must be C-contiguous float32 (B, D)")
        B = queries.shape[0]
        qb, rt = block_shape(self._dtype, B)
        splits, rows = split_plan(B, n_valid, qb, rt)
        if B > self._batch or B * splits * kp > self._n_cand:
            self._reserve(B, B * splits * kp)
        c = self._call
        c.n_valid, c.B, c.qb, c.kp = n_valid, B, qb, kp
        c.splits, c.rows_per_split = splits, rows
        c.row0, c.n_rows = row0, n_rows
        c.query = queries.ctypes.data
        rc = self._fn(self._ptr)
        if rc != 0:
            raise RuntimeError(f"cosine_topk single-call search failed: "
                               f"CUDA error {rc}")
        cosine_topk_pallas.launches[self._kernel] += 1
        n = B * kp
        out = self._out
        return (out[:n].reshape(B, kp),
                out[n:2 * n].view(np.float32).reshape(B, kp))
