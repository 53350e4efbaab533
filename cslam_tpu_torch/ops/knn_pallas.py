"""Fused exact cosine top-k: the hand-written CUDA kernel and its plain
PyTorch version.

Port of cslam_tpu/ops/knn_pallas.py. The reference streams database
tiles through a Pallas TPU kernel (`_knn_kernel`) that keeps a running
top-k per query behind a gate; here the kernel is
`csrc/cosine_topk.cu` (design and bound in its header), built by
`_build.py` at first use.

`cosine_topk_pallas` prepares its inputs as the reference's wrapper
does (masked inverse norms, a -3e38 bias row, queries normalized in f32
and then cast to the database dtype). On a CUDA tensor it launches the
kernel, or raises; on a CPU tensor it runs `cosine_topk_plain`, the
plain version of the same function. There is no fall-back between the
two: the device of the data decides.
"""

import ctypes

import torch

from cslam_tpu_torch.ops.knn import topk_desc

NEG_LARGE = -3.0e38  # finite "-inf" of missing slots, as in the reference
KMAX = 64            # largest k the kernel supports
_QB = 32             # queries per block of the kernel (csrc QB)
_RT = 64             # rows per tile of the kernel (csrc RT)
_TARGET_BLOCKS = 2 * 132  # about two blocks per H100 SM
_MAX_SPLITS = 1024


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


def cosine_topk_plain(data, n_valid, queries_n, inv, bias, k: int):
    """The kernel's function in plain PyTorch: sims = (q . row) * inv +
    bias in f32, top-k by value descending with ties to the lower row;
    slots past min(k, n_valid) hold NEG_LARGE with row 0."""
    N = data.shape[0]
    B = queries_n.shape[0]
    sims = (queries_n.float() @ data.float().T) * inv[None, :] + bias[None, :]
    n_eff = min(int(k), int(n_valid), N)
    vals, idx = topk_desc(sims, n_eff)
    out_v = torch.full((B, k), NEG_LARGE, dtype=torch.float32,
                       device=data.device)
    out_i = torch.zeros((B, k), dtype=torch.int32, device=data.device)
    out_v[:, :n_eff] = vals
    out_i[:, :n_eff] = idx.to(torch.int32)
    return out_i, out_v


def split_plan(B: int, n_valid: int):
    """(splits, rows_per_split) for kernel 1: enough row ranges that
    the grid has about _TARGET_BLOCKS blocks, each range a whole number
    of tiles."""
    qblocks = -(-B // _QB)
    tiles = max(-(-n_valid // _RT), 1)
    splits = min(max(-(-_TARGET_BLOCKS // qblocks), 1), tiles, _MAX_SPLITS)
    rows = -(-tiles // splits) * _RT
    splits = max(-(-n_valid // rows), 1)
    return splits, rows


def _launch(data, n_valid, queries_n, inv, bias, k):
    from cslam_tpu_torch import _build

    dev = data.device
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cosine_topk kernel takes float32 or bfloat16 "
                        f"data, got {data.dtype}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"cosine_topk kernel supports 1 <= k <= {KMAX}, "
                         f"got k={k}")
    for name, t in (("data", data), ("queries", queries_n), ("inv", inv),
                    ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries_n.dtype != data.dtype or inv.dtype != torch.float32 or \
            bias.dtype != torch.float32:
        raise TypeError("queries must have the data dtype; inv and bias "
                        "must be float32")
    N, D = data.shape
    B = queries_n.shape[0]
    if queries_n.shape[1] != D or inv.shape != (N,) or bias.shape != (N,):
        raise ValueError("shape mismatch between data, queries, inv, bias")
    lib = _build.load_library()
    splits, rows = split_plan(B, n_valid)
    cand_v = torch.empty((splits, B, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((splits, B, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cosine_topk_launch(
        data.data_ptr(), 0 if data.dtype == torch.float32 else 1,
        inv.data_ptr(), bias.data_ptr(), queries_n.data_ptr(), int(n_valid),
        D, B, int(k), splits, rows, cand_v.data_ptr(), cand_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cosine_topk kernel launch failed: CUDA error "
                           f"{rc}")
    cosine_topk_pallas.launches += 1
    return out_i, out_v


def cosine_topk_pallas(data, n_valid, queries, k: int, tile_rows=None,
                       data_norms=None, query_groups: int = 1):
    """Fused exact top-k cosine search (the reference's signature).

    Args:
      data: (N_cap, D) float32 or bfloat16 database.
      n_valid: number of valid rows.
      queries: (B, D); normalized here.
      k: neighbor count (the kernel supports k <= 64).
      tile_rows, query_groups: the reference kernel's tiling knobs,
        checked as the reference checks them and otherwise unused (the
        CUDA kernel picks its own tiles; results do not depend on them).
      data_norms: optional (N_cap,) cached row norms.

    Returns (indices, sims): (B, k) int32 and (B, k) float32, descending;
    missing slots carry NEG_LARGE with index 0.
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
    inv, bias, queries_n = prepare_inputs(data, n_valid, queries, data_norms)
    if data.device.type == "cpu":
        return cosine_topk_plain(data, n_valid, queries_n, inv, bias, k)
    if data.device.type != "cuda":
        raise ValueError(f"cosine_topk_pallas runs on cuda or cpu tensors, "
                         f"got {data.device}")
    return _launch(data, n_valid, queries_n, inv, bias, int(k))


cosine_topk_pallas.launches = 0
